"""Mamba-2 (SSD — state-space duality) mixer block.

The port of the JAX package's ``repro.models.ssm``, same parameter and
cache layouts. The chunked "matrix transformer" form of the SSD recurrence
(arXiv:2405.21060 §6): within chunks of length Q the output is a masked
(C·Bᵀ ⊙ decay) attention-like product; across chunks a short sequential
loop carries the (H, N, P) states. Decode is an O(1) recurrent state
update, written into the cache in place like the KV cache.

Layout: x (B, L, H, P) heads×headdim; B/C (B, L, G, N) groups broadcast to
heads; a = Δt·A (B, L, H) log-decays (A < 0). The scan and the block run
in plain PyTorch (the JAX package computes them in jnp, outside any Pallas
kernel), so autograd covers training.

On a mesh whose ``data`` or ``model`` axis has several ranks (``x`` a
DTensor, the parameters placed by ``distributed/sharding.py`` and their
``data`` shards gathered by ``blocks._layer``) the block runs on local
tensors laid out by its parameters' placements (``_Layout``): the
projection and the conv's channel chunks all-gathered over ``model``,
the scan on the rank's heads, the gated norm's sums of squares
all-reduced, ``out_proj``'s rows a partial sum reduced in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models.layers import (NORM_EPS, _normal, apply_norm,
                                       init_linear, init_norm)

Params = Dict[str, torch.Tensor]

__all__ = ["init_mamba", "mamba_train", "mamba_decode", "init_mamba_cache",
           "mamba_prefill", "ssd_chunked"]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) -> (..., Q, Q) with S[q, k] = sum_{j=k+1..q} a_j for
    q >= k, -inf elsewhere (decay exponents within a chunk).

    Each entry sums its own segment (a cumulative sum down the masked
    columns), where the JAX package subtracts two prefix sums: those
    reach |Σa| ~ 10^2–10^3 over a chunk of 256, so their difference
    carries an absolute error of |Σa|·2^-24, a relative error of ~1e-5 in
    every decay factor, which differs between two summation orders (the
    card's and the CPU's). The mask comes before the caller's ``exp``, so
    the masked entries' gradient is 0, never NaN."""
    Q = a.shape[-1]
    qi = torch.arange(Q, device=a.device)
    below = qi[:, None] > qi[None, :]                 # j > k: a_j counts
    seg = torch.cumsum(torch.where(
        below, a[..., :, None], torch.zeros((), dtype=a.dtype,
                                            device=a.device)), dim=-2)
    return torch.where(qi[:, None] >= qi[None, :], seg,
                       torch.full((), -math.inf, dtype=a.dtype,
                                  device=a.device))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int, h0: torch.Tensor = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the SSD recurrence h_t = e^{a_t} h_{t-1} + B_t x_tᵀ,
    y_t = C_t·h_t over a full sequence.

    x (B, L, H, P); a (B, L, H); Bm/Cm (B, L, G, N). Returns
    (y (B, L, H, P) in x's dtype, final_state (B, H, N, P) f32).
    """
    B_, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, L)
    L_orig = L
    if L % Q:
        # pad tail: x/B zeros and a=0 (decay 1) leave the state untouched
        pad = Q - L % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        L = L + pad
    nc = L // Q
    Bh = Bm.repeat_interleave(rep, dim=2)            # (B, L, H, N)
    Ch = Cm.repeat_interleave(rep, dim=2)

    xr = x.reshape(B_, nc, Q, H, P).float()
    ar = a.reshape(B_, nc, Q, H).float()
    Br = Bh.reshape(B_, nc, Q, H, N).float()
    Cr = Ch.reshape(B_, nc, Q, H, N).float()

    a_cum = torch.cumsum(ar, dim=2)                   # (B, nc, Q, H)
    # ---- intra-chunk (dual / attention-like form) -----------------------
    seg = _segsum(ar.permute(0, 1, 3, 2))             # (B, nc, H, Q, Q)
    Lmat = torch.exp(seg)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cr, Br) * Lmat
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xr)

    # ---- chunk boundary states -----------------------------------------
    # decay from each position to the chunk's end: the segsum's last row
    decay_states = torch.exp(seg[..., -1, :]).permute(0, 1, 3, 2)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchnp", Br, decay_states,
                          xr)                         # (B, nc, H, N, P)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])       # (B, nc, H)

    # the state BEFORE each chunk, carried in f32
    carry = (x.new_zeros((B_, H, N, P), dtype=torch.float32) if h0 is None
             else h0.float())
    before = []
    for c in range(nc):
        before.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    carried = torch.stack(before, dim=1)              # (B, nc, H, N, P)

    # ---- inter-chunk contribution ---------------------------------------
    y_off = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", Cr, carried,
                         torch.exp(a_cum))
    y = (y_diag + y_off).reshape(B_, L, H, P).to(x.dtype)
    return y[:, :L_orig], carry


# ---------------------------------------------------------------------------
# Full Mamba-2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nh = s.nheads(cfg.d_model)
    conv_ch = d_in + 2 * s.ngroups * s.d_state
    return s, d_in, nh, conv_ch


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> Params:
    s, d_in, nh, conv_ch = _dims(cfg)
    d = cfg.d_model
    dtype = cfg.torch_param_dtype
    dev = gen.device
    d_proj = 2 * d_in + 2 * s.ngroups * s.d_state + nh
    return {
        "in_proj": init_linear(gen, d, d_proj, dtype)["w"],
        "conv_w": _normal(gen, (s.conv_kernel, conv_ch),
                          1.0 / math.sqrt(s.conv_kernel), dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "norm": init_norm(d_in, "rmsnorm", dtype, dev),
        "out_proj": init_linear(gen, d_in, d, dtype)["w"],
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s, d_in, nh, _ = _dims(cfg)
    gn = s.ngroups * s.d_state
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, nh], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. xbc (B, L, C); w (K, C)."""
    K, L = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for k in range(K):     # K is 4: unrolled taps, as in the JAX package
        out = out + pad[:, k:k + L, :].float() * w[K - 1 - k].float()
    return F.silu(out + b.float()).to(xbc.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # F.softplus is the identity above 20 where jax.nn.softplus is not:
    # they differ there by log1p(e^-x) < 2.1e-9
    return F.softplus(x)


def _scan(xc: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
          dt: torch.Tensor, A_log: torch.Tensor, dt_bias: torch.Tensor,
          D: torch.Tensor, s, dtype: torch.dtype
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD over a sequence for ``H`` heads: xc (B, L, H·P) the
    convolved x, Bc/Cc (B, L, G·N), dt (B, L, H) the raw Δt, and the
    heads' ``A_log``, ``dt_bias`` and ``D``. Returns (y (B, L, H·P) before
    the gate, the final state (B, H, N, P) f32)."""
    B_, L = xc.shape[:2]
    H, N = dt.shape[-1], s.d_state
    dt = _softplus(dt.float() + dt_bias)                # (B, L, H)
    A = -torch.exp(A_log)                               # (H,) negative
    xh = xc.reshape(B_, L, H, s.headdim)
    Bm = Bc.reshape(B_, L, -1, N)
    Cm = Cc.reshape(B_, L, -1, N)
    # the casts sit where the JAX package has them: x·Δt rounded to the
    # activations' dtype before the scan, f32 inside, y rounded after
    y, final = ssd_chunked((xh.float() * dt[..., None]).to(dtype),
                           dt * A, Bm, Cm, s.chunk)
    y = y + xh * D[:, None].to(dtype)
    return y.reshape(B_, L, H * s.headdim), final


def _ssd_block(p: Params, h: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The block over a sequence: (output (B, L, d), the conv input's
    last K-1 rows, the final SSD state (B, nh, N, P) f32)."""
    if isinstance(h, DTensor):
        return _ssd_block_mesh(p, h, cfg)
    s, d_in, _, _ = _dims(cfg)
    zxbcdt = h @ p["in_proj"].to(h.dtype)
    z, xc, Bc, Cc, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xc, Bc, Cc], dim=-1)               # (B, L, conv_ch)
    conv_tail = xbc[:, -(s.conv_kernel - 1):, :]
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xc, Bc, Cc = torch.split(
        xbc, [d_in, s.ngroups * s.d_state, s.ngroups * s.d_state], dim=-1)
    y, final = _scan(xc, Bc, Cc, dt, p["A_log"], p["dt_bias"], p["D"], s,
                     h.dtype)
    y = apply_norm(p["norm"], y * F.silu(z), "rmsnorm")
    return y @ p["out_proj"].to(h.dtype), conv_tail, final


def mamba_train(p: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """x (B, L, d) -> (B, L, d)."""
    return _ssd_block(p, x, cfg)[0]


def mamba_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training pass that also keeps the decode cache: the conv
    input's last K-1 rows and the final SSD state."""
    y, conv_tail, final = _ssd_block(p, x, cfg)
    return y, {"conv": conv_tail, "ssm": final}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    s, d_in, nh, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.conv_kernel - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, s.d_state, s.headdim),
                           dtype=torch.float32, device=device),
    }


def _conv_step(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The conv's output for the newest row of ``window`` (B, K, C),
    oldest->newest: ``_causal_conv`` applies w[m] to the input m steps
    back, so the taps are reversed here."""
    out = torch.sum(window.float() * torch.flip(w, [0]).float(), dim=1)
    return F.silu(out + b.float()).to(dtype)


def _recur(xc: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
           dt: torch.Tensor, A_log: torch.Tensor, dt_bias: torch.Tensor,
           D: torch.Tensor, state: torch.Tensor, s, dtype: torch.dtype
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence for ``H`` heads: xc (B, H·P), Bc/Cc
    (B, G·N), dt (B, H) raw, state (B, H, N, P) f32. Returns (y (B, H·P)
    before the gate, the new state)."""
    B_, H = dt.shape
    dt = _softplus(dt.float() + dt_bias)               # (B, H)
    A = -torch.exp(A_log)
    da = torch.exp(dt * A)                              # (B, H)
    xh = xc.reshape(B_, H, s.headdim).float()
    G = Bc.shape[-1] // s.d_state
    Bm = Bc.reshape(B_, G, s.d_state).repeat_interleave(H // G, 1)
    Cm = Cc.reshape(B_, G, s.d_state).repeat_interleave(H // G, 1)
    h = (state * da[:, :, None, None]
         + (dt[:, :, None] * Bm)[..., None] * xh[:, :, None, :])
    y = torch.einsum("bhn,bhnp->bhp", Cm.float(), h)
    y = y + xh * D[:, None]
    return y.reshape(B_, H * s.headdim).to(dtype), h


def mamba_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token: x (B, d) -> (y (B, d), cache). O(1) in context length;
    the cache's ``conv`` and ``ssm`` are written in place."""
    if isinstance(x, DTensor):
        return _mamba_decode_mesh(p, x, cfg, cache)
    s, d_in, _, _ = _dims(cfg)
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xc, Bc, Cc, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xc, Bc, Cc], dim=-1)               # (B, conv_ch)
    window = torch.cat([cache["conv"], xbc[:, None, :].to(
        cache["conv"].dtype)], dim=1)
    xbc = _conv_step(window, p["conv_w"], p["conv_b"], x.dtype)
    xc, Bc, Cc = torch.split(
        xbc, [d_in, s.ngroups * s.d_state, s.ngroups * s.d_state], dim=-1)
    y, h = _recur(xc, Bc, Cc, dt, p["A_log"], p["dt_bias"], p["D"],
                  cache["ssm"], s, x.dtype)
    y = apply_norm(p["norm"], y * F.silu(z), "rmsnorm")
    cache["conv"].copy_(window[:, 1:, :])
    cache["ssm"].copy_(h)
    return y @ p["out_proj"].to(x.dtype), cache


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Layout:
    """What this rank computes of a Mamba-2 block on a wide mesh, for a
    DTensor ``x`` (batch first) batch-sharded over the data axes or
    replicated there, replicated over ``model`` (``m`` ranks):

    * ``in_proj`` (d, d_proj), ``(fsdp, model)``: its columns are
      contiguous pieces of ``[z | x | B | C | dt]``, not heads. The local
      product is all-gathered over ``model``: ``B·L·d_proj`` values a
      layer (gathering the weight instead would move ``d·d_proj``).
    * ``conv_w`` (K, conv_ch), ``(None, model)``, and the ``conv`` cache:
      contiguous channel chunks ``[c_lo, c_lo + c_n)`` where ``conv``.
      The conv is depthwise, so each rank convolves its chunk with its
      piece (its cache piece in decode); the output is all-gathered over
      ``model``.
    * the heads ``[h_lo, h_lo + h_n)``: the rank's where ``heads`` (``m``
      divides them; the ``ssm`` cache's heads ``Shard`` over ``model``),
      all of them on every rank otherwise. The scan runs on those heads.
    * the gated RMSNorm normalises over the whole ``d_inner``: with local
      heads the sums of squares are all-reduced over ``model`` in f32.
    * ``out_proj`` (d_in, d), ``(model, fsdp)`` where ``out_split``: the
      rank takes its rows ``[r_lo, r_hi)`` of the gated output (its
      heads' rows, or where the rows are split mid-head or not sharded
      at all, its even share of every head's rows) and the output is a
      partial sum over ``model``, reduced in f32 and rounded once.

    So every rank's part of the output is its share of a sum: the
    replicated leaves a rank uses (``norm``, ``A_log``, ``dt_bias``,
    ``D``, ``conv_b``, and ``conv_w``/``out_proj`` where they are not
    sharded) get their gradient as a partial sum over ``model``, and over
    the data axes where the batch is split. ``md`` is the ``model`` mesh
    dim where it has several ranks, else None."""
    mesh: object
    md: Optional[int]
    base: tuple                 # x's placements
    bdims: tuple                # the mesh dims that split the batch
    heads: bool
    h_lo: int
    h_n: int
    conv: bool
    c_lo: int
    c_n: int
    out_split: bool
    r_lo: int
    r_hi: int


def _layout(p: Params, x: DTensor, cfg: ModelConfig) -> _Layout:
    """The block's layout on ``x``'s mesh, read off the parameters'
    placements (never assuming that ``model`` divides a dim)."""
    s, d_in, nh, conv_ch = _dims(cfg)
    mesh = x.device_mesh
    md = sharding.mesh_dim(mesh, "model")
    m = mesh.shape[md] if md is not None else 1
    md = md if m > 1 else None
    r = sharding.model_rank(mesh) if md is not None else 0
    heads = md is not None and nh % m == 0
    conv = md is not None and p["conv_w"].placements[md] == Shard(1)
    out_split = md is not None and p["out_proj"].placements[md] == Shard(0)
    h_lo, h_n = (r * nh // m, nh // m) if heads else (0, nh)
    c_lo, c_n = (r * conv_ch // m, conv_ch // m) if conv else (0, conv_ch)
    r_lo, r_hi = ((r * d_in // m, (r + 1) * d_in // m) if md is not None
                  else (0, d_in))
    if heads and (r_lo, r_hi) != (h_lo * s.headdim,
                                  (h_lo + h_n) * s.headdim):
        raise ValueError("the heads and out_proj's rows disagree")
    return _Layout(mesh, md, tuple(x.placements),
                   tuple(sharding.batch_dims(x)), heads, h_lo, h_n, conv,
                   c_lo, c_n, out_split, r_lo, r_hi)


def _pl(lay: _Layout, model=None) -> list:
    """``x``'s placements with ``model`` (a placement) on its dim."""
    pl = list(lay.base)
    if lay.md is not None and model is not None:
        pl[lay.md] = model
    return pl


def _local(lay: _Layout, t: DTensor, share: bool) -> torch.Tensor:
    """A parameter's local piece: its gradient partial over the split
    batch dims, and over ``model`` where ``share`` (the rank uses it for
    its share of the output, not as its own shard)."""
    part = list(lay.bdims)
    if share and lay.md is not None:
        part.append(lay.md)
    return sharding.local(t, part)


def _gathered(lay: _Layout, zx: DTensor) -> torch.Tensor:
    """The projection ``zx`` (B, ..., d_proj), column-sharded over
    ``model`` or not, as every model rank's full local rows; the rank's
    gradient of it a partial sum (reduce-scattered back)."""
    if lay.md is None:
        return zx.to_local()
    full = _pl(lay, Replicate())
    if tuple(zx.placements) != tuple(full):
        zx = zx.redistribute(lay.mesh, full)
    return zx.to_local(grad_placements=_pl(lay, Partial()))


def _conv_gathered(lay: _Layout, t: torch.Tensor, shape) -> torch.Tensor:
    """The conv's output ``t`` on the rank's channels (last dim) as every
    channel: all-gathered over ``model`` where the channels are split,
    its gradient reduce-scattered back."""
    if not lay.conv:
        return t
    dt_ = sharding.from_local(t, lay.mesh, _pl(lay, Shard(t.dim() - 1)),
                              shape)
    return dt_.redistribute(lay.mesh, _pl(lay, Replicate())).to_local(
        grad_placements=_pl(lay, Partial()))


def _model_sum(lay: _Layout, t: torch.Tensor) -> torch.Tensor:
    """Every model rank's ``t`` summed (an f32 all-reduce); the backward
    sums the ranks' gradients, each rank using the sum for its own
    heads."""
    full = DTensor.from_local(t, lay.mesh, _pl(lay, Partial()),
                              run_check=False).redistribute(
        lay.mesh, _pl(lay, Replicate())).to_local()
    return sharding.grad_summed_over(lay.mesh, lay.md)(full)


def _heads_of(lay: _Layout, p: Params, zx: torch.Tensor,
              xbc: torch.Tensor, cfg: ModelConfig):
    """(z, x, B, C, Δt, A_log, dt_bias, D) of the rank's heads: z and Δt
    from the projection, x, B and C from the conv's output, the head
    parameters sliced from the replicated leaves."""
    s, d_in, nh, _ = _dims(cfg)
    gn = s.ngroups * s.d_state
    h_lo, h_hi = lay.h_lo, lay.h_lo + lay.h_n
    z = zx[..., h_lo * s.headdim:h_hi * s.headdim]
    dt = zx[..., 2 * d_in + 2 * gn:][..., h_lo:h_hi]
    xc = xbc[..., h_lo * s.headdim:h_hi * s.headdim]
    Bc, Cc = xbc[..., d_in:d_in + gn], xbc[..., d_in + gn:]
    if lay.heads and s.ngroups > 1:
        # each local head's group, as ``H // G`` groups of one head
        def per_head(t):
            t = t.unflatten(-1, (s.ngroups, s.d_state))
            t = t.repeat_interleave(nh // s.ngroups, -2)
            return t[..., h_lo:h_hi, :].flatten(-2)
        Bc, Cc = per_head(Bc), per_head(Cc)
    head_params = tuple(_local(lay, p[n], True)[h_lo:h_hi]
                        for n in ("A_log", "dt_bias", "D"))
    return (z, xc, Bc, Cc, dt) + head_params


def _gate_norm_out(lay: _Layout, p: Params, y: torch.Tensor,
                   z: torch.Tensor, shape, d_in: int) -> DTensor:
    """The gated RMSNorm over the whole ``d_inner`` and ``out_proj`` on
    the rank's rows: the output DTensor of ``shape``."""
    g = y * F.silu(z)
    lo, hi = lay.r_lo, lay.r_hi
    if lay.heads:
        gf = g.float()
        ss = _model_sum(lay, torch.sum(gf * gf, dim=-1, keepdim=True))
        scale = _local(lay, p["norm"]["scale"], True)[lo:hi]
        g = (gf * torch.rsqrt(ss / d_in + NORM_EPS)
             * scale.float()).to(g.dtype)
    else:
        g = apply_norm({"scale": _local(lay, p["norm"]["scale"], True)},
                       g, "rmsnorm")[..., lo:hi]
    w = _local(lay, p["out_proj"], not lay.out_split)
    if not lay.out_split:
        w = w[lo:hi]
    w = w.to(g.dtype)
    if lay.md is None:
        return sharding.from_local(g @ w, lay.mesh, _pl(lay), shape)
    o = sharding.mm_f32(g.reshape(-1, g.shape[-1]), w)
    o = sharding.from_local(o.view(tuple(g.shape[:-1]) + (w.shape[1],)),
                            lay.mesh, _pl(lay, Partial()), shape)
    return o.redistribute(lay.mesh, _pl(lay, Replicate())).to(g.dtype)


def _cache_pl(lay: _Layout, dim: int, split: bool) -> list:
    return _pl(lay, Shard(dim) if split else Replicate())


def _ssd_block_mesh(p: Params, h: DTensor, cfg: ModelConfig
                    ) -> Tuple[DTensor, DTensor, DTensor]:
    """``_ssd_block`` on a wide mesh (see ``_Layout``): the output, the
    ``conv`` cache's rows (B, K-1, conv_ch) and the final state (B, nh,
    N, P), each a DTensor in its spec's placements."""
    h = sharding.pin_dp(h)
    lay = _layout(p, h, cfg)
    s, d_in, nh, conv_ch = _dims(cfg)
    B_, L, d = h.shape
    zx = _gathered(lay, sharding.matmul(h, p["in_proj"].to(h.dtype)))
    xbc = zx[..., d_in + lay.c_lo:d_in + lay.c_lo + lay.c_n]
    conv_tail = xbc[:, -(s.conv_kernel - 1):, :].contiguous()
    xbc = _causal_conv(xbc, _local(lay, p["conv_w"], not lay.conv),
                       _local(lay, p["conv_b"], True)[
                           lay.c_lo:lay.c_lo + lay.c_n])
    xbc = _conv_gathered(lay, xbc, (B_, L, conv_ch))
    z, *scan_in = _heads_of(lay, p, zx, xbc, cfg)
    y, final = _scan(*scan_in, s, h.dtype)
    out = _gate_norm_out(lay, p, y, z, (B_, L, d), d_in)
    tail = sharding.from_local(conv_tail, lay.mesh,
                               _cache_pl(lay, 2, lay.conv),
                               (B_, s.conv_kernel - 1, conv_ch))
    state = sharding.from_local(final, lay.mesh,
                                _cache_pl(lay, 1, lay.heads),
                                (B_, nh, s.d_state, s.headdim))
    return out, tail, state


def _held(cache: DTensor, want: list, name: str) -> torch.Tensor:
    """The local piece of a cache leaf, which must be in the placements
    the block computes with (its spec's: the same divisibility rules)."""
    if tuple(cache.placements) != tuple(want):
        raise ValueError(f"the {name} cache is placed {cache.placements}, "
                         f"the block computes with {tuple(want)}")
    return cache.to_local()


def _mamba_decode_mesh(p: Params, x: DTensor, cfg: ModelConfig,
                       cache: Dict[str, DTensor]
                       ) -> Tuple[DTensor, Dict[str, DTensor]]:
    """``mamba_decode`` on a wide mesh: each rank writes its pieces of
    the caches in place (its conv channels' window, its heads' state)."""
    x = sharding.pin_dp(x)
    lay = _layout(p, x, cfg)
    s, d_in, _, conv_ch = _dims(cfg)
    B_, d = x.shape
    conv = _held(cache["conv"], _cache_pl(lay, 2, lay.conv), "conv")
    state = _held(cache["ssm"], _cache_pl(lay, 1, lay.heads), "ssm")
    zx = _gathered(lay, sharding.matmul(x, p["in_proj"].to(x.dtype)))
    chunk = zx[..., d_in + lay.c_lo:d_in + lay.c_lo + lay.c_n]
    window = torch.cat([conv, chunk[:, None, :].to(conv.dtype)], dim=1)
    xbc = _conv_step(window, _local(lay, p["conv_w"], not lay.conv),
                     _local(lay, p["conv_b"], True)[
                         lay.c_lo:lay.c_lo + lay.c_n], x.dtype)
    xbc = _conv_gathered(lay, xbc, (B_, conv_ch))
    z, *rec_in = _heads_of(lay, p, zx, xbc, cfg)
    y, h = _recur(*rec_in, state, s, x.dtype)
    out = _gate_norm_out(lay, p, y, z, (B_, d), d_in)
    conv.copy_(window[:, 1:, :])
    state.copy_(h)
    return out, cache
