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
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (_normal, apply_norm, init_linear,
                                       init_norm)

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


def _ssd_block(p: Params, h: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The block over a sequence: (output (B, L, d), the conv input's
    last K-1 rows, the final SSD state (B, nh, N, P) f32)."""
    s, d_in, nh, _ = _dims(cfg)
    B_, L, _ = h.shape
    zxbcdt = h @ p["in_proj"].to(h.dtype)
    z, xc, Bc, Cc, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xc, Bc, Cc], dim=-1)               # (B, L, conv_ch)
    conv_tail = xbc[:, -(s.conv_kernel - 1):, :]
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xc, Bc, Cc = torch.split(
        xbc, [d_in, s.ngroups * s.d_state, s.ngroups * s.d_state], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"])          # (B, L, nh)
    A = -torch.exp(p["A_log"])                          # (nh,) negative
    xh = xc.reshape(B_, L, nh, s.headdim)
    Bm = Bc.reshape(B_, L, s.ngroups, s.d_state)
    Cm = Cc.reshape(B_, L, s.ngroups, s.d_state)
    # the casts sit where the JAX package has them: x·Δt rounded to the
    # activations' dtype before the scan, f32 inside, y rounded after
    y, final = ssd_chunked((xh.float() * dt[..., None]).to(h.dtype),
                           dt * A, Bm, Cm, s.chunk)
    y = y + xh * p["D"][:, None].to(h.dtype)
    y = y.reshape(B_, L, d_in)
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


def mamba_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token: x (B, d) -> (y (B, d), cache). O(1) in context length;
    the cache's ``conv`` and ``ssm`` are written in place."""
    s, d_in, nh, conv_ch = _dims(cfg)
    B_, _ = x.shape
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xc, Bc, Cc, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xc, Bc, Cc], dim=-1)               # (B, conv_ch)
    window = torch.cat([cache["conv"], xbc[:, None, :].to(
        cache["conv"].dtype)], dim=1)
    # window is oldest->newest; _causal_conv applies w[m] to the input m
    # steps back, so the taps are reversed here
    conv_out = torch.sum(window.float()
                         * torch.flip(p["conv_w"], [0]).float(), dim=1)
    xbc = F.silu(conv_out + p["conv_b"].float()).to(x.dtype)
    xc, Bc, Cc = torch.split(
        xbc, [d_in, s.ngroups * s.d_state, s.ngroups * s.d_state], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"])          # (B, nh)
    A = -torch.exp(p["A_log"])
    da = torch.exp(dt * A)                              # (B, nh)
    xh = xc.reshape(B_, nh, s.headdim).float()
    rep = nh // s.ngroups
    Bm = Bc.reshape(B_, s.ngroups, s.d_state).repeat_interleave(rep, 1)
    Cm = Cc.reshape(B_, s.ngroups, s.d_state).repeat_interleave(rep, 1)
    h = (cache["ssm"] * da[:, :, None, None]
         + (dt[:, :, None] * Bm)[..., None] * xh[:, :, None, :])
    y = torch.einsum("bhn,bhnp->bhp", Cm.float(), h)
    y = y + xh * p["D"][:, None]
    y = y.reshape(B_, d_in).to(x.dtype)
    y = apply_norm(p["norm"], y * F.silu(z), "rmsnorm")
    cache["conv"].copy_(window[:, 1:, :])
    cache["ssm"].copy_(h)
    return y @ p["out_proj"].to(x.dtype), cache
