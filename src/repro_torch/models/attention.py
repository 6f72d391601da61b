"""GQA attention block with RoPE/M-RoPE, QKV bias, sliding window, KV cache.

Three entry points sharing one parameter set (as in the JAX package's
``repro.models.attention``):

* ``attend_train``   — full-sequence causal attention (the flash kernel,
  inside its autograd Function on the card when a gradient is wanted);
* ``attend_prefill`` — the same attention over a prompt, also returning
  the KV cache padded to ``cache_len``;
* ``attend_decode``  — one token against a cache (the decode kernel).

Cache layout (per layer): ``k/v (B, S_max, Hkv, D)``; position ``p`` sits
at slot ``p`` (``p % S_max`` for a sliding-window ring). ``attend_decode``
writes the new token's K/V into the cache in place at its slot; a slot past
``S_max`` (no window, position at or beyond the cache) is dropped, as the
JAX package's one-hot write drops it.

The encoder-decoder models add cross-attention (``init_cross_attention``,
``cross_attend``, ``cross_attend_decode``): decoder queries over the
encoder's output, with no rope and no mask, through the same two kernels
(flash non-causal with ``Sq`` the decoder's length and ``Sk`` the
encoder's; decode with every length the encoder's).

On a mesh whose ``model`` axis has several ranks (``x`` a DTensor, the
parameters placed by ``distributed/sharding.py``), self-attention runs
the kernels on each rank's whole local heads: the projections are laid
out by ``sharding.head_layout`` (q heads ``Shard`` over ``model`` where
the axis divides them, kv heads ``Shard`` where it divides them, else a
replicated K/V of which each rank takes the kv heads its q heads use),
then the kernel is called on the contiguous local tensors
(``to_local``/``from_local``). A replicated K/V that ranks slice gets its
gradient back as a partial sum over ``model``. Cross-attention follows
the same rule, its K/V projected from the encoder's output, which is
batch-sharded as the decoder's stream is.

With ``cfg.act_dp`` set (the JAX package's streaming layout, its dry run's
``--attn-block``), ``attend_train`` and ``attend_prefill`` on a mesh lay
attention out as JAX's ``_pin_dp`` does instead (``_PinnedRows``): q, k
and v batch-sharded over the ``act_dp`` axes with every head on every
rank, and with ``cfg.act_sp`` q's rows sharded over that axis (context
parallelism) against K/V replicated over it; the kernel runs on the
rank's rows at ``q_offset`` = their first global position. Every flash
call passes ``block_k=cfg.attn_block_k``: on CPU tensors a sequence
longer than it takes the streaming plain version, as JAX's op does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_linear, apply_rope, init_linear,
                                       mrope_positions_text)

Params = Dict[str, Dict[str, torch.Tensor]]

__all__ = ["init_attention", "attend_train", "attend_prefill",
           "attend_decode", "ring_len", "init_cross_attention",
           "cross_attend", "cross_attend_decode"]


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, hd = cfg.d_model, cfg.hd
    dtype = cfg.torch_param_dtype
    return {
        "wq": init_linear(gen, d, cfg.n_heads * hd, dtype, cfg.qkv_bias),
        "wk": init_linear(gen, d, cfg.n_kv_heads * hd, dtype, cfg.qkv_bias),
        "wv": init_linear(gen, d, cfg.n_kv_heads * hd, dtype, cfg.qkv_bias),
        "wo": init_linear(gen, cfg.n_heads * hd, d, dtype),
    }


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    hd = cfg.hd
    q = apply_linear(p["wq"], x).view(B, S, cfg.n_heads, hd)
    k = apply_linear(p["wk"], x).view(B, S, cfg.n_kv_heads, hd)
    v = apply_linear(p["wv"], x).view(B, S, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


class _LocalHeads:
    """Attention on this rank's heads, for a DTensor ``x`` (B, S, d)
    batch-sharded over the data axes: ``q`` the local (B_l, S, Hq_l, D)
    queries, ``kv`` the local K and V of the kv heads the rank holds (all,
    or its shard), both roped by ``positions`` (``None``: no rope); ``out``
    wraps a local (B_l, S, Hq_l, D) result back into a DTensor (B, S,
    Hq·D). Decode's (B, d) token gives (B_l, H_l, D) alike. K and V come
    from ``x``, or for cross-attention from ``kv_x`` (B, Se, d), the
    encoder's output batch-sharded as ``x`` is."""

    def __init__(self, p: Params, x: DTensor, cfg: ModelConfig,
                 positions, kv_x: DTensor = None):
        mesh = x.device_mesh
        lay = sharding.head_layout(mesh, cfg.n_heads, cfg.n_kv_heads)
        self.lay = lay
        src = x if kv_x is None else kv_x
        q, k, v = (sharding.pin_heads(apply_linear(p[n], t), sh)
                   for n, t, sh in (("wq", x, lay.q_sharded),
                                    ("wk", src, lay.kv_sharded),
                                    ("wv", src, lay.kv_sharded)))
        self.q_dt = q
        # ranks that slice one replicated K/V hold partial gradients of it
        grad_pl = None
        if lay.q_sharded and not lay.kv_sharded:
            grad_pl = list(k.placements)
            grad_pl[sharding.mesh_dim(mesh, "model")] = Partial()
        ql = q.to_local()
        kl = k.to_local(grad_placements=grad_pl)
        vl = v.to_local(grad_placements=grad_pl)
        hd = cfg.hd
        held = cfg.n_kv_heads // lay.m if lay.kv_sharded else cfg.n_kv_heads
        q = ql.reshape(tuple(ql.shape[:-1]) + (lay.hq_local, hd))
        k = kl.reshape(tuple(kl.shape[:-1]) + (held, hd))
        v = vl.reshape(tuple(vl.shape[:-1]) + (held, hd))
        if positions is not None:
            pos = positions.to_local()
            if cfg.mrope_sections is not None:
                pos = mrope_positions_text(pos)
            q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope_sections)
            k = apply_rope(k, pos, cfg.rope_theta, cfg.mrope_sections)
        self.q, self.kv = q, (k, v)
        self.lo = lay.kv_lo(sharding.model_rank(mesh))
        self.block_k = cfg.attn_block_k

    def kv_used(self, k: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The kv heads (dim 2) this rank's q heads use, contiguous."""
        n = self.lay.kv_local
        if k.shape[2] != n:
            k, v = k[:, :, self.lo:self.lo + n], v[:, :, self.lo:self.lo + n]
        return k.contiguous(), v.contiguous()

    def flash(self, causal: bool, window) -> DTensor:
        """The flash kernel on the local heads, as a DTensor."""
        return self.out(ops.flash_attention(
            self.q.contiguous(), *self.kv_used(*self.kv), causal=causal,
            window=window, block_k=self.block_k))

    def out(self, o: torch.Tensor) -> DTensor:
        o = o.reshape(tuple(o.shape[:-2]) + (-1,))
        return DTensor.from_local(o, self.q_dt.device_mesh,
                                  self.q_dt.placements, run_check=False)

    def kv_placements(self) -> tuple:
        """A K/V cache's (B, S, H, D) placements as the rank holds it
        (``_kv_placements``)."""
        return _kv_placements(self.q_dt, self.lay)

    def cache(self, t: torch.Tensor, cfg: ModelConfig, cache_len: int
              ) -> DTensor:
        """The prompt's local K or V as a cache of ``ring_len`` slots in
        ``kv_placements``."""
        return DTensor.from_local(_ring_cache(t, cfg, cache_len),
                                  self.q_dt.device_mesh,
                                  self.kv_placements(), run_check=False)


def _kv_placements(x: DTensor, lay: sharding.HeadLayout) -> tuple:
    """A K/V cache's (B, S, H, D) placements as the decode step takes
    it: the batch as ``x``'s, the heads ``Shard`` over ``model`` when the
    kv heads are sharded, replicated otherwise."""
    pl = list(x.placements)
    d = sharding.mesh_dim(x.device_mesh, "model")
    if d is not None:
        pl[d] = Shard(2) if lay.kv_sharded else Replicate()
    return tuple(pl)


class _PinnedRows:
    """Attention in the JAX package's pinned layout (``_pin_dp`` under
    ``cfg.act_dp``) for a DTensor ``x`` (B, S, d): q, k and v taken
    through DTensor's redistribution to ``sharding.act_specs`` (the batch
    over ``act_dp``, every head on every rank; q's rows also ``Shard``
    over ``act_sp`` where the sequence allows, K/V replicated over it), so
    the pin overrides ``head_layout``'s heads as JAX's overrides GSPMD's.
    ``q`` holds the local (B_l, c, Hq, D) rows from position ``q_offset``
    (None: the whole sequence), ``kv`` the local (B_l, S, Hkv, D) K and V,
    roped by ``positions``. A rank's K/V gradient is a partial sum over
    ``act_sp`` (each rank attends its own rows to all of K/V)."""

    def __init__(self, p: Params, x: DTensor, cfg: ModelConfig,
                 positions: DTensor):
        mesh = x.device_mesh
        B, S = x.shape[:2]
        q_spec, kv_spec = sharding.act_specs(mesh, cfg.act_dp, cfg.act_sp,
                                             B, S)
        self.q_pl = sharding.placements(mesh, q_spec)
        kv_pl = sharding.placements(mesh, kv_spec)
        sp = q_spec[1]
        grad_pl = None
        if sp is not None:
            grad_pl = list(kv_pl)
            grad_pl[sharding.mesh_dim(mesh, sp)] = Partial()
        q = apply_linear(p["wq"], x).redistribute(mesh, self.q_pl)
        k, v = (apply_linear(p[n], x).redistribute(mesh, kv_pl).to_local(
            grad_placements=grad_pl) for n in ("wk", "wv"))
        ql = q.to_local()
        c, hd = ql.shape[1], cfg.hd
        self.q_offset = mesh.get_local_rank(sp) * c if sp else None
        self.shape = (B, S, cfg.n_heads * hd)
        q = ql.reshape(ql.shape[0], c, cfg.n_heads, hd)
        k = k.reshape(k.shape[0], S, cfg.n_kv_heads, hd)
        v = v.reshape(v.shape[0], S, cfg.n_kv_heads, hd)
        qpos, kpos = (positions.redistribute(mesh, pl).to_local()
                      for pl in (self.q_pl, kv_pl))
        if cfg.mrope_sections is not None:
            qpos, kpos = mrope_positions_text(qpos), mrope_positions_text(kpos)
        self.q = apply_rope(q, qpos, cfg.rope_theta, cfg.mrope_sections)
        self.kv = (apply_rope(k, kpos, cfg.rope_theta, cfg.mrope_sections),
                   v)
        self.mesh, self.kv_pl, self.block_k = mesh, kv_pl, cfg.attn_block_k

    def flash(self, causal: bool, window) -> DTensor:
        """The flash kernel on the rank's rows, as a DTensor in the
        residual stream's layout (``sharding.pin_dp``)."""
        o = ops.flash_attention(
            self.q.contiguous(), self.kv[0].contiguous(),
            self.kv[1].contiguous(), causal=causal, window=window,
            block_k=self.block_k, q_offset=self.q_offset)
        o = sharding.from_local(o.reshape(o.shape[0], o.shape[1], -1),
                                self.mesh, self.q_pl, self.shape)
        return sharding.pin_dp(o)

    def cache(self, t: torch.Tensor, cfg: ModelConfig, cache_len: int
              ) -> DTensor:
        """The prompt's local K or V (B_l, S, Hkv, D) as a cache of
        ``ring_len`` slots in the placements the decode step takes
        (``_kv_placements``), not the pin's replicated heads: where those
        are sharded over ``model`` each rank keeps its slice (no
        communication)."""
        kc = _ring_cache(t, cfg, cache_len)
        shape = (self.shape[0],) + tuple(kc.shape[1:])
        full = sharding.from_local(kc, self.mesh, self.kv_pl, shape)
        lay = sharding.head_layout(self.mesh, cfg.n_heads, cfg.n_kv_heads)
        return full.redistribute(self.mesh, _kv_placements(full, lay))


def _attention_on_mesh(p: Params, x: DTensor, cfg: ModelConfig,
                       positions: DTensor):
    """The DTensor path of ``attend_train`` and ``attend_prefill``: the
    pinned layout where ``cfg.act_dp`` asks for it, local heads
    otherwise."""
    if cfg.act_dp:
        return _PinnedRows(p, x, cfg, positions)
    return _LocalHeads(p, x, cfg, positions)


def attend_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, causal: bool = True
                 ) -> torch.Tensor:
    window = cfg.sliding_window if causal else None
    if isinstance(x, DTensor):
        lh = _attention_on_mesh(p, x, cfg, positions)
        return apply_linear(p["wo"], lh.flash(causal, window))
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = ops.flash_attention(q, k, v, causal=causal, window=window,
                            block_k=cfg.attn_block_k)
    B, S = x.shape[:2]
    return apply_linear(p["wo"], o.reshape(B, S, cfg.n_heads * cfg.hd))


def ring_len(cfg: ModelConfig, cache_len: int) -> int:
    """Slots of an attention layer's cache: ``cache_len``, or with a
    sliding window a rolling ring of ``min(cache_len, window)``."""
    if cfg.sliding_window:
        return min(cache_len, cfg.sliding_window)
    return cache_len


def attend_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, cache_len: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (output, kv-cache of ``ring_len(cfg, cache_len)`` slots).

    Position ``p`` sits at slot ``p`` (``p % ring`` for a sliding-window
    ring, which keeps the prompt's last ``ring`` positions), so the cache
    has the shape ``init_block_cache`` gives a slot's. The JAX package pads
    to ``cache_len`` whatever the window, which its ModelServer then
    cannot copy into a ring shorter than ``cache_len``.
    """
    B, S = x.shape[:2]
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} < prompt length {S}")
    if isinstance(x, DTensor):
        lh = _attention_on_mesh(p, x, cfg, positions)
        o = lh.flash(True, cfg.sliding_window)
        cache = {n: lh.cache(t, cfg, cache_len)
                 for n, t in zip(("k", "v"), lh.kv)}
        return apply_linear(p["wo"], o), cache
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                            block_k=cfg.attn_block_k)
    out = apply_linear(p["wo"], o.reshape(B, S, cfg.n_heads * cfg.hd))
    return out, {"k": _ring_cache(k, cfg, cache_len),
                 "v": _ring_cache(v, cfg, cache_len)}


def _ring_cache(k: torch.Tensor, cfg: ModelConfig, cache_len: int
                ) -> torch.Tensor:
    """A prompt's K or V (B, S, H, D) in a cache of ``ring_len`` slots:
    position p at slot p (p % ring past a sliding window's ring)."""
    B, S = k.shape[:2]
    R = ring_len(cfg, cache_len)
    kc = k.new_zeros((B, R) + tuple(k.shape[2:]))
    if S <= R:
        kc[:, :S] = k
    else:
        slots = torch.arange(S - R, S, device=k.device) % R
        kc[:, slots] = k[:, S - R:]
    return kc


def _write_slot(cache: torch.Tensor, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """``cache[b, slot[b]] = new[b]`` in place, for every ``b`` whose slot
    lies inside the cache; the others are left as they were. No host
    sync: an out-of-range slot rewrites its row's last entry with itself."""
    B, S = cache.shape[:2]
    inside = (slot < S)[:, None, None]
    s = slot.clamp(max=S - 1).long()
    b = torch.arange(B, device=cache.device)
    cache[b, s] = torch.where(inside, new.to(cache.dtype), cache[b, s])


def attend_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  cache: Dict[str, torch.Tensor], position: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, d) one token; cache k/v (B, S_max, Hkv, D); position (B,)
    int32. Writes the token's K/V into ``cache`` in place and returns
    (output, cache).

    With a sliding window the cache is a rolling ring of size >= window:
    writes land at ``position % S_max`` and the kernel masks by absolute
    position.
    """
    if isinstance(x, DTensor):
        return _attend_decode_sharded(p, x, cfg, cache, position)
    B, _ = x.shape
    hd = cfg.hd
    q = apply_linear(p["wq"], x).view(B, 1, cfg.n_heads, hd)
    k = apply_linear(p["wk"], x).view(B, 1, cfg.n_kv_heads, hd)
    v = apply_linear(p["wv"], x).view(B, 1, cfg.n_kv_heads, hd)
    pos = position[:, None]
    if cfg.mrope_sections is not None:
        pos = mrope_positions_text(pos)   # text decode: t=h=w=position
    q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.mrope_sections)

    o = _decode_local(q[:, 0], k[:, 0], v[:, 0], cache["k"], cache["v"],
                      position, cfg, lambda kc, vc: (kc, vc))
    out = apply_linear(p["wo"], o.reshape(B, cfg.n_heads * hd))
    return out, cache


def _decode_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kc: torch.Tensor, vc: torch.Tensor, position: torch.Tensor,
                  cfg: ModelConfig, used) -> torch.Tensor:
    """Write the token's k/v (B, H, D) into the caches in place, then the
    decode kernel for q (B, Hq, D) over ``used(kc, vc)``'s kv heads."""
    S_max = kc.shape[1]
    slot = position % S_max if cfg.sliding_window else position
    _write_slot(kc, slot, k)
    _write_slot(vc, slot, v)
    kc, vc = used(kc, vc)
    if cfg.sliding_window:
        # ring order, masked by each slot's absolute position
        return ops.decode_attention(q, kc, vc, position,
                                    window=cfg.sliding_window, ring=True)
    return ops.decode_attention(q, kc, vc, position + 1, window=None)


def _attend_decode_sharded(p: Params, x: DTensor, cfg: ModelConfig,
                           cache: Dict[str, DTensor], position: DTensor
                           ) -> Tuple[DTensor, Dict[str, DTensor]]:
    """``attend_decode`` on local heads. The cache (placed by
    ``sharding.cache_specs_tree``: kv heads over ``model`` where they
    divide it, else its sequence) is taken in the layout the kernel
    needs (``_LocalHeads.kv_placements``); where that differs from its own, the
    written cache goes back into its placement in place."""
    lh = _LocalHeads(p, x, cfg, position)
    mesh, pl = lh.q_dt.device_mesh, lh.kv_placements()
    held = {n: cache[n].redistribute(mesh, pl) for n in ("k", "v")}
    o = _decode_local(lh.q.contiguous(), lh.kv[0], lh.kv[1],
                      held["k"].to_local(), held["v"].to_local(),
                      position.to_local(), cfg, lh.kv_used)
    for n in ("k", "v"):
        if tuple(held[n].placements) != tuple(cache[n].placements):
            cache[n].copy_(held[n].redistribute(mesh, cache[n].placements))
    return apply_linear(p["wo"], lh.out(o)), cache


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# ---------------------------------------------------------------------------

def init_cross_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return init_attention(gen, cfg)


def _project_kv(p: Params, enc_out: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K and V of the encoder's output (B, Se, Hkv, D): views of fresh
    linear outputs, so contiguous with 16-byte aligned bases, as the
    kernels take them."""
    B, Se, _ = enc_out.shape
    k = apply_linear(p["wk"], enc_out).view(B, Se, cfg.n_kv_heads, cfg.hd)
    v = apply_linear(p["wv"], enc_out).view(B, Se, cfg.n_kv_heads, cfg.hd)
    return k, v


def cross_attend(p: Params, x: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Decoder queries x (B, S, d) over the encoder's output (B, Se, d):
    no causal mask, no rope; S may be shorter or longer than Se. On
    DTensors the flash kernel runs on the rank's local heads (no pin, as
    JAX's ``cross_attend`` has none)."""
    if isinstance(x, DTensor):
        lh = _LocalHeads(p, x, cfg, None, kv_x=enc_out)
        return apply_linear(p["wo"], lh.flash(False, None))
    B, S, _ = x.shape
    q = apply_linear(p["wq"], x).view(B, S, cfg.n_heads, cfg.hd)
    k, v = _project_kv(p, enc_out, cfg)
    o = ops.flash_attention(q, k, v, causal=False, window=None,
                            block_k=cfg.attn_block_k)
    return apply_linear(p["wo"], o.reshape(B, S, cfg.n_heads * cfg.hd))


def cross_attend_decode(p: Params, x: torch.Tensor, enc_out: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """One decoder token x (B, d) against the encoder's output (B, Se, d),
    its K/V projected anew on every call, as in the JAX package: decode
    attention with every length ``Se``. On DTensors the decode kernel runs
    on the rank's local heads and rows."""
    if isinstance(x, DTensor):
        lh = _LocalHeads(p, x, cfg, None, kv_x=enc_out)
        k, v = lh.kv_used(*lh.kv)
        lengths = torch.full((k.shape[0],), k.shape[1], dtype=torch.int32,
                             device=k.device)
        o = ops.decode_attention(lh.q.contiguous(), k, v, lengths,
                                 window=None)
        return apply_linear(p["wo"], lh.out(o))
    B, _ = x.shape
    Se = enc_out.shape[1]
    q = apply_linear(p["wq"], x).view(B, cfg.n_heads, cfg.hd)
    k, v = _project_kv(p, enc_out, cfg)
    lengths = torch.full((B,), Se, dtype=torch.int32, device=x.device)
    o = ops.decode_attention(q, k, v, lengths, window=None)
    return apply_linear(p["wo"], o.reshape(B, cfg.n_heads * cfg.hd))
