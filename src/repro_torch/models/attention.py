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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
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


def attend_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, causal: bool = True
                 ) -> torch.Tensor:
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = ops.flash_attention(q, k, v, causal=causal,
                            window=cfg.sliding_window if causal else None)
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
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    B, S = x.shape[:2]
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} < prompt length {S}")
    R = ring_len(cfg, cache_len)
    kc = k.new_zeros((B, R) + tuple(k.shape[2:]))
    vc = v.new_zeros((B, R) + tuple(v.shape[2:]))
    if S <= R:
        kc[:, :S] = k
        vc[:, :S] = v
    else:
        slots = torch.arange(S - R, S, device=k.device) % R
        kc[:, slots] = k[:, S - R:]
        vc[:, slots] = v[:, S - R:]
    out = apply_linear(p["wo"], o.reshape(B, S, cfg.n_heads * cfg.hd))
    return out, {"k": kc, "v": vc}


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

    kc, vc = cache["k"], cache["v"]
    S_max = kc.shape[1]
    slot = position % S_max if cfg.sliding_window else position
    _write_slot(kc, slot, k[:, 0])
    _write_slot(vc, slot, v[:, 0])

    if cfg.sliding_window:
        # ring order, masked by each slot's absolute position
        o = ops.decode_attention(q[:, 0], kc, vc, position,
                                 window=cfg.sliding_window, ring=True)
    else:
        o = ops.decode_attention(q[:, 0], kc, vc, position + 1, window=None)
    out = apply_linear(p["wo"], o.reshape(B, cfg.n_heads * hd))
    return out, cache


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
    no causal mask, no rope; S may be shorter or longer than Se."""
    B, S, _ = x.shape
    q = apply_linear(p["wq"], x).view(B, S, cfg.n_heads, cfg.hd)
    k, v = _project_kv(p, enc_out, cfg)
    o = ops.flash_attention(q, k, v, causal=False, window=None)
    return apply_linear(p["wo"], o.reshape(B, S, cfg.n_heads * cfg.hd))


def cross_attend_decode(p: Params, x: torch.Tensor, enc_out: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """One decoder token x (B, d) against the encoder's output (B, Se, d),
    its K/V projected anew on every call, as in the JAX package: decode
    attention with every length ``Se``."""
    B, _ = x.shape
    Se = enc_out.shape[1]
    q = apply_linear(p["wq"], x).view(B, cfg.n_heads, cfg.hd)
    k, v = _project_kv(p, enc_out, cfg)
    lengths = torch.full((B,), Se, dtype=torch.int32, device=x.device)
    o = ops.decode_attention(q, k, v, lengths, window=None)
    return apply_linear(p["wo"], o.reshape(B, cfg.n_heads * cfg.hd))
