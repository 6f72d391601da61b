"""Modality frontend stubs for the [vlm]/[audio] architectures.

As in the JAX package's ``repro.models.frontend``: the transformer
backbone is the deliverable; the vision/audio encoder is a stub that
produces precomputed patch/frame embeddings of the right shapes, drawn
from an explicit ``torch.Generator`` on its device and scaled to unit RMS
per position, in ``cfg.compute_dtype``. The same seed gives the same
embeddings; they are not the JAX package's numbers (``jax.random`` and
``torch`` draw differently).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["stub_vision_embeddings", "stub_audio_frames", "stub_frontend"]


def _unit_rms(gen: torch.Generator, cfg: ModelConfig, batch: int,
              n: int) -> torch.Tensor:
    x = torch.randn((batch, n, cfg.d_model), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return (x / torch.sqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6)
            ).to(cfg.compute_dtype)


def stub_vision_embeddings(gen: torch.Generator, cfg: ModelConfig,
                           batch: int, n_patches: Optional[int] = None,
                           image_hw: Tuple[int, int] = (224, 224)
                           ) -> torch.Tensor:
    """Precomputed ViT patch embeddings (B, P, d_model), unit RMS.

    Dynamic resolution (qwen2-vl): ``n_patches`` defaults to the 14x14
    patch grid of ``image_hw``; callers may pass any count — the backbone
    is resolution-agnostic because M-RoPE positions are supplied per token.
    """
    if n_patches is None:
        n_patches = (image_hw[0] // 14) * (image_hw[1] // 14)
    return _unit_rms(gen, cfg, batch, n_patches)


def stub_audio_frames(gen: torch.Generator, cfg: ModelConfig, batch: int,
                      n_frames: Optional[int] = None,
                      seconds: float = 5.0, frame_hz: float = 50.0
                      ) -> torch.Tensor:
    """Precomputed fbank-encoder frame embeddings (B, T, d_model)."""
    if n_frames is None:
        n_frames = int(seconds * frame_hz)
    return _unit_rms(gen, cfg, batch, n_frames)


def stub_frontend(gen: torch.Generator, cfg: ModelConfig, batch: int,
                  n_positions: Optional[int] = None
                  ) -> Optional[torch.Tensor]:
    """Dispatch on ``cfg.frontend``; None for text-only models."""
    if cfg.frontend is None:
        return None
    n = n_positions or cfg.frontend_len
    if cfg.frontend == "vision":
        return stub_vision_embeddings(gen, cfg, batch, n)
    if cfg.frontend == "audio":
        return stub_audio_frames(gen, cfg, batch, n)
    raise ValueError(f"unknown frontend {cfg.frontend!r}")
