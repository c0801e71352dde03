"""Rotary position embeddings (HF-compatible half-split convention, incl.
Llama-3 scaling).

Counterpart of dnet_tpu/ops/rope.py: the frequencies are computed once per
model config in numpy float64, exactly as the reference does, and moved to
the device as float32.  This slice covers the default, linear and llama3
`rope_scaling` types; YaRN and the interleaved layout come with the model
families that need them.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch


def rope_frequencies(
    head_dim: int,
    theta: float = 10000.0,
    scaling: Optional[dict[str, Any]] = None,
    max_position_embeddings: int = 8192,
) -> tuple[np.ndarray, float]:
    """(inv_freq [head_dim//2] float32, attention_scaling) with HF
    `rope_scaling`; attention_scaling is 1.0 for the types covered here."""
    inv_freq = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )
    attention_scaling = 1.0
    if scaling:
        rope_type = scaling.get("rope_type", scaling.get("type", ""))
        if rope_type == "llama3":
            factor = scaling.get("factor", 8.0)
            low_factor = scaling.get("low_freq_factor", 1.0)
            high_factor = scaling.get("high_freq_factor", 4.0)
            old_len = scaling.get("original_max_position_embeddings", 8192)
            low_wavelen = old_len / low_factor
            high_wavelen = old_len / high_factor
            wavelen = 2 * math.pi / inv_freq
            scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
            smooth = (old_len / wavelen - low_factor) / (high_factor - low_factor)
            mid = (1 - smooth) * inv_freq / factor + smooth * inv_freq
            is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
            inv_freq = np.where(is_mid, mid, scaled)
        elif rope_type == "linear":
            inv_freq = inv_freq / scaling.get("factor", 1.0)
        elif rope_type not in ("default", ""):
            raise NotImplementedError(f"rope_scaling type {rope_type!r}")
    return inv_freq.astype(np.float32), attention_scaling


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    inv_freq: torch.Tensor,
    attention_scaling: float = 1.0,
) -> torch.Tensor:
    """Rotate q or k.

    x: [B, T, N, head_dim]; positions: [B, T] or [T] absolute positions;
    inv_freq: float32 [head_dim // 2] on x's device.
    """
    angles = positions[..., None].float() * inv_freq  # [..., T, D/2]
    if angles.dim() == 2:  # [T, D/2] -> broadcast over batch
        angles = angles[None]
    cos = (torch.cos(angles) * attention_scaling)[:, :, None, :]
    sin = (torch.sin(angles) * attention_scaling)[:, :, None, :]
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
