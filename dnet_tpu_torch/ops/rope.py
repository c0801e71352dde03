"""Rotary position embeddings: the HF half-split convention (`apply_rope`,
incl. Llama-3 scaling) and the complex-pair one (`apply_rope_interleaved`,
DeepSeek-V2's).

Counterpart of dnet_tpu/ops/rope.py: the frequencies are computed once per
model config in numpy float64, exactly as the reference does, and moved to
the device as float32.  It covers the default, linear, llama3 and yarn
`rope_scaling` types (yarn's attention scaling multiplies cos and sin).
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
    `rope_scaling`; attention_scaling is YaRN's mscale, 1.0 for the other
    types."""
    inv_freq = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )
    attention_scaling = 1.0
    if scaling:
        rope_type = scaling.get("rope_type", scaling.get("type", ""))
        if rope_type == "yarn":
            inv_freq, attention_scaling = _yarn(inv_freq, head_dim, theta, scaling, max_position_embeddings)
        elif rope_type == "llama3":
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


def _yarn(
    inv_freq: np.ndarray, dim: int, theta: float, scaling: dict[str, Any], max_position_embeddings: int
) -> tuple[np.ndarray, float]:
    """YaRN: blend interpolated (inv_freq / factor) and extrapolated
    frequencies over a linear ramp between the correction dims of
    beta_fast and beta_slow.  With `truncate` false (gpt-oss) the ramp's
    bounds stay fractional."""
    factor = scaling.get("factor", 1.0)
    attention_factor = scaling.get("attention_factor")
    mscale = scaling.get("mscale")
    mscale_all_dim = scaling.get("mscale_all_dim")
    old_len = scaling.get("original_max_position_embeddings") or max_position_embeddings

    def get_mscale(scale: float, ms: float = 1.0) -> float:
        return 1.0 if scale <= 1 else 0.1 * ms * math.log(scale) + 1.0

    if attention_factor is None:
        if mscale and mscale_all_dim:
            attention_factor = get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim)
        else:
            attention_factor = get_mscale(factor)

    def correction_dim(num_rot: float) -> float:
        return (dim * math.log(old_len / (num_rot * 2 * math.pi))) / (2 * math.log(theta))

    low = correction_dim(scaling.get("beta_fast") or 32)
    high = correction_dim(scaling.get("beta_slow") or 1)
    if scaling.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low) / (high - low), 0, 1)
    extrapolation = 1 - ramp
    return (inv_freq / factor) * (1 - extrapolation) + inv_freq * extrapolation, float(attention_factor)


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


def apply_rope_interleaved(
    x: torch.Tensor,
    positions: torch.Tensor,
    inv_freq: torch.Tensor,
    attention_scaling: float = 1.0,
) -> torch.Tensor:
    """Rotate q or k in the complex-pair convention: the pairs are
    (x[2i], x[2i+1]), as DeepSeek-V2's `view_as_complex` rotary takes them
    (not the half-split one).  x: [B, T, N, D]; positions [B, T] or [T]."""
    angles = positions[..., None].float() * inv_freq  # [..., T, D/2]
    if angles.dim() == 2:
        angles = angles[None]
    cos = (torch.cos(angles) * attention_scaling)[:, :, None, :]
    sin = (torch.sin(angles) * attention_scaling)[:, :, None, :]
    xf = x.float()
    x_even, x_odd = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x_even * cos - x_odd * sin, x_odd * cos + x_even * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
