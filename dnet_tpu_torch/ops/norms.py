"""Normalization (functional, f32 accumulation).

Counterpart of dnet_tpu/ops/norms.py.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with float32 accumulation, cast back to x.dtype.

    Matches HF LlamaRMSNorm: y = w * x / sqrt(mean(x^2) + eps).
    """
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)
