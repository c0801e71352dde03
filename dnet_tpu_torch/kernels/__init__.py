"""Build and load the port's hand-written CUDA kernels (csrc/)."""

from __future__ import annotations

from typing import Dict


def _wrappers() -> dict:
    from dnet_tpu_torch.compression.ops import column_sq_norms, dequant_scatter_columns, gather_columns
    from dnet_tpu_torch.ops.flash_attention import flash_prefill
    from dnet_tpu_torch.ops.flash_decode import flash_decode_attend
    from dnet_tpu_torch.ops.paged_attention import paged_attend

    return {
        "flash_prefill": flash_prefill, "flash_decode": flash_decode_attend,
        "paged_attend": paged_attend, "column_sq_norms": column_sq_norms,
        "gather_columns": gather_columns, "dequant_scatter_columns": dequant_scatter_columns,
    }


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launches in this process since its last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
