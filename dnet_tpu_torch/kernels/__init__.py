"""Build and load the port's hand-written CUDA kernels (csrc/)."""

from __future__ import annotations

from typing import Dict


def _counters() -> dict:
    """Each kernel's name -> (its wrapper, the wrapper's launch counter);
    the decode wrapper counts each cache variant, plain and rotating, on
    its own, both attention wrappers count their MLA-width launches (V's
    head dim other than Q/K's) apart, and the decode kernel's LSE form
    (flash_decode_lse, one sp rank's partials) counts on the decode
    wrapper too, per cache form and width as the plain form.  Both
    attention wrappers count a call with more than 8 query heads a KV head
    (row groups of blocks) on its own wide counter, whatever its form, and
    a call through the tensor-core form (bf16 at head dim 128, more than 4
    query heads a KV head) once more on its own `_mma` counter.  The prefill
    kernel's per-lane form (the batched speculative verify) counts on
    `flash_prefill_lanes` alone, at every width."""
    from dnet_tpu_torch.compression.ops import column_sq_norms, dequant_scatter_columns, gather_columns
    from dnet_tpu_torch.ops.flash_attention import flash_prefill
    from dnet_tpu_torch.ops.flash_decode import flash_decode_attend
    from dnet_tpu_torch.ops.paged_attention import paged_attend

    return {
        "flash_prefill": (flash_prefill, "launches"),
        "flash_prefill_mla": (flash_prefill, "launches_mla"),
        "flash_prefill_lanes": (flash_prefill, "launches_lanes"),
        "flash_decode": (flash_decode_attend, "launches"),
        "flash_decode_q8": (flash_decode_attend, "launches_q8"),
        "flash_decode_q4": (flash_decode_attend, "launches_q4"),
        "flash_decode_rotating": (flash_decode_attend, "launches_rot"),
        "flash_decode_rotating_q8": (flash_decode_attend, "launches_rot_q8"),
        "flash_decode_rotating_q4": (flash_decode_attend, "launches_rot_q4"),
        "flash_decode_mla": (flash_decode_attend, "launches_mla"),
        "flash_decode_mla_q8": (flash_decode_attend, "launches_mla_q8"),
        "flash_decode_mla_q4": (flash_decode_attend, "launches_mla_q4"),
        "flash_decode_lse": (flash_decode_attend, "launches_lse"),
        "flash_decode_lse_q8": (flash_decode_attend, "launches_lse_q8"),
        "flash_decode_lse_q4": (flash_decode_attend, "launches_lse_q4"),
        "flash_decode_lse_mla": (flash_decode_attend, "launches_lse_mla"),
        "flash_decode_lse_mla_q8": (flash_decode_attend, "launches_lse_mla_q8"),
        "flash_decode_lse_mla_q4": (flash_decode_attend, "launches_lse_mla_q4"),
        "flash_decode_wide": (flash_decode_attend, "launches_wide"),
        "flash_decode_mma": (flash_decode_attend, "launches_mma"),
        "paged_attend": (paged_attend, "launches"),
        "paged_attend_wide": (paged_attend, "launches_wide"),
        "paged_attend_mma": (paged_attend, "launches_mma"),
        "column_sq_norms": (column_sq_norms, "launches"),
        "gather_columns": (gather_columns, "launches"),
        "dequant_scatter_columns": (dequant_scatter_columns, "launches"),
    }


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches in this process since its last reset."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def reset_launch_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)
