"""Mixture-of-experts token dispatch on one device: capacity routing.

Counterpart of dnet_tpu/ops/moe.py, single-device paths only.  Two
interchangeable compute paths over the same routed-FFN semantics:

- dense       every token x every expert, the router's scattered scores
              masking the sum; exact, and the reference's default (the
              models keep this path inline and pass it in as `dense_fn`).
- dispatch    scatter tokens into per-expert capacity buffers [E, C, D], run
              the FFN once over the buffers, gather back weighted by the
              router probs.  Tokens routed beyond an expert's capacity are
              dropped (GShard/Switch capacity semantics); capacity_factor
              <= 0 selects the exact no-drop capacity C = N.

"auto" picks dense below ~2E tokens (decode) and dispatch above, and "a2a"
without a device mesh is dispatch, as in the reference on one device.  The
expert-parallel paths (`moe_dispatch_sharded`, `moe_a2a*`,
`localize_topk`) come with multi-GPU serving.  The expert products are
plain batched matrix products (`torch.bmm` in the models' FFN closures,
`swiglu_expert_closures` for the stacked-SwiGLU families), as the
reference leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from dnet_tpu_torch.ops.quant import dq, lead_dim


def expert_capacity(n_tokens: int, n_experts: int, k: int, factor: float) -> int:
    """Per-expert token capacity C.  factor <= 0 -> exact (C = n)."""
    if factor <= 0:
        return int(n_tokens)
    c = math.ceil(k * n_tokens * factor / n_experts)
    return max(1, min(int(n_tokens), c))


MOE_IMPLS = ("auto", "dense", "dispatch", "a2a")


def resolve_moe_impl(impl: str, n_tokens: int, n_experts: int) -> str:
    """The compute path for a (token count, expert count) shape on one
    device: "auto" is dense below ~2E tokens (decode), dispatch above."""
    if impl not in MOE_IMPLS:
        # fail fast: a mistyped DNET_COMPUTE_MOE_IMPL would otherwise fall
        # through into silent dense compute
        raise ValueError(f"unknown moe_impl {impl!r}; expected one of {MOE_IMPLS}")
    if impl != "auto":
        return impl
    return "dense" if n_tokens < max(2 * n_experts, 16) else "dispatch"


def route_positions(top_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Arrival index of each (token, slot) within its expert's queue.

    top_idx [N, k] integer expert ids (entries >= n_experts are sentinels
    and get position 0; scatter/gather drop them).  Returns pos [N, k]
    int64: a slot-major cumulative count, so a token's place in an expert
    buffer follows token order."""
    flat_e = top_idx.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(n_experts, device=top_idx.device)[None, :]).long()
    pos = torch.cumsum(onehot, dim=0) - 1
    return (pos * onehot).sum(dim=1).reshape(top_idx.shape)


def _in_bounds(top_idx: torch.Tensor, pos: torch.Tensor, n_experts: int, capacity: int) -> torch.Tensor:
    return (top_idx >= 0) & (top_idx < n_experts) & (pos < capacity)


def scatter_to_experts(
    flat: torch.Tensor, top_idx: torch.Tensor, pos: torch.Tensor, n_experts: int, capacity: int
) -> torch.Tensor:
    """flat [N, D] -> per-expert buffers [E, C, D].  Slots whose expert id or
    queue position is out of bounds (a sentinel, over capacity) are
    dropped."""
    D = flat.shape[-1]
    keep = _in_bounds(top_idx, pos, n_experts, capacity)
    vals = flat[:, None, :].expand(*top_idx.shape, D)[keep]
    buf = torch.zeros((n_experts, capacity, D), dtype=flat.dtype, device=flat.device)
    return buf.index_put_((top_idx[keep].long(), pos[keep]), vals, accumulate=True)


def gather_from_experts(
    ye: torch.Tensor, top_idx: torch.Tensor, pos: torch.Tensor, top_w: torch.Tensor
) -> torch.Tensor:
    """ye [E, C, D] + router weights [N, k] -> combined [N, D]; dropped slots
    contribute zero."""
    E, C = ye.shape[0], ye.shape[1]
    keep = _in_bounds(top_idx, pos, E, C)
    g = ye[top_idx.long().clamp(0, E - 1), pos.clamp(max=C - 1)]  # [N, k, D]
    g = torch.where(keep[..., None], g, torch.zeros((), dtype=ye.dtype, device=ye.device))
    return torch.einsum("nkd,nk->nd", g, top_w.to(ye.dtype))


def moe_dispatch(
    flat: torch.Tensor,
    top_idx: torch.Tensor,
    top_w: torch.Tensor,
    ffn: Callable[[torch.Tensor], torch.Tensor],
    n_experts: int,
    capacity: int,
) -> torch.Tensor:
    """Single-device capacity dispatch: [N, D] -> [N, D].  ffn maps
    per-expert buffers [E, C, D] -> [E, C, D] (row i uses expert i's
    weights; per-expert biases are added inside, so a dropped token simply
    contributes zero to the combine)."""
    pos = route_positions(top_idx, n_experts)
    xe = scatter_to_experts(flat, top_idx, pos, n_experts, capacity)
    return gather_from_experts(ffn(xe), top_idx, pos, top_w)


def moe_apply(
    impl: str,
    flat: torch.Tensor,
    top_idx: torch.Tensor,
    top_w: torch.Tensor,
    ffn: Callable[[torch.Tensor], torch.Tensor],
    n_experts: int,
    capacity_factor: float,
    k: int,
    dense_fn: Callable[[], torch.Tensor],
) -> torch.Tensor:
    """One MoE layer through the selected compute path on one device (the
    reference's `moe_apply` with tp_axis=None): the models supply only
    their ffn / dense closures and routing.  Returns out [N, D]."""
    impl = resolve_moe_impl(impl, flat.shape[0], n_experts)
    if impl in ("dispatch", "a2a"):
        capacity = expert_capacity(flat.shape[0], n_experts, k, capacity_factor)
        return moe_dispatch(flat, top_idx, top_w, ffn, n_experts, capacity)
    return dense_fn()


def swiglu_expert_closures(
    p: dict, flat: torch.Tensor, top_idx: torch.Tensor, top_w: torch.Tensor
) -> Tuple[Callable[[torch.Tensor], torch.Tensor], Callable[[], torch.Tensor], int]:
    """(effn, dense, E) for the SwiGLU-expert MoE families (deepseek's
    routed experts, mixtral) on one device: p holds the stacked
    (in, out)-oriented expert weights e_gate/e_up [E, D, F] and e_down
    [E, F, D], each maybe quantized (read through ops/quant.py `dq`).  effn maps per-expert buffers [E, C, D] -> [E, C, D];
    dense() runs every token through every expert and sums the outputs
    weighted by the router weights scattered over the E experts (top_idx /
    top_w [N, k]), exact; it returns [N, D] in flat's dtype."""
    E = lead_dim(p["e_gate"])
    N, D = flat.shape

    def effn(xe: torch.Tensor) -> torch.Tensor:
        return torch.bmm(F.silu(torch.bmm(xe, dq(p["e_gate"]))) * torch.bmm(xe, dq(p["e_up"])), dq(p["e_down"]))

    def dense() -> torch.Tensor:
        weights = torch.zeros((N, E), dtype=top_w.dtype, device=flat.device).scatter(1, top_idx.long(), top_w)
        # [N, D] broadcast over the experts: one batched product over the
        # stacked weights as stored
        expert_out = effn(flat.expand(E, N, D))  # [E, N, D]
        return torch.einsum("end,ne->nd", expert_out, weights.to(flat.dtype))

    return effn, dense, E
