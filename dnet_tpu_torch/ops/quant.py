"""Weight-only int8 / int4 quantization (per-group symmetric).

Counterpart of dnet_tpu/ops/quant.py, on torch tensors on the load device:
a model's weights are quantized where they are made or loaded, so a large
model never passes through the host in full precision.  Codes and scales
equal the reference's bit for bit: the group's amax in f32, `scale =
max(amax / 127, 1e-12)` (int4: / 7) in f32, `round(w / scale)` half to
even, clipped to [-127, 127] (int4: [-7, 7], then + 8, offset binary), and
the scales cast to the serving dtype by round-to-nearest-even.

Layouts (groups along the IN / contraction dimension):
- int8: {"q": int8 [..., in, out], "s": [..., in/G, out]}
- int4: {"q4": uint8 [..., in/2, out], "s": [..., in/G, out]}, two
  offset-binary nibbles per byte, adjacent in-rows share a byte (the even
  row in the low nibble).

`dq()` passes plain tensors through, so model code reads a weight the same
way whether it is quantized or not.  Where the reference's XLA fuses the
dequantization into the consuming matmul's operand load, `dq` here is plain
PyTorch: one multiply (int4: after unpacking the nibbles) writes a
full-precision copy of the weight at each call, which the matmul then
reads.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_GROUP = 128
DEFAULT_GROUP_Q4 = 64  # int4 needs finer groups for acceptable error
# f32 elements one quantization pass holds at a time: a wide weight (an LM
# head, a 70B model's MLP) is quantized in column slices, which changes no
# code or scale (every column's groups are independent)
CHUNK_ELEMS = 1 << 26


def _column_slices(w: torch.Tensor):
    inn_lead = w.numel() // max(w.shape[-1], 1)
    step = max(1, CHUNK_ELEMS // max(inn_lead, 1))
    for c0 in range(0, w.shape[-1], step):
        yield slice(c0, min(c0 + step, w.shape[-1]))


def _scales(wf: torch.Tensor, qmax: float) -> torch.Tensor:
    """[..., g, group, out] f32 -> per-group scales [..., g, 1, out] f32.
    The divisor is a tensor on wf's device: CUDA divides by a host scalar
    as a multiply by its reciprocal, which is off by one ulp now and then,
    and the scales must be the IEEE quotient, as numpy's and the CPU's."""
    divisor = torch.full((), qmax, dtype=torch.float32, device=wf.device)
    return torch.clamp(wf.abs().amax(dim=-2, keepdim=True) / divisor, min=1e-12)


def quantize_weight_q8(
    w: torch.Tensor, group_size: int = DEFAULT_GROUP, scale_dtype: Optional[torch.dtype] = None
) -> dict:
    """[..., in, out] float -> {"q": int8, "s": scales} grouped along in, on
    w's device.  Scales carry the serving precision (default bf16): `dq`
    dequantizes to their dtype."""
    *lead, inn, out = w.shape
    if inn % group_size != 0:
        group_size = inn  # one group per whole axis when it doesn't tile
    g = inn // group_size
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((*lead, g, out), dtype=scale_dtype or torch.bfloat16, device=w.device)
    for cols in _column_slices(w):
        wf = w[..., cols].float().reshape(*lead, g, group_size, -1)
        scale = _scales(wf, 127.0)
        q[..., cols] = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8).reshape(*lead, inn, -1)
        s[..., cols] = scale.squeeze(-2).to(s.dtype)
    return {"q": q, "s": s}


def quantize_weight_q4(
    w: torch.Tensor, group_size: int = DEFAULT_GROUP_Q4, scale_dtype: Optional[torch.dtype] = None
) -> dict:
    """[..., in, out] float -> {"q4": packed uint8, "s": scales}: symmetric
    [-7, 7] stored offset-binary (value + 8), two nibbles per byte along the
    in axis.  Requires an even in dim."""
    *lead, inn, out = w.shape
    if inn % 2 != 0:
        raise ValueError(f"int4 packing needs an even contraction dim, got {inn}")
    if group_size % 2 != 0:
        raise ValueError(f"int4 group_size must be even, got {group_size}")
    if inn % group_size != 0:
        group_size = inn
    g = inn // group_size
    packed = torch.empty((*lead, inn // 2, out), dtype=torch.uint8, device=w.device)
    s = torch.empty((*lead, g, out), dtype=scale_dtype or torch.bfloat16, device=w.device)
    for cols in _column_slices(w):
        wf = w[..., cols].float().reshape(*lead, g, group_size, -1)
        scale = _scales(wf, 7.0)
        q = (torch.clamp(torch.round(wf / scale), -7, 7) + 8).to(torch.uint8).reshape(*lead, inn, -1)
        packed[..., cols] = q[..., 0::2, :] | (q[..., 1::2, :] << 4)
        s[..., cols] = scale.squeeze(-2).to(s.dtype)
    return {"q4": packed, "s": s}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "s" in w and ("q" in w or "q4" in w)


def _qarr(w: dict) -> torch.Tensor:
    return w["q"] if "q" in w else w["q4"]


def out_dim(w) -> int:
    """Output (last-axis) dimension of a maybe-quantized weight."""
    return (_qarr(w) if is_quantized(w) else w).shape[-1]


def lead_dim(w) -> int:
    """Leading-axis dimension of a maybe-quantized weight (the expert count
    of a stacked MoE weight)."""
    return (_qarr(w) if is_quantized(w) else w).shape[0]


def _nibbles(p: torch.Tensor, axis: int) -> torch.Tensor:
    """Packed int4 codes -> their int8 values (-8 .. 7), the two nibbles of
    each byte stacked on `axis` (low nibble: the even row)."""
    return torch.stack([p & 0xF, p >> 4], dim=axis).view(torch.int8) - 8


def dq(w: Union[torch.Tensor, dict], dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dequantize-or-passthrough.  The default dtype is the scales' (the
    engine's param dtype), so f32 serving stays f32.  The codes stay
    integers up to one multiply by the scales, whose result takes the
    scales' dtype: each value is the exact code times the scale, rounded
    once, as the reference's `q.astype(dtype) * s`."""
    if not is_quantized(w):
        return w
    s = w["s"]
    dtype = dtype or s.dtype
    if "q4" in w:
        p = w["q4"]
        *lead, half, out = p.shape
        inn = half * 2
        q = _nibbles(p, -2)
    else:
        q = w["q"]
        *lead, inn, out = q.shape
    g = s.shape[-2]
    deq = q.reshape(*lead, g, inn // g, out) * s.to(dtype)[..., :, None, :]
    return deq.reshape(*lead, inn, out)


def embed_lookup(w: Union[torch.Tensor, dict], tokens: torch.Tensor) -> torch.Tensor:
    """Row gather from a maybe-quantized embedding table.

    Plain: w [vocab, hidden] -> w[tokens] ([..., hidden]).  Quantized: w
    holds the PROJECTION layout ({"q" | "q4": [hidden(/2), vocab], "s": [g,
    vocab]}, RingModel.quantize_edge), so logical table rows are physical
    columns: gather the tokens' columns, then dequantize them with those
    tokens' per-group scales."""
    tok = tokens.long()
    if not is_quantized(w):
        return w[tok]
    s = w["s"]
    dtype = s.dtype
    sg = s[:, tok]  # [g, *tok]
    if "q4" in w:
        q = _nibbles(w["q4"][:, tok], 1).reshape(-1, *tok.shape)  # [hidden, *tok]
    else:
        q = w["q"][:, tok]  # [hidden, *tok]
    hidden, g = q.shape[0], sg.shape[0]
    deq = q.reshape(g, hidden // g, *tok.shape) * sg[:, None]
    return torch.movedim(deq.reshape(hidden, *tok.shape), 0, -1)


def quantizer(bits: int, group_size: int = 0):
    """(quantize function, group size) for `bits` 8 or 4; group_size 0 is
    the bits' default."""
    if bits not in (4, 8):
        raise NotImplementedError(f"weight quantization bits={bits} (4 or 8)")
    if bits == 4:
        return quantize_weight_q4, group_size or DEFAULT_GROUP_Q4
    return quantize_weight_q8, group_size or DEFAULT_GROUP


def quantize_tree(
    params: dict, keys, group_size: int = 0, scale_dtype: Optional[torch.dtype] = None, bits: int = 8
) -> dict:
    """Quantize the named 2-D+ weights of a param dict (one layer's, or a
    stack's: codes are the same per layer)."""
    quantize, group_size = quantizer(bits, group_size)
    return {
        k: quantize(v, group_size, scale_dtype)
        if k in keys and not is_quantized(v) and v.dim() >= 2 else v
        for k, v in params.items()
    }


# weights worth quantizing (the big matmuls; norms/biases/sinks stay float)
QUANTIZABLE = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",  # llama/qwen3
    "gate_up", "down",  # gpt_oss experts
})
