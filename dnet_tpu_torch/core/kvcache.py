"""KV cache: preallocated and layer-stacked, plain or quantized.

Counterpart of dnet_tpu/core/kvcache.py (full-length caches, the
rotating sliding-window ring, and the sequence-parallel shards of
`init_cache_sp` / `write_kv_sp`).  Layout: k is
[L, B, S_max, KVH, Hd] and v [L, B, S_max, KVH, Vd] (Vd = `v_head_dim`, the
same as Hd unless set: MLA caches K at nope + rope and V at its own width);
a layer's slices `cache[name][l]` are contiguous
[B, S_max, KVH, Hd] views, which the attention kernels read in place.  A
ring cache (gpt_oss's sliding layers) has S_max = W rows, and the token at
absolute position p lives in slot p % W (`write_kv_rotating`).

Quantized caches (`quant_bits` 8 or 4, the reference's DNET_KV_BITS) hold
codes plus one f32 scale per (slot, KV head), `k_scale`/`v_scale`
[L, B, S_max, KVH, 1]: int8 codes, or offset-binary int4 nibbles packed in
pairs along the head dim into uint8 [.., Hd/2] and [.., Vd/2] (low nibble =
even index).
Codes and scales equal the reference's bit for bit: f32 upcast, division by
the scale, round half to even, clip.  The decode kernel reads the codes and
dequantizes in on-chip memory; `read_kv` dequantizes a prefix to f32 for
prefill.

Unlike JAX's `dynamic_update_slice`, which clamps an out-of-range start and
would silently shift the write, `write_kv` raises when a chunk does not
fit; the engine keeps every chunk inside the cache by padding to at most
`max_seq - pos` tokens.  `write_kv_rows` writes one row, or one chunk of
rows (a speculative verify block), per active lane of a batch (the
reference's `kv_commit` gate), leaving other lanes untouched.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class KVConfig:
    n_layers: int  # local layers in this cache
    batch: int
    max_seq: int
    n_kv_heads: int
    head_dim: int  # key head dim
    dtype: str = "bfloat16"
    v_head_dim: int = 0  # 0 = same as head_dim (MLA caches differ: k = nope + rope, v = v_head)
    # 0 = dtype as-is; 8 = int8, 4 = packed int4 (two values a byte along the
    # head dim), both with per-(slot, head) f32 scales
    quant_bits: int = 0


def resolve_kv_bits(kv_bits: int) -> Tuple[Optional[str], int]:
    """Map the API-level kv_bits knob (DNET_KV_BITS, a topology's kv_bits) to
    engine arguments: (KV dtype override, quant bits)."""
    if kv_bits == 16:
        return "bfloat16", 0
    if kv_bits in (4, 8):
        return None, kv_bits
    if kv_bits != 0:
        # a mistyped value must not quietly serve a cache nobody budgeted for
        raise NotImplementedError(f"kv_bits={kv_bits} (supported: 0/4/8/16)")
    return None, 0


def init_cache(cfg: KVConfig, device: torch.device) -> dict:
    rows = (cfg.n_layers, cfg.batch, cfg.max_seq, cfg.n_kv_heads)
    vd = cfg.v_head_dim or cfg.head_dim
    scale_shape = (*rows, 1)
    if cfg.quant_bits in (4, 8):
        if cfg.quant_bits == 4 and (cfg.head_dim % 2 or vd % 2):
            raise ValueError("int4 KV needs even head dims")
        per = 1 if cfg.quant_bits == 8 else 2  # values per stored element
        dt = torch.int8 if cfg.quant_bits == 8 else torch.uint8
        return {
            "k": torch.zeros((*rows, cfg.head_dim // per), dtype=dt, device=device),
            "v": torch.zeros((*rows, vd // per), dtype=dt, device=device),
            "k_scale": torch.zeros(scale_shape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(scale_shape, dtype=torch.float32, device=device),
        }
    if cfg.quant_bits not in (0, 16):
        raise NotImplementedError(f"kv quant_bits={cfg.quant_bits} (only 0/4/8/16)")
    dt = getattr(torch, cfg.dtype)
    return {
        "k": torch.zeros((*rows, cfg.head_dim), dtype=dt, device=device),
        "v": torch.zeros((*rows, vd), dtype=dt, device=device),
    }


def init_cache_sp(cfg: KVConfig, devices) -> list:
    """Sequence-parallel shards of one cache: rank r's own cache of
    max_seq / R slots on devices[r], holding slots
    [r * S_local, (r + 1) * S_local) of the sequence."""
    R = len(devices)
    if cfg.max_seq % R:
        raise ValueError(f"sp={R} must divide max_seq={cfg.max_seq}")
    local = dataclasses.replace(cfg, max_seq=cfg.max_seq // R)
    return [init_cache(local, torch.device(d)) for d in devices]


def cache_nbytes(cfg: KVConfig) -> int:
    base = cfg.n_layers * cfg.batch * cfg.max_seq * cfg.n_kv_heads
    dims = cfg.head_dim + (cfg.v_head_dim or cfg.head_dim)
    if cfg.quant_bits == 8:
        return base * dims + base * 2 * 4  # int8 + f32 scales
    if cfg.quant_bits == 4:
        return base * dims // 2 + base * 2 * 4
    return base * dims * getattr(torch, cfg.dtype).itemsize


def layer_slices(cache: dict, layer: int) -> dict:
    """One layer's cache views (writes through them land in `cache`)."""
    return {name: arr[layer] for name, arr in cache.items()}


# ---- quantized read/write ---------------------------------------------------


def _quantize_q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(..., head) symmetric int8: one f32 scale over the last axis."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def _quantize_q4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(..., head) symmetric int4, offset-binary nibbles packed in pairs
    along the last (head) axis: [..., Hd] -> uint8 [..., Hd/2]."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 7.0, min=1e-8)
    q = (torch.clamp(torch.round(xf / scale), -7, 7) + 8).to(torch.uint8)
    return q[..., 0::2] | (q[..., 1::2] << 4), scale


def _unpack_q4(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., Hd/2] -> f32 [..., Hd] (inverse of _quantize_q4's pack)."""
    lo = (p & 0xF).float() - 8.0
    hi = ((p >> 4) & 0xF).float() - 8.0
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], p.shape[-1] * 2)


def _encoded(kvs: dict, k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    """The cache entries for new k/v: quantized codes and scales when the
    cache carries scales, else the values in the cache's dtype."""
    if "k_scale" not in kvs:
        return {"k": k_new.to(kvs["k"].dtype), "v": v_new.to(kvs["v"].dtype)}
    quantize = _quantize_q4 if kvs["k"].dtype == torch.uint8 else _quantize_q8
    kq, ks = quantize(k_new)
    vq, vs = quantize(v_new)
    return {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}


def write_kv(kvs: dict, k_new: torch.Tensor, v_new: torch.Tensor, pos: int) -> dict:
    """Write new k/v ([B, T, KVH, Hd] / [.., Vd]) at slot `pos` of one layer's cache
    slices, IN PLACE (the reference returns an updated copy), quantizing
    when the cache carries scales; returns kvs."""
    T = k_new.shape[1]
    S = kvs["k"].shape[1]
    if pos < 0 or pos + T > S:
        raise ValueError(f"KV write [{pos}, {pos + T}) outside a cache of {S} slots")
    for name, val in _encoded(kvs, k_new, v_new).items():
        kvs[name][:, pos : pos + T] = val
    return kvs


def write_kv_sp(ranks: list, k_new: torch.Tensor, v_new: torch.Tensor, pos: int) -> list:
    """Sequence-parallel write of new k/v ([B, T, KVH, Hd] / [.., Vd]) at
    absolute slot `pos`, IN PLACE: `ranks` holds each rank's layer slices
    (S_local slots each, rank r owning [r * S_local, (r + 1) * S_local)),
    and each token lands on the rank that owns its slot.  A chunk that
    straddles a shard boundary is one slice write on each rank it touches
    (the reference's gather + where over every local slot writes the same
    values); a decode token is written by its owner only.  Every one of the
    T tokens is written, bucket padding included, as the reference writes
    it.  Quantizes when the caches carry scales; returns ranks."""
    T = k_new.shape[1]
    S_local = ranks[0]["k"].shape[1]
    if pos < 0 or pos + T > S_local * len(ranks):
        raise ValueError(f"KV write [{pos}, {pos + T}) outside {len(ranks)} shards of {S_local} slots")
    for r, kvs in enumerate(ranks):
        lo, hi = max(pos, r * S_local), min(pos + T, (r + 1) * S_local)
        if lo >= hi:
            continue
        dev = kvs["k"].device
        k_r = k_new[:, lo - pos : hi - pos].to(dev, non_blocking=True)
        v_r = v_new[:, lo - pos : hi - pos].to(dev, non_blocking=True)
        write_kv(kvs, k_r, v_r, lo - r * S_local)
    return ranks


def write_kv_rows(
    kvs: dict, k_rows: torch.Tensor, v_rows: torch.Tensor, lanes: torch.Tensor, positions: torch.Tensor
) -> dict:
    """Write one new row per listed lane ([n, KVH, Hd]) at slot
    positions[i] of lane lanes[i], or a chunk of rows per lane ([n, T, KVH,
    Hd]) at slots positions[i, :] (int64 [n, T]), IN PLACE, codes and
    scales together; the other lanes' rows are untouched.  lanes/positions
    are int64 on the cache's device, each position inside the cache (the
    caller checks: an index out of range is a device-side fault here, never
    a clamped write)."""
    rows = lanes[:, None] if positions.dim() == 2 else lanes
    for name, val in _encoded(kvs, k_rows, v_rows).items():
        kvs[name][rows, positions] = val
    return kvs


def write_kv_rotating(
    kvs: dict, k_new: torch.Tensor, v_new: torch.Tensor, pos: int, t_real: Optional[int] = None
) -> dict:
    """Ring-buffer write of new k/v ([B, T, KVH, Hd]) starting at absolute
    position `pos`, IN PLACE: the token at position p lands in slot p % W
    (W = the cache's row count), and each slot receives its MOST RECENT
    in-chunk token, so a chunk longer than W writes only its last W tokens
    (the earlier ones are out of every later query's window).  Only the
    first `t_real` tokens are real (None: all T): bucket padding must never
    wrap into the ring, where it would overwrite live rows.  Quantizes when
    the cache carries scales.  The live tokens fill at most two slices of
    the ring (one wrap), written as such; returns kvs."""
    W = kvs["k"].shape[1]
    t_eff = k_new.shape[1] if t_real is None else int(t_real)
    n = min(t_eff, W)  # tokens that survive: the chunk's last n real ones
    if n <= 0:
        return kvs
    j0 = t_eff - n
    start = (pos + j0) % W
    first = min(n, W - start)  # slots [start, start + first), then [0, n - first)
    enc = _encoded(kvs, k_new[:, j0:t_eff], v_new[:, j0:t_eff])
    for name, val in enc.items():
        kvs[name][:, start : start + first] = val[:, :first]
        if n > first:
            kvs[name][:, : n - first] = val[:, first:]
    return kvs


def read_kv(kvs: dict, upto: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """k/v for attention.  A quantized cache dequantizes to f32 (attention
    runs its softmax and products in f32 anyway), slots [0, upto) only when
    `upto` is given: later slots are masked by every reader.  A plain cache
    returns its own tensors, whole."""
    if "k_scale" not in kvs:
        return kvs["k"], kvs["v"]
    n = kvs["k"].shape[1] if upto is None else upto
    out = []
    for name in ("k", "v"):
        codes, scale = kvs[name][:, :n], kvs[f"{name}_scale"][:, :n]
        codes = _unpack_q4(codes) if codes.dtype == torch.uint8 else codes.float()
        out.append(codes * scale)
    return out[0], out[1]
