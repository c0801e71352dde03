"""Settings the port reads from the environment, under the reference's names.

Counterpart of dnet_tpu/config.py, trimmed to what the port's paths read:
`KVSettings` (DNET_KV_BITS, DNET_KV_PAGED, DNET_KV_RAGGED,
DNET_KV_BLOCK_TOKENS, DNET_KV_POOL_BLOCKS), `ApiSettings` (DNET_API_*: the
API node's host, ports, timeout, admission, models dir, max_seq_len,
param dtype and batch slots, which its CLI takes as defaults; the ring's
auto steps and callback address; the weight quantization and its group;
and the prefix cache, speculation and draft model, which the port reads to
refuse where it does not serve them yet),
`AdmissionSettings` (DNET_REQUEST_DEADLINE_S: the default request deadline),
`ShardSettings` (DNET_SHARD_*: a shard's CLI defaults and the weight
streaming repack cache's directory, `repack_dir`), the ring's
`TransportSettings` (DNET_TRANSPORT_*), `WireSettings`
(DNET_WIRE_*: the hop codec), `ComputeSettings` (DNET_COMPUTE_MOE_IMPL,
DNET_COMPUTE_MOE_CAPACITY_FACTOR), `MeshSettings` (DNET_MESH_PP/TP/DP/SP:
the API node's --mesh default; the multi-host BACKEND, COORDINATOR,
NUM_PROCESSES and PROCESS_ID are read only to refuse values other than
their defaults), and `SchedSettings` (DNET_SCHED, DNET_SCHED_TOKEN_BUDGET,
DNET_SCHED_PREFILL_CHUNK, DNET_SCHED_SLOTS: the iteration-level scheduler)
with the capacity of its tick ring (DNET_OBS_TICK_RECORDS, `ObsSettings`).
Values come from the process environment on every call (no .env file, no
cache), so a flip is seen at the next engine load.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional, Type, TypeVar

T = TypeVar("T")

_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off"}


def _parse_bool(raw: str) -> bool:
    low = raw.strip().lower()
    if low in _TRUTHY:
        return True
    if low in _FALSY:
        return False
    raise ValueError(f"not a boolean: {raw!r}")


_PARSERS = {"bool": _parse_bool, "int": int, "float": float, "str": str}


def _from_env(cls: Type[T], prefix: str) -> T:
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = f"{prefix}{f.name.upper()}"
        raw = os.environ.get(key)
        if raw is None or not raw.strip():
            continue
        try:
            kwargs[f.name] = _PARSERS[f.type](raw.strip())
        except ValueError as exc:
            raise ValueError(f"bad value for {key}: {exc}") from exc
    return cls(**kwargs)


@dataclass
class KVSettings:
    """The KV cache's form (`bits`: 0 = the param dtype, 16 = bf16, 8 = int8,
    4 = packed int4, core/kvcache.py `resolve_kv_bits`), and paged KV:
    block-granular allocation with per-sequence page tables over a shared
    pool (`paged`), decoded in place by the ragged kernel (`ragged`)."""

    bits: int = 0
    paged: bool = False
    # tokens per KV block (the allocation granule); must divide max_seq
    block_tokens: int = 16
    # total pool capacity in blocks; 0 = the engine's dense equivalent
    # (slots x max_seq / block_tokens)
    pool_blocks: int = 0
    ragged: bool = False


@dataclass
class ApiSettings:
    host: str = "0.0.0.0"
    http_port: int = 8080
    grpc_port: int = 58080
    request_timeout_s: float = 300.0
    max_concurrent_requests: int = 8
    models_dir: str = "~/.dnet-tpu/models"
    max_seq_len: int = 4096
    param_dtype: str = "bfloat16"
    # 8 / 4 = weight-only int8 / int4 serving (ops/quant.py); the group
    # along the contraction axis (0 = the bits' default, 128 / 64)
    weight_quant_bits: int = 0
    weight_quant_group: int = 0
    # >1 = continuous batching over that many slots (core/batch.py)
    batch_slots: int = 1
    # >0 = a prefix cache of that many entries (not ported: refused at load)
    prefix_cache: int = 0
    # >0 = speculative decoding with that many drafted tokens, and a draft
    # model's checkpoint for it (neither ported: refused at load)
    spec_lookahead: int = 0
    draft_model: str = ""
    # decode grants on a ring: tokens the tail may feed straight back to
    # the head without an API round trip (0 = every step from the API)
    ring_auto_steps: int = 16
    # host:port the shards dial for token callbacks ("" = derived)
    callback_addr: str = ""


@dataclass
class ShardSettings:
    host: str = "0.0.0.0"
    http_port: int = 8081
    grpc_port: int = 58081
    queue_size: int = 256
    name: str = ""
    models_dir: str = "~/.dnet-tpu/models"
    # the weight-streaming repack cache (core/weights.py HostLayerStore)
    repack_dir: str = "~/.dnet-tpu/repacked"


@dataclass
class TransportSettings:
    """The ring's hidden-state hops (DNET_TRANSPORT_*): the older sparse_v1
    column compression, and the send retry/backoff policy."""

    compress: bool = False
    compress_pct: float = 0.5
    compress_quant_bits: int = 0
    send_retries: int = 3
    stream_idle_sweep_s: float = 30.0
    stream_backoff_s: float = 0.25


@dataclass
class WireSettings:
    """The hop codec (DNET_WIRE_*).  `codec`: auto (qsparse8 for hops that
    cross hosts, lossless otherwise), lossless or qsparse8; `qsparse_pct`
    is the fraction of columns qsparse8 drops and `group_size` its quant
    group.  `pipeline` (the overlapped encode) is not ported: shards
    refuse it at load."""

    pipeline: bool = False
    codec: str = "auto"
    qsparse_pct: float = 0.5
    group_size: int = 64


@dataclass
class ComputeSettings:
    """The MoE compute path (ops/moe.py): `moe_impl` dense | auto |
    dispatch | a2a (dense is exact and the reference's default; dispatch
    may drop over-capacity tokens), and the per-expert capacity factor
    (capacity = ceil(k * tokens * factor / experts); <= 0 is the exact
    no-drop capacity)."""

    moe_impl: str = "dense"
    moe_capacity_factor: float = 1.25


@dataclass
class MeshSettings:
    """The serving mesh's axes (DNET_MESH_*), the API node's --mesh default:
    sequence parallelism (sp) over that many ranks is ported; pp (0 =
    infer, which the single controller resolves to 1), tp and dp are read
    so that other values are refused, as are the multi-host fields."""

    pp: int = 0
    tp: int = 1
    dp: int = 1
    sp: int = 1
    backend: str = ""
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = 0

    def axes(self) -> Optional[dict]:
        """The mesh these settings ask for, or None when they ask for none
        (the reference's test: pp > 0 or another axis above 1)."""
        if self.pp > 0 or self.tp > 1 or self.dp > 1 or self.sp > 1:
            return {"pp": self.pp, "tp": self.tp, "dp": self.dp, "sp": self.sp}
        return None


@dataclass
class AdmissionSettings:
    """The reference's admission settings, trimmed to the default end-to-end
    request deadline (DNET_REQUEST_DEADLINE_S); 0 disables, and a request's
    own `deadline_s` overrides it (admission/controller.py)."""

    request_deadline_s: float = 0.0


@dataclass
class SchedSettings:
    """The iteration-level continuous-batching scheduler (sched/).
    DNET_SCHED=1 makes it the serving adapter for local model loads
    without a mesh: every tick packs up to `sched_token_budget` tokens of
    chunked-prefill segments (at most `sched_prefill_chunk` a request) and
    one decode step per running sequence, admits work while the paged-KV
    pool can cover it, and preempts the lowest-priority sequence under
    block starvation.  `sched_slots` batch lanes (0: max(batch_slots, 8))."""

    sched: bool = False
    sched_token_budget: int = 2048
    sched_prefill_chunk: int = 256
    sched_slots: int = 0


@dataclass
class ObsSettings:
    """The reference's observability settings, trimmed to the scheduler's
    tick flight-recorder ring capacity (sched/flight.py, GET
    /v1/debug/sched); 0 disables capture."""

    tick_records: int = 256


def kv_settings() -> KVSettings:
    return _from_env(KVSettings, "DNET_KV_")


def api_settings() -> ApiSettings:
    return _from_env(ApiSettings, "DNET_API_")


def shard_settings() -> ShardSettings:
    return _from_env(ShardSettings, "DNET_SHARD_")


def transport_settings() -> TransportSettings:
    return _from_env(TransportSettings, "DNET_TRANSPORT_")


def wire_settings() -> WireSettings:
    return _from_env(WireSettings, "DNET_WIRE_")


def compute_settings() -> ComputeSettings:
    return _from_env(ComputeSettings, "DNET_COMPUTE_")


def mesh_settings() -> MeshSettings:
    return _from_env(MeshSettings, "DNET_MESH_")


def admission_settings() -> AdmissionSettings:
    return _from_env(AdmissionSettings, "DNET_")


def obs_settings() -> ObsSettings:
    return _from_env(ObsSettings, "DNET_OBS_")


def sched_settings() -> SchedSettings:
    return _from_env(SchedSettings, "DNET_")


def sched_enabled() -> bool:
    return sched_settings().sched


def batch_slots_default(cli_value: Optional[int] = None) -> int:
    """--batch-slots when given, else DNET_API_BATCH_SLOTS (default 1)."""
    return int(cli_value) if cli_value else api_settings().batch_slots
