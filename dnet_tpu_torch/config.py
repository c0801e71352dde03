"""Settings the port reads from the environment, under the reference's names.

Counterpart of dnet_tpu/config.py, trimmed to what the port's paths read:
`KVSettings` (DNET_KV_BITS, DNET_KV_PAGED, DNET_KV_RAGGED,
DNET_KV_BLOCK_TOKENS, DNET_KV_POOL_BLOCKS), `ApiSettings` (DNET_API_*: the
API node's host, ports, timeout, admission, models dir, max_seq_len,
param dtype and batch slots, which its CLI takes as defaults; the ring's
auto steps, lanes and callback address; the weight quantization and its
group; and the prefix cache, speculation and draft model, which a ring
ships to its shards),
`AdmissionSettings` (DNET_ADMIT_QUEUE_DEPTH, DNET_ADMIT_QUEUE_TIMEOUT_S,
DNET_REQUEST_DEADLINE_S, DNET_DRAIN_DEADLINE_S: the bounded admission
queue, the default request deadline and the shutdown drain),
`ShardSettings` (DNET_SHARD_*: a shard's CLI defaults, the weight
streaming repack cache's directory, `repack_dir`, and the mesh axes
`mesh_tp` / `mesh_sp`, read to refuse a mesh), `TpSettings` (DNET_TP,
read to refuse tensor parallelism; DNET_TP_COLLECTIVE, unread), the ring's
`TransportSettings` (DNET_TRANSPORT_*), `WireSettings`
(DNET_WIRE_*: the hop codec), `ComputeSettings` (DNET_COMPUTE_MOE_IMPL,
DNET_COMPUTE_MOE_CAPACITY_FACTOR), `MeshSettings` (DNET_MESH_PP/TP/DP/SP:
the API node's --mesh default; the multi-host BACKEND, COORDINATOR,
NUM_PROCESSES and PROCESS_ID are read only to refuse values other than
their defaults), `SchedSettings` (DNET_SCHED, DNET_SCHED_TOKEN_BUDGET,
DNET_SCHED_PREFILL_CHUNK, DNET_SCHED_SLOTS: the iteration-level scheduler)
`ObsSettings` (DNET_OBS_*: the observability group, the scheduler's
tick ring among it), and the ring's failure handling: `ResilienceSettings`
(DNET_RESILIENCE_*: transparent resume and the retry policy),
`MembershipSettings` (DNET_REJOIN, DNET_REJOIN_STABLE_S,
DNET_RECOVERY_MAX_ROUNDS), `ChaosSettings` (DNET_CHAOS, DNET_CHAOS_SEED)
and `TopologySettings` (DNET_TOPOLOGY_*: the solver behind
/v1/prepare_topology).
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
    # >0 = a prefix cache of that many entries (core/prefix_cache.py; under
    # a mesh each stage's and rank's snapshot on its own device)
    prefix_cache: int = 0
    # >0 = speculative decoding with that many drafted tokens, and a draft
    # model's checkpoint for it (core/spec.py; under a mesh prompt lookup
    # drafts and the draft model is not read, as in the reference)
    spec_lookahead: int = 0
    draft_model: str = ""
    # decode grants on a ring: tokens the tail may feed straight back to
    # the head without an API round trip (0 = every step from the API)
    ring_auto_steps: int = 16
    # batched lanes on a ring: every shard pools this many KV rows (0 / 1 =
    # off; the ring manager ships it where the topology and model allow,
    # and the shards refuse it until ring lanes are ported)
    ring_lanes: int = 0
    # host:port the shards dial for token callbacks ("" = the interface
    # facing each load's shards, resolved at load)
    callback_addr: str = ""
    # ring failure monitor (api/failure.py): seconds between gRPC health
    # probes of every shard, and consecutive failed probes that mark a
    # shard down
    health_interval_s: float = 5.0
    health_fail_threshold: int = 3


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
    # a mesh-backed shard's axes, taken when a load body gives 0 (tp=1/sp=1
    # = one device; tp=-1 = every local device): anything else is refused
    # at load until mesh-backed shards are ported
    mesh_tp: int = 1
    mesh_sp: int = 1


@dataclass
class TpSettings:
    """Intra-shard tensor parallelism (DNET_TP, DNET_TP_COLLECTIVE), the
    reference's group: the degree a shard loaded with tp_degree 0 takes (1
    = off) and the collectives' wire format (auto | lossless | q8).  A
    degree above 1 is refused at load until tensor parallelism is ported;
    nothing reads `tp_collective` until then."""

    tp: int = 1
    tp_collective: str = "auto"


@dataclass
class TransportSettings:
    """The ring's hidden-state hops (DNET_TRANSPORT_*): the older sparse_v1
    column compression, the idle-stream sweep and the pause after a
    backpressure ACK.  Retries follow resilience/policy.py
    (DNET_RESILIENCE_RETRY_*)."""

    compress: bool = False
    compress_pct: float = 0.5
    compress_quant_bits: int = 0
    stream_idle_sweep_s: float = 30.0
    stream_backoff_s: float = 0.25


@dataclass
class WireSettings:
    """The hop codec (DNET_WIRE_*).  `codec`: auto (qsparse8 for hops that
    cross hosts, lossless otherwise), lossless or qsparse8; `qsparse_pct`
    is the fraction of columns qsparse8 drops and `group_size` its quant
    group.  `pipeline` (DNET_WIRE_PIPELINE=1) overlaps the hop codec's
    readback and byte packing with the next step (transport/
    wire_pipeline.py), `depth` bounding the encodes launched but not yet
    sent (and the frames decoded ahead at ingress)."""

    pipeline: bool = False
    codec: str = "auto"
    qsparse_pct: float = 0.5
    group_size: int = 64
    depth: int = 2


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
    """Bounded admission, load shedding, end-to-end deadlines and drain
    (admission/controller.py), under the reference's names: at most
    `admit_queue_depth` requests wait beyond the executing set
    (DNET_API_MAX_CONCURRENT_REQUESTS) and the rest shed at once with 429
    + Retry-After; a queued request sheds after `admit_queue_timeout_s`;
    `request_deadline_s` is the default end-to-end deadline (0 disables; a
    request's own `deadline_s` overrides it); on SIGTERM / SIGINT the
    server drains, giving in-flight requests `drain_deadline_s`."""

    admit_queue_depth: int = 32
    admit_queue_timeout_s: float = 10.0
    request_deadline_s: float = 0.0
    drain_deadline_s: float = 30.0


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
    """Observability (DNET_OBS_*), the reference's group.  `enabled` turns
    on the `[PROFILE]` log lines and the device fences that make phase
    timings true (a `torch.cuda.synchronize` of the engine's device at each
    phase boundary, obs/jit.py `fence`); with it off the served path gains
    no synchronisation.  `sync_per_layer` fences every layer of a forward
    (dnet_layer_compute_ms), `sync_every_n` every Nth decode step
    (`sync_stride`).  SLO targets over a rolling window (obs/slo.py; 0
    disables a target), the flight recorder's sampling (`trace_sample`:
    every Nth request keeps its full span stream), the trace export's
    default window and event cap, the scheduler's tick ring
    (`tick_records`; 0 disables capture), the wide-event ring and its
    optional JSONL sink, and the per-shard timeout of /v1/cluster/metrics."""

    enabled: bool = False
    sync_per_layer: bool = False
    sync_every_n: int = 0
    slo_window_s: float = 300.0
    slo_ttft_p95_ms: float = 0.0
    slo_decode_p95_ms: float = 0.0
    slo_availability: float = 0.0
    cluster_scrape_timeout_s: float = 5.0
    trace_sample: int = 1
    trace_window_s: float = 120.0
    trace_max_events: int = 50000
    tick_records: int = 256
    events_records: int = 2048
    events_path: str = ""

    def sync_stride(self) -> int:
        """Decode-step fence cadence: 0 = never, N >= 1 = every N steps
        (negative values clamp to never)."""
        return max(int(self.sync_every_n), 0)


@dataclass
class ResilienceSettings:
    """Request survival (DNET_RESILIENCE_*), the reference's group: `resume`
    turns a mid-decode shard failure into checkpoint -> wait for recovery
    -> replay prefill on the same client stream (resilience/checkpoint.py),
    each attempt waiting at most `resume_deadline_s` for the ring and at
    most `max_resumes` a request; the retry knobs set the base policy of
    every RPC class (resilience/policy.py), and a nonzero
    `retry_jitter_seed` makes the backoff reproducible."""

    resume: bool = False
    resume_deadline_s: float = 30.0
    max_resumes: int = 2
    retry_attempts: int = 3
    retry_base_s: float = 0.05
    retry_max_s: float = 2.0
    retry_jitter_seed: int = 0


@dataclass
class MembershipSettings:
    """Elastic ring membership (membership/, api/failure.py): with `rejoin`
    a quarantined shard that probes green for `rejoin_stable_s` seconds is
    re-profiled, re-solved and delta-reloaded back into the ring;
    `recovery_max_rounds` bounds the re-solve rounds of one failure
    burst."""

    rejoin: bool = False
    rejoin_stable_s: float = 15.0
    recovery_max_rounds: int = 3


@dataclass
class ChaosSettings:
    """Seeded fault injection (resilience/chaos.py): DNET_CHAOS is a
    comma-separated list of `point:kind:param` specs, DNET_CHAOS_SEED the
    seed of every point's RNG."""

    chaos: str = ""
    chaos_seed: int = 0


@dataclass
class TopologySettings:
    """The solver behind /v1/prepare_topology (parallel/solver.py):
    `solver` auto | greedy | milp and the MILP's relative gap."""

    solver: str = "auto"
    mip_gap: float = 1e-4


def kv_settings() -> KVSettings:
    return _from_env(KVSettings, "DNET_KV_")


def api_settings() -> ApiSettings:
    return _from_env(ApiSettings, "DNET_API_")


def shard_settings() -> ShardSettings:
    return _from_env(ShardSettings, "DNET_SHARD_")


def tp_settings() -> TpSettings:
    return _from_env(TpSettings, "DNET_")


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


def resilience_settings() -> ResilienceSettings:
    return _from_env(ResilienceSettings, "DNET_RESILIENCE_")


def membership_settings() -> MembershipSettings:
    return _from_env(MembershipSettings, "DNET_")


def chaos_settings() -> ChaosSettings:
    return _from_env(ChaosSettings, "DNET_")


def topology_settings() -> TopologySettings:
    return _from_env(TopologySettings, "DNET_TOPOLOGY_")


def env_flag(name: str, default: bool = False) -> bool:
    """A boolean read straight from the process environment (DNET_PROFILE,
    the legacy profile switch): unset or empty gives `default`."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return _parse_bool(raw)
    except ValueError as exc:
        raise ValueError(f"bad value for {name}: {exc}") from exc


def sched_enabled() -> bool:
    return sched_settings().sched


def batch_slots_default(cli_value: Optional[int] = None) -> int:
    """--batch-slots when given, else DNET_API_BATCH_SLOTS (default 1)."""
    return int(cli_value) if cli_value else api_settings().batch_slots
