"""Declared label sets for the performance-attribution metric families.

Counterpart of dnet_tpu/obs/phases.py: a LEAF module (like
admission/reasons.py) that `dnet_tpu_torch.obs` imports to pre-touch every
labeled series.  Two differences from the reference: `KERNEL_SOURCES` (the
CUDA sources whose builds `dnet_jit_compiles_total{fn}` counts) stands in
for JIT_FNS, and the label sets of subsystems the port does not have yet
(membership, chaos, the runtime sanitizer, the fleet) are declared here,
with the reference's values, so that their families are exposed at zero as
on a reference node that never uses them.
"""

from __future__ import annotations

# Sub-phases of one batched decode dispatch (core/batch.py decode_batch):
#   kv_gather  — page-table gather building the contiguous per-slot KV view
#                (the dense-gather paged path only; the ragged kernel has none)
#   compute    — the dispatch's forward steps, on-device sampling included
#   kv_scatter — block write-back of the rows the steps touched (gather only)
#   sample     — the one device-to-host read of the sampled token fields
PHASE_KV_GATHER = "kv_gather"
PHASE_COMPUTE = "compute"
PHASE_KV_SCATTER = "kv_scatter"
PHASE_SAMPLE = "sample"
STEP_PHASES = (PHASE_KV_GATHER, PHASE_COMPUTE, PHASE_KV_SCATTER, PHASE_SAMPLE)

# The `fn` label of dnet_jit_compiles_total.  The port has no jax.jit: its
# one compile step is the build (or cached load) of a CUDA source at its
# first use in the process (kernels/build.py `load`), so the label set is
# the stems of the CUDA sources under csrc/ (kernels/build.py SOURCES), in
# place of the reference's jitted entry points (JIT_FNS there).
KERNEL_SOURCES = ("flash_prefill", "flash_decode", "paged_attention", "column_ops")

# dnet_request_segment_ms{segment=}: the exhaustive, non-overlapping
# critical-path segment ledger one request's recorded spans decompose into
# (obs/critical_path.py).  Every wall-clock millisecond between admission
# and the closing request span is attributed to EXACTLY one segment, so the
# per-request sums reconcile against measured E2E and the histogram's
# per-segment totals explain a serving window's p99 without hand-joining
# span families.
#   admission_wait  — queued at the admission gate before a slot opened
#   sched_queue     — admitted but waiting on a scheduler/lane grant
#   prefill_compute — prompt prefill (local engine or replayed prefix)
#   decode_compute  — driver decode-step residual not claimed by a more
#                     specific segment below
#   wire_encode     — activation codec encode on the wire path
#   wire_tx         — writing frames to outbound streams
#   hop_rtt         — in-flight between nodes (send..ingress gap)
#   shard_compute   — shard-side layer compute
#   sample          — on-device sampling + token readback
#   sse_flush       — serializing/flushing SSE chunks to the client
#   other           — recorded wall clock no span claims (gaps)
SEG_ADMISSION_WAIT = "admission_wait"
SEG_SCHED_QUEUE = "sched_queue"
SEG_PREFILL_COMPUTE = "prefill_compute"
SEG_DECODE_COMPUTE = "decode_compute"
SEG_WIRE_ENCODE = "wire_encode"
SEG_WIRE_TX = "wire_tx"
SEG_HOP_RTT = "hop_rtt"
SEG_SHARD_COMPUTE = "shard_compute"
SEG_SAMPLE = "sample"
SEG_SSE_FLUSH = "sse_flush"
SEG_OTHER = "other"
REQUEST_SEGMENTS = (
    SEG_ADMISSION_WAIT,
    SEG_SCHED_QUEUE,
    SEG_PREFILL_COMPUTE,
    SEG_DECODE_COMPUTE,
    SEG_WIRE_ENCODE,
    SEG_WIRE_TX,
    SEG_HOP_RTT,
    SEG_SHARD_COMPUTE,
    SEG_SAMPLE,
    SEG_SSE_FLUSH,
    SEG_OTHER,
)

# dnet_wire_bytes_total{dir=}: activation/token payload bytes by wire
# direction (tx = written to outbound streams, rx = admitted at ingress).
WIRE_DIRS = ("tx", "rx")

# dnet_device_mem_bytes{kind=}: the CUDA allocator's bytes (in_use, peak)
# and the cards' memory (limit), summed over the cards this process used
# (obs/jit.py; the CPU reports none)
DEVICE_MEM_KINDS = ("in_use", "peak", "limit")

# dnet_tp_collective_ms{op=} / dnet_tp_collective_bytes_total{op=}: the two
# intra-shard tensor-parallel collective shapes of the reference's TP seam
# (not ported: exposed at zero).
TP_OPS = ("all_reduce", "all_gather")

# dnet_events_total{name=}: the canonical wide-event vocabulary
# (obs/events.py log_event).  Every structured event a node journals uses
# one of these names (log_event asserts it), so an event cannot ship
# without its counter series.
#   request_complete — EXACTLY one per finished request (any outcome):
#                      status, shed/finish reason, token counts, resolved
#                      codec/kv/tp modes, and the critical-path segment
#                      ledger embedded
#   admitted         — admission granted a slot (queue wait attached)
#   shed             — admission rejected the request (reason attached)
#   preempted        — scheduler evicted a running sequence to WAITING
#   resumed          — a mid-decode failure was transparently replayed
#   recovery_round   — one auto-recovery re-solve round ended (outcome)
#   epoch_fenced     — a stale-epoch message was fenced out (kind)
#   routed           — the fleet front door chose a replica for a request
#                      (replica + routing reason attached — fleet/router.py)
#   failover         — in-flight work moved from a dead replica to a
#                      survivor mid-stream (victim/survivor attached)
EVENT_REQUEST_COMPLETE = "request_complete"
EVENT_ADMITTED = "admitted"
EVENT_SHED = "shed"
EVENT_PREEMPTED = "preempted"
EVENT_RESUMED = "resumed"
EVENT_RECOVERY_ROUND = "recovery_round"
EVENT_EPOCH_FENCED = "epoch_fenced"
EVENT_ROUTED = "routed"
EVENT_FAILOVER = "failover"
EVENT_NAMES = (
    EVENT_REQUEST_COMPLETE,
    EVENT_ADMITTED,
    EVENT_SHED,
    EVENT_PREEMPTED,
    EVENT_RESUMED,
    EVENT_RECOVERY_ROUND,
    EVENT_EPOCH_FENCED,
    EVENT_ROUTED,
    EVENT_FAILOVER,
)

# Label sets of families whose subsystems are not ported; the values are
# the reference's (analysis/runtime/domains.py, fleet/states.py), so the
# exposition matches.
RUNTIME_CHECK_CODES = ("DS001", "DS002", "DS003", "DS004", "DS005", "DS006")
ZOMBIE_THREAD_KINDS = ("shard-compute", "tui")
REPLICA_STATES = ("active", "draining", "quarantined", "dead")
ROUTE_REASONS = ("affinity", "least_loaded", "failover")
