"""Topology solver: assign transformer layers to devices (HALDA analog).

Counterpart of dnet_tpu/parallel/solver.py, copied whole: the same cost
model, the greedy and the scipy HiGHS MILP solves, the k-round dealing and
the mesh-slice placement, so the same devices and model give the same
`TopologyInfo`.  `model_profile_from_checkpoint` reads the checkpoint's
safetensors headers itself (utils/checkpoint.py `tensor_headers`).  The
port's shards serve the k > 1 rounds it deals (shard/compute.py
`_process_round`) and still refuse at load what they do not serve (a
mesh_tp or tp_degree above 1: shard/compute.py `refuse_unsupported`).

- cost model per device i and layer count w_i, resident n_i:
    t_i(w) = w * t_compute_i                      (memory-bound decode compute)
           + max(0, w - n) * layer_bytes / h2d_i  (host->device streaming,
                                                   bounded by transfer rate)
           + t_comm_i                             (activation hop to next device)
  and the ring's per-token latency is sum_i t_i (sequential pipeline for one
  token) — minimizing the sum subject to full coverage.
- "greedy": proportional-to-speed assignment with memory-aware residency
  (exact for homogeneous devices: equal split, k=1).
- "milp": scipy HiGHS mixed-integer program minimizing total ring latency
  with integer w_i, n_i (heterogeneous clusters).

k > 1 (multi-round rings): when device residency cannot hold a device's
assignment (n_i < w_i), layers are dealt in k contiguous rounds — the
device appears k times per token pass and each visit's weights prefetch
while the rest of the ring computes.  `choose_rounds` picks k;
`deal_rounds` deals the chunks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

from dnet_tpu_torch.core.types import DeviceInfo, LayerAssignment, TopologyInfo
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()


@dataclass
class ModelProfile:
    """Per-model cost inputs (≙ distilp.profile_model)."""

    model_id: str
    num_layers: int
    layer_bytes: int  # parameter bytes per layer (serving dtype)
    layer_flops_per_token: float  # forward FLOPs per token per layer
    kv_bytes_per_token_per_layer: int
    edge_bytes: int = 0  # embed + head + final norm
    seq_len: int = 4096
    # models with paired/segmented window layouts (gpt_oss, deepseek_v2)
    # cannot execute k-round fit stacks yet: fail at SOLVE time, not on the
    # first request (core/engine.py:apply_round raises otherwise)
    multi_round_ok: bool = True
    # KV-head count: mesh-backed shards shard KV heads over tp
    # (parallel/mesh.py kv_spec), so a node's mesh_tp must divide this.
    # 0 = unknown: leave mesh_tp unclamped.
    tp_heads: int = 0
    # bytes of one hidden-state row (hidden_size x serving elem size):
    # what each of the two per-layer TP collectives moves per token.
    # 0 = unknown: TP collective cost is not charged.
    hidden_bytes: int = 0


@dataclass
class SolveResult:
    w: List[int]
    n: List[int]
    k: int = 1
    obj_value: float = 0.0
    solver: str = "greedy"


def device_throughput(d: DeviceInfo, m: ModelProfile) -> float:
    """Per-layer decode time (s): max of FLOP time and HBM-read time.

    chip_count > 1 = a mesh-backed shard (parallel/shard_mesh.py): the ring
    node is a whole host-local slice, so its FLOPs and aggregate HBM
    bandwidth scale with the chips running the window tensor-parallel —
    the solver sees ONE node with the slice's combined speed."""
    c = max(d.chip_count, 1)
    flops_t = m.layer_flops_per_token / max(d.flops_bf16 * c, 1e9)
    hbm_t = m.layer_bytes / max(d.hbm_bw * c, 1e9)
    return max(flops_t, hbm_t)


def hbm_layer_capacity(d: DeviceInfo, m: ModelProfile, reserve_frac: float = 0.15) -> int:
    """How many layers fit in HBM after KV + edge + headroom.  A mesh-backed
    shard (chip_count > 1) pools the slice's HBM: params and KV shard over
    tp, only the edge weights replicate per chip."""
    if d.hbm_bytes <= 0:
        return m.num_layers  # unknown: assume everything fits
    c = max(d.chip_count, 1)
    kv = m.kv_bytes_per_token_per_layer * m.seq_len
    usable = d.hbm_bytes * c * (1 - reserve_frac) - m.edge_bytes * c
    per_layer = m.layer_bytes + kv
    return max(int(usable // per_layer), 0)


def host_layer_capacity(d: DeviceInfo, m: ModelProfile) -> int:
    """Layers whose params fit in host DRAM (offload ceiling)."""
    if d.host_ram_bytes <= 0:
        return m.num_layers
    return max(int((d.host_ram_bytes * 0.8) // m.layer_bytes), 0)


def solve_greedy(devices: List[DeviceInfo], m: ModelProfile) -> SolveResult:
    """Proportional-to-speed with memory-aware residency."""
    L = m.num_layers
    speeds = [1.0 / device_throughput(d, m) for d in devices]
    total = sum(speeds)
    raw = [L * s / total for s in speeds]
    w = [int(math.floor(r)) for r in raw]
    # deal remaining layers by largest fractional part
    rem = L - sum(w)
    order = sorted(range(len(devices)), key=lambda i: raw[i] - w[i], reverse=True)
    for i in order[:rem]:
        w[i] += 1
    # cap by host capacity (a device cannot even stream more than this)
    for i, d in enumerate(devices):
        cap = host_layer_capacity(d, m)
        if w[i] > cap:
            w[i] = cap
    deficit = L - sum(w)
    if deficit > 0:
        # push the overflow to devices with spare host capacity, fastest first
        for i in sorted(range(len(devices)), key=lambda i: speeds[i], reverse=True):
            spare = host_layer_capacity(devices[i], m) - w[i]
            take = min(spare, deficit)
            w[i] += take
            deficit -= take
            if deficit == 0:
                break
        if deficit > 0:
            raise ValueError(
                f"model does not fit: {deficit} layers have no host to live on"
            )
    n = [min(w[i], hbm_layer_capacity(d, m)) for i, d in enumerate(devices)]
    obj = _ring_latency(devices, m, w, n)
    return SolveResult(w=w, n=n, k=1, obj_value=obj, solver="greedy")


def predict_stage_time(d: DeviceInfo, m: ModelProfile, w_i: int, n_i: int) -> float:
    """Predicted per-token seconds for one device's stage: window compute
    (TP speedup is already in device_throughput — FLOPs and HBM bandwidth
    scale with chip_count) MINUS nothing, PLUS what TP costs: two ring
    all-reduces per layer over the hidden row, 2(c-1)/c x hidden_bytes
    per link each (parallel/tp_collectives.py collective_bytes), plus
    host->HBM streaming of non-resident layers.  Excludes the activation
    hop (t_comm) so it is directly comparable to an on-device stage probe
    (parallel/calibrate.py).  Devices with unknown ici_bw (0) charge no
    collective cost — identical predictions to the pre-TP solver."""
    t = w_i * device_throughput(d, m)
    c = max(d.chip_count, 1)
    if c > 1 and d.ici_bw > 0 and m.hidden_bytes > 0:
        per_collective = 2.0 * (c - 1) / c * m.hidden_bytes / d.ici_bw
        t += w_i * 2 * per_collective
    t += max(0, w_i - n_i) * m.layer_bytes / max(d.host_to_hbm_bw, 1e9)
    return t


def _ring_latency(devices, m, w, n) -> float:
    return sum(
        predict_stage_time(d, m, w[i], n[i]) + d.t_comm for i, d in enumerate(devices)
    )


def solve_milp(devices: List[DeviceInfo], m: ModelProfile, mip_gap: float = 1e-4) -> SolveResult:
    """Exact (w, n) via scipy HiGHS MILP.

    Variables per device: w_i (int), n_i (int), s_i >= w_i - n_i (streamed
    layers), plus T = bottleneck stage time.  Objective: minimize T (pipeline
    throughput under multiple in-flight tokens is set by the slowest stage)
    with a small sum-latency tiebreak so homogeneous cases balance exactly.
    Constraints: per-stage time <= T, sum w = L, n_i <= hbm-cap_i,
    n_i <= w_i, w_i <= host-cap_i.
    """
    import numpy as np
    from scipy.optimize import Bounds, LinearConstraint, milp

    D = len(devices)
    L = m.num_layers
    c = np.array([device_throughput(d, m) for d in devices])
    h = np.array(
        [m.layer_bytes / max(d.host_to_hbm_bw, 1e9) for d in devices]
    )
    hbm_cap = np.array([hbm_layer_capacity(d, m) for d in devices])
    host_cap = np.array([host_layer_capacity(d, m) for d in devices])

    # x = [w_0..w_D-1, n_0..n_D-1, s_0..s_D-1, T]
    N = 3 * D + 1
    eps = 1e-3 / max(L, 1)
    cost = np.concatenate([eps * c, np.zeros(D), eps * h, [1.0]])
    integrality = np.concatenate([np.ones(D), np.ones(D), np.zeros(D), [0.0]])
    lb = np.zeros(N)
    ub = np.concatenate([host_cap, hbm_cap, np.full(D, L), [np.inf]])
    constraints = []
    # sum w == L
    a = np.zeros(N)
    a[:D] = 1
    constraints.append(LinearConstraint(a, L, L))
    for i in range(D):
        # n_i - w_i <= 0
        a = np.zeros(N)
        a[D + i] = 1
        a[i] = -1
        constraints.append(LinearConstraint(a, -np.inf, 0))
        # w_i - n_i - s_i <= 0
        a = np.zeros(N)
        a[i] = 1
        a[D + i] = -1
        a[2 * D + i] = -1
        constraints.append(LinearConstraint(a, -np.inf, 0))
        # stage time: w_i*c_i + s_i*h_i - T <= -t_comm_i (comm folded in)
        a = np.zeros(N)
        a[i] = c[i]
        a[2 * D + i] = h[i]
        a[3 * D] = -1
        constraints.append(LinearConstraint(a, -np.inf, -devices[i].t_comm))

    res = milp(
        c=cost,
        constraints=constraints,
        integrality=integrality,
        bounds=Bounds(lb, ub),
        options={"mip_rel_gap": mip_gap},
    )
    if not res.success:
        log.warning("MILP infeasible/failed (%s); falling back to greedy", res.message)
        return solve_greedy(devices, m)
    w = [int(round(v)) for v in res.x[:D]]
    n = [int(round(v)) for v in res.x[D : 2 * D]]
    # MILP maximizes residency implicitly only via streaming cost; pin n to
    # the max that fits (streaming fewer layers never hurts)
    n = [min(w[i], int(hbm_cap[i])) for i in range(D)]
    obj = _ring_latency(devices, m, w, n)
    return SolveResult(w=w, n=n, k=1, obj_value=obj, solver="milp")


def order_devices(devices: List[DeviceInfo]) -> List[DeviceInfo]:
    """Ring ordering: group ICI-adjacent devices so in-slice hops dominate
    (the reference's Thunderbolt-adjacency greedy, api/utils.py:134-193)."""
    if not devices:
        return []
    remaining = list(devices)
    out = [remaining.pop(0)]
    while remaining:
        cur = out[-1]
        nxt_i = 0
        for i, cand in enumerate(remaining):
            if cand.ici_adjacent(cur):
                nxt_i = i
                break
        out.append(remaining.pop(nxt_i))
    return out


def postprocess_merge_singletons(
    devices: List[DeviceInfo], w: List[int], n: List[int], m: ModelProfile
) -> tuple[List[DeviceInfo], List[int], List[int]]:
    """Merge single-layer devices into their lighter neighbor (reference
    postprocess_single_round, api/utils.py:12-59) — a 1-layer stage rarely
    pays for its hop."""
    if len(devices) <= 1:
        return devices, w, n
    while True:
        try:
            i = next(idx for idx, wi in enumerate(w) if wi == 1 and len(w) > 1)
        except StopIteration:
            return devices, w, n
        left = (i - 1) % len(w)
        right = (i + 1) % len(w)
        j = left if w[left] <= w[right] else right
        if j == i:
            return devices, w, n
        w[j] += w[i]
        n[j] = min(w[j], hbm_layer_capacity(devices[j], m))
        del devices[i], w[i], n[i]


def choose_rounds(w: List[int], n: List[int], max_rounds: int = 4) -> int:
    """k for the multi-round ring (reference HALDA's k): when HBM residency
    cannot hold a device's whole assignment (n_i < w_i), dealing the layers
    in k contiguous chunks lets each visit's weights prefetch while the REST
    of the ring computes — the reference's extreme-memory-pressure regime
    (api/utils.py:62-131).  k = 1 when everything is resident."""
    k = 1
    for wi, ni in zip(w, n):
        if 0 < ni < wi:
            k = max(k, math.ceil(wi / ni))
        elif ni == 0 and wi > 0:
            k = max_rounds  # fully streamed device: cap
    return min(k, max_rounds)


def deal_rounds(w: List[int], k: int) -> List[List[List[int]]]:
    """Deal each device's w_i layers into k contiguous chunks, iterating
    rounds-outer/devices-inner so global layer order follows the ring k
    times (reference compute_layer_assignments, api/utils.py:62-131).
    Returns per-device round lists."""
    rounds: List[List[List[int]]] = [[] for _ in w]
    start = 0
    for r in range(k):
        for i, wi in enumerate(w):
            size = wi // k + (1 if r < wi % k else 0)
            if size:
                rounds[i].append(list(range(start, start + size)))
                start += size
    return rounds


def merge_mesh_slices(
    devices: List[DeviceInfo],
) -> tuple[List[DeviceInfo], dict]:
    """Mesh-slice candidates: ICI-adjacent devices (same host, same slice)
    with a KNOWN interconnect bandwidth collapse into ONE multi-chip
    DeviceInfo — a v5litepod-4 host registered as four 1-chip shards
    becomes one 4-chip mesh slice whose window runs tensor-parallel
    (parallel/tp.py).  Returns (merged device list, {surviving instance:
    [absorbed instances]}); callers adopt the merge only when the solved
    ring latency actually improves (fewer hops + TP speedup vs the new
    collective cost — predict_stage_time models both sides).  Devices
    with ici_bw == 0 never merge: the collective cost would be a guess.
    """
    groups: dict = {}
    order: list = []
    for d in devices:
        key = (d.host, d.slice_id)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(d)
    merged: List[DeviceInfo] = []
    members: dict = {}
    from dataclasses import replace as _dc_replace

    for key in order:
        g = groups[key]
        if len(g) < 2 or any(d.ici_bw <= 0 for d in g):
            merged.extend(g)
            continue
        head = _dc_replace(
            g[0],
            chip_count=sum(max(d.chip_count, 1) for d in g),
            # members share one ICI fabric; cost with the slowest link
            ici_bw=min(d.ici_bw for d in g),
        )
        members[head.instance] = [d.instance for d in g[1:]]
        merged.append(head)
    return merged, members


def solve_topology(
    devices: List[DeviceInfo],
    m: ModelProfile,
    kv_bits: int = 0,
    solver: str = "auto",
    mip_gap: float = 1e-4,
    max_rounds: int = 4,
) -> TopologyInfo:
    """Full solve: slice-merge -> order -> (w, n) -> merge -> k rounds ->
    assignments."""
    if not devices:
        raise ValueError("no devices")
    from dataclasses import replace as _dc_replace

    def _clamp_and_solve(devs_in: List[DeviceInfo]):
        # clamp each node's usable chip count BEFORE costing: mesh-backed
        # shards shard KV heads over tp (kv_spec), so a 4-chip host
        # serving a 2-kv-head model runs tp=2 — sizing its layer share
        # with 4-chip pooled HBM would overcommit the 2 chips that
        # actually serve
        clamped = []
        chips = {}  # instance -> physical chip count (pre-clamp)
        for d in devs_in:
            chips[d.instance] = max(d.chip_count, 1)
            c = max(d.chip_count, 1)
            while c > 1 and m.tp_heads > 0 and m.tp_heads % c != 0:
                c -= 1
            clamped.append(
                _dc_replace(d, chip_count=c) if c != d.chip_count else d
            )
        ordered = order_devices(clamped)
        heterogeneous = len(
            {(d.chip_kind, d.chip_count, round(d.flops_bf16 / 1e12, 1))
             for d in ordered}
        ) > 1
        use_milp = solver == "milp" or (solver == "auto" and heterogeneous)
        res = (
            solve_milp(ordered, m, mip_gap) if use_milp
            else solve_greedy(ordered, m)
        )
        return ordered, chips, res

    # mesh-slice placement (ROADMAP item 3): when ICI-adjacent devices can
    # pool into one multi-chip hop, solve BOTH layouts and keep the one
    # with the lower predicted ring latency — one 4-chip tp hop beats four
    # 1-chip hops exactly when the interconnect outruns the ring wire
    # (t_comm), which is what the objective compares.
    slice_members: dict = {}
    slice_candidates, candidate_members = merge_mesh_slices(devices)
    devices_ordered, orig_chips, result = _clamp_and_solve(devices)
    if candidate_members:
        base_obj = result.obj_value
        m_devs, m_chips, m_res = _clamp_and_solve(slice_candidates)
        if m_res.obj_value < base_obj:
            devices_ordered, orig_chips, result = m_devs, m_chips, m_res
            slice_members = candidate_members
            log.info(
                "mesh-slice placement: merged %s (ring latency %.4fs -> "
                "%.4fs)", candidate_members, base_obj, m_res.obj_value,
            )
    devices = devices_ordered
    devs = list(devices)
    w, n = list(result.w), list(result.n)
    devs, w, n = postprocess_merge_singletons(devs, w, n, m)

    # drop zero-layer devices
    keep = [i for i in range(len(devs)) if w[i] > 0]
    devs = [devs[i] for i in keep]
    w = [w[i] for i in keep]
    n = [n[i] for i in keep]

    k = 1
    if len(devs) > 1 and m.multi_round_ok:
        k = choose_rounds(w, n, max_rounds)
    per_dev_rounds = deal_rounds(w, k)

    assignments: List[LayerAssignment] = []
    for i, d in enumerate(devs):
        layers = [a for r in per_dev_rounds[i] for a in r]
        window = 0 if n[i] >= w[i] else max(n[i] // 2, 1)
        # multi-chip hosts serve their window tensor-parallel over the local
        # slice (parallel/shard_mesh.py); a streaming window composes — each
        # layer streams in tp/sp-sharded (see the r5 note below).
        # chip_count is already clamped to a KV-head-divisible tp above;
        # chips the clamp left over become a SEQUENCE-parallel axis (KV
        # shards over them) instead of idling — e.g. a 4-chip host serving
        # a 2-kv-head model runs tp=2 x sp=2.  The cost model stays on the
        # clamped count (conservative: sp's KV-capacity win is unmodeled).
        mesh_tp = max(d.chip_count, 1)
        mesh_sp = 1
        spare = orig_chips.get(d.instance, mesh_tp) // mesh_tp
        # largest sp <= spare dividing the sequence (all-or-nothing would
        # idle chips whenever the full spare count doesn't divide)
        for s in range(spare, 1, -1):
            if m.seq_len % s == 0:
                mesh_sp = s
                break
        residency = 0 if n[i] >= w[i] else n[i]
        # streaming COMPOSES with the mesh shard (r5): each window layer
        # streams host->mesh as tp/sp-sharded device_puts, so the window
        # lives in the slice's POOLED HBM — exactly the capacity n[i] was
        # sized against.  No single-chip fallback, no re-derivation.
        # NamedSharding TP (parallel/tp.py): a pure-TP shard — multi-chip,
        # no sp axis, fully resident window — gets an explicit tp_degree
        # that rides the load body into ShardCompute and selects the TP
        # substrate with the quantizable collectives.  sp/streaming combos
        # pin tp_degree=1 and stay on the shard_map mesh substrate.
        tp_degree = mesh_tp if (mesh_sp == 1 and window == 0) else 1
        assignments.append(
            LayerAssignment(
                instance=d.instance,
                layers=layers,
                rounds=per_dev_rounds[i],
                window_size=window,
                residency_size=residency,
                # both axes EXPLICIT (1 = pinned single, never 0 = "shard
                # default"): a shard-side DNET_SHARD_MESH_* env must not
                # override a solve that decided against the mesh
                mesh_tp=mesh_tp,
                mesh_sp=mesh_sp,
                tp_degree=tp_degree,
            )
        )
    for i, a in enumerate(assignments):
        a.next_instance = assignments[(i + 1) % len(assignments)].instance
    solution = {
        "k": k,
        "w": w,
        "n": n,
        "obj_value": result.obj_value,
        "solver": result.solver,
        # per-stage predictions recorded at solve time so the
        # calibration loop (parallel/calibrate.py) can compare them
        # against measured probes without re-deriving the model profile
        "predicted_stage_s": [
            predict_stage_time(d, m, w[i], n[i]) for i, d in enumerate(devs)
        ],
        "tp_degree": [a.tp_degree for a in assignments],
    }
    if slice_members:
        # surviving instance -> the ICI-adjacent instances it absorbed
        # (those shards receive no layers; their chips serve inside the
        # surviving shard's mesh slice)
        solution["mesh_slices"] = slice_members
    return TopologyInfo(
        model=m.model_id,
        num_layers=m.num_layers,
        kv_bits=kv_bits,
        devices=devs,
        assignments=assignments,
        solution=solution,
    )


def model_profile_from_checkpoint(
    model_dir,
    seq_len: int = 4096,
    kv_bits: int = 0,
    weight_quant_bits: int = 0,
    quant_group: int = 0,  # 0 = the quantizer's default group size
) -> ModelProfile:
    """Cost model from checkpoint headers (no weight loading)."""
    import json
    import re
    from pathlib import Path

    from dnet_tpu_torch.models.base import ModelConfig
    from dnet_tpu_torch.utils.checkpoint import dtype_size, tensor_headers

    config = json.loads((Path(model_dir) / "config.json").read_text())
    cfg = ModelConfig.from_hf(config)
    headers = tensor_headers(model_dir)

    def nbytes(name: str) -> int:
        shape, dtype = headers[name]
        return math.prod(shape) * dtype_size(dtype)

    layer0 = re.compile(r"^model\.layers\.0\.")
    layer_any = re.compile(r"^model\.layers\.\d+\.")
    layer_bytes = sum(nbytes(n) for n in headers if layer0.match(n))
    if weight_quant_bits in (4, 8):
        # weight-only serving (ops/quant.py): bits/8 bytes per elem +
        # per-group scales, vs the checkpoint's 2-byte elems.  Norm/bias
        # tensors stay float but are a rounding error at layer scale.
        from dnet_tpu_torch.ops.quant import DEFAULT_GROUP, DEFAULT_GROUP_Q4

        group = quant_group or (
            DEFAULT_GROUP_Q4 if weight_quant_bits == 4 else DEFAULT_GROUP
        )
        layer_bytes = int(layer_bytes * (weight_quant_bits / 8 + 2 / group) / 2)
    edge_bytes = sum(nbytes(n) for n in headers if not layer_any.match(n))
    D = cfg.hidden_size
    # decode FLOPs/token/layer ~ 2 * params_per_layer (dense); MoE uses top-k
    params_per_layer = layer_bytes / 2  # serving bf16
    active = params_per_layer
    if cfg.num_local_experts and cfg.num_experts_per_tok:
        active = params_per_layer * (
            cfg.num_experts_per_tok / cfg.num_local_experts
        )
    kvh = cfg.num_key_value_heads
    if kv_bits == 8:  # int8 + per-(pos,head) f32 scale (core/kvcache.py)
        kv_bytes = 2 * kvh * (cfg.head_dim + 4)
    elif kv_bits == 4:  # packed nibbles + f32 scale
        kv_bytes = 2 * kvh * (cfg.head_dim // 2 + 4)
    else:
        kv_bytes = 2 * kvh * cfg.head_dim * 2
    return ModelProfile(
        model_id=str(model_dir),
        tp_heads=cfg.num_key_value_heads or cfg.num_attention_heads or 0,
        hidden_bytes=D * 2,  # serving bf16 activations
        multi_round_ok=cfg.model_type not in ("gpt_oss", "deepseek_v2"),
        num_layers=cfg.num_hidden_layers,
        layer_bytes=layer_bytes,
        layer_flops_per_token=2.0 * active,
        kv_bytes_per_token_per_layer=kv_bytes,
        edge_bytes=edge_bytes,
        seq_len=seq_len,
    )
