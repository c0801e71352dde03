"""Pipeline parallelism on the single controller: the stage plan of a
pp x sp mesh, and the walk of a token's hidden state through its stages.

Counterpart of dnet_tpu/parallel/ring.py, with no `ppermute`.  The
reference compiles the whole ring into one SPMD program: every pp rank runs
the stage loop, each applies its layers to the hidden state it holds, and
`lax.ppermute` hands it to the next rank over ICI; for one token in flight
the ranks whose turn it is not compute garbage, which a `kv_commit` gate
keeps out of their caches.  Here one controller runs only the stage whose
turn it is, so no garbage is computed and no commit gate is needed: the
hop is the hidden state's `.to(next device)` (no copy when the stages share
a card), and the stages' layers write their own caches in place.

Placement (`stage_layers`): pipeline rank r holds the layers the reference
puts on rank r, in the reference's order.
  - A flat stack (llama, qwen2, qwen3, mixtral, a homogeneous qwen3_moe,
    gpt_oss) is cut into pp contiguous stages of L / pp layers; pp must
    divide L (the reference's ValueError).
  - Two-segment stacks with every dense layer first (deepseek_v2, whose
    `first_k_dense_replace` layers are dense; a qwen3_moe whose
    `mlp_only_layers` are a prefix) run two laps, as the reference's
    `ring_phases = 2` (`phase = i // PP`): each segment is padded to a
    multiple of pp and cut into pp slices, rank r holding slice r of
    both; lap 0 walks the dense slices over the ranks, lap 1 the moe
    slices.  The reference's pad layers are exact residual no-ops: the
    port holds and runs only the real layers.
  - An interleaved qwen3_moe (`decoder_sparse_step`, or `mlp_only_layers`
    that are not a prefix) takes the reference's chunk-aligned stacks
    (`pp_pad_chunks`): rank r holds the contiguous chunk [r * C, (r + 1) * C)
    of the global order, C = ceil(L / pp), the last chunks short or empty.
Each `Run` (one stage's turn in the walk) holds a ring model over its own
layers (models/ `model_cls(config, layers)`, as a ring shard's range), so
gpt_oss's `layer_kinds` are cut with the layers: a stage whose sliding and
full kinds pair keeps the paired layout (its sliding half a W-row ring at
sp = 1), one that does not takes the flat layout.  A run's weights live on
its stage's device, and its cache too (at sp > 1, one shard per rank on
the stage's sp devices, `init_kv_sp`, whose attention runs over them as
ops/ring_attention.py composes it).  Stage r's devices are entries
r * sp .. r * sp + sp - 1 of the mesh's stage-major device list
(parallel/mesh.py).

Every form the reference builds goes through `walk`: a decode row and a
prompt chunk (`_ring_spmd`), the chunked decode under LocalEngine's
dispatch / read contract (`make_ring_chunk_fn`: LocalEngine's loop over
`_forward`), the verify block with every position's logits
(`make_ring_spec_fn`: core/spec.py `make_spec_step` over the walk), and the
final-norm'd hidden states of /v1/embeddings (`make_ring_hidden_fn`).  The
edge ops (embedding, final norm, LM head) run on stage 0's first device,
where the reference's ring returns the hidden state after its last hop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from dnet_tpu_torch.core.engine import tensor_bytes
from dnet_tpu_torch.kernels import scope_counts
from dnet_tpu_torch.kernels.build import launch_scope
from dnet_tpu_torch.models import ModelConfig, get_ring_model_cls
from dnet_tpu_torch.parallel.mesh import SpGroup


def _segments(model) -> Optional[Tuple[List[int], List[int]]]:
    """(dense layers, moe layers) of a two-segment stack, or None for a
    flat one."""
    if not model.segmented_stack:
        return None
    L = model.config.num_hidden_layers
    moe = [a for a in range(L) if model.is_moe_layer(a)]
    dense = [a for a in range(L) if not model.is_moe_layer(a)]
    return dense, moe


def stage_layers(model, pp: int) -> List[Tuple[int, List[int]]]:
    """The walk of the reference's ring at `pp` stages: (rank, layers) in
    the order they run, empty turns left out and a rank's consecutive turns
    joined (at pp = 1, one run of every layer).  `model` is the whole
    model's ring model (its config and layer kinds).  Raises ValueError
    when pp does not divide a flat stack's layers."""
    L = model.config.num_hidden_layers
    segs = _segments(model)
    if segs is None:
        if L % pp:
            raise ValueError(f"pp={pp} must divide num_layers={L}")
        n = L // pp
        walk = [(r, list(range(r * n, (r + 1) * n))) for r in range(pp)]
    elif not segs[0] or not segs[1] or max(segs[0]) < min(segs[1]):
        # two laps: each segment padded to a pp multiple, rank r its slice r
        walk = []
        for seg in segs:
            n = -(-len(seg) // pp)
            walk += [(r, seg[r * n : (r + 1) * n]) for r in range(pp)]
    else:
        # interleaved kinds: chunk-aligned, rank r the global chunk r
        n = -(-L // pp)
        walk = [(r, list(range(r * n, min((r + 1) * n, L)))) for r in range(pp)]
    out: List[Tuple[int, List[int]]] = []
    for r, layers in walk:
        if not layers:
            continue
        if out and out[-1][0] == r and out[-1][1][-1] < layers[0]:
            out[-1] = (r, out[-1][1] + layers)  # consecutive turns of one rank: one run
        else:
            out.append((r, layers))
    return out


def resolve_pp(pp: int, sp: int, n_devices: int, model) -> int:
    """pp as the mesh asks for it; pp <= 0 ("infer") takes the devices left
    over (n_devices // sp, at least 1) and, for a flat stack, walks down to
    a divisor of the layers, as the reference's MeshEngine does."""
    if pp > 0:
        return pp
    pp = max(n_devices // sp, 1)
    L = model.config.num_hidden_layers
    while pp > 1 and L % pp and _segments(model) is None:
        pp -= 1
    return pp


@dataclass
class Run:
    """One stage's turn in the walk: pipeline rank `stage` applies `layers`
    (absolute ids, in layer order) with `model`, a ring model over them on
    the stage's device; `group` is the stage's sp ranks (None at sp = 1)."""

    stage: int
    layers: List[int]
    model: object
    device: torch.device
    group: Optional[SpGroup]


class StagePlan:
    """The stages of a pp x sp mesh over one model: the runs in walk order
    and each stage's devices."""

    def __init__(self, config: ModelConfig, whole, pp: int, sp: int, devices: Sequence[torch.device]):
        """`whole`: the whole model's ring model; `devices`: pp * sp
        devices, stage-major."""
        if len(devices) != pp * sp:
            raise ValueError(f"mesh pp={pp} sp={sp} needs {pp * sp} rank devices, got {len(devices)}")
        self.pp, self.sp = pp, sp
        self.stage_devices = [list(devices[r * sp : (r + 1) * sp]) for r in range(pp)]
        groups = [SpGroup(devs) if sp > 1 else None for devs in self.stage_devices]
        cls = get_ring_model_cls(config.model_type)
        self.runs = [Run(r, layers, cls(config, layers, self.stage_devices[r][0]), self.stage_devices[r][0],
                         groups[r])
                     for r, layers in stage_layers(whole, pp)]
        # each layer's run, for placing its weights as they load
        self.run_of = {a: i for i, run in enumerate(self.runs) for a in run.layers}
        # each stage's kernel launches since the plan was made, by
        # (wrapper, counter): kernels/build.py `launch_scope`
        self.launches: List[dict] = [{} for _ in range(pp)]

    def stage_ranges(self) -> List[List[int]]:
        """Each stage's layers, in the order they run there."""
        out = [[] for _ in range(self.pp)]
        for run in self.runs:
            out[run.stage] += run.layers
        return out

    def init_kv(self, batch: int, max_seq: int, dtype: str, quant_bits: int) -> list:
        """One session's cache: one per run, on its stage's device (under sp
        one shard per rank, each on its own device)."""
        return [run.model.init_kv(len(run.layers), batch, max_seq, dtype, quant_bits) if run.group is None
                else run.model.init_kv_sp(len(run.layers), batch, max_seq, dtype, quant_bits, run.group.devices)
                for run in self.runs]

    def kv_bytes_per_rank(self, kv: list) -> List[int]:
        """Each rank's bytes, stage-major (at sp = 1 a stage's)."""
        out = [0] * (self.pp * self.sp)
        for run, c in zip(self.runs, kv):
            for r, part in enumerate([c] if run.group is None else c):
                out[run.stage * self.sp + r] += tensor_bytes(part)
        return out

    def walk(self, windows: list, x: torch.Tensor, kv: list, pos, t_real: Optional[int],
             home: torch.device) -> torch.Tensor:
        """x [B, T, D] through every run in turn from `pos` (`t_real` of its
        rows real), each run's cache written in place; the hidden state hops
        to each run's device and back to `home`.  Each run's kernel launches
        count on its stage."""
        for run, window, c in zip(self.runs, windows, kv):
            with launch_scope(self.launches[run.stage]):
                x, _ = run.model.apply_window(window, x.to(run.device), c, pos, t_real=t_real, sp=run.group)
        return x.to(home)

    def stage_launches(self) -> List[dict]:
        """Each stage's kernel launches since the plan was made, by kernel."""
        return [scope_counts(acc) for acc in self.launches]
