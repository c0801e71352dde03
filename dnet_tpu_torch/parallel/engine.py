"""MeshEngine: one model served over a pp x sp mesh of ranks: its layers in
pipeline stages, each stage's KV cache sharded over sequence-parallel
ranks.

Counterpart of dnet_tpu/parallel/engine.py `MeshEngine` on its pp and sp
axes.  The reference compiles the per-token program over a JAX mesh; the
port keeps one controller (parallel/ring.py `StagePlan`): stage r holds the
layers the reference's rank r holds, its weights on its first device, and
a token's hidden state visits the stages in the reference's order, one
`.to(device)` a hop; within a stage each sp rank holds max_seq / sp KV
slots on its own device, and each layer's attention runs per rank and
merges with one log-sum-exp combine (ops/ring_attention.py).  A decode row
goes through the decode kernel on each stage (its LSE form on every rank
under sp, over the cache's own codes when DNET_KV_BITS is 8 / 4); a prompt
chunk or a verify block through the prefill kernel at sp = 1 and the dense
sp attention under sp, as in the reference.  The embedding, the final norm
and the LM head run on stage 0's first device (the home), where the
sampler and the sessions' state live.  Every family serves: the families
whose models take an sp group (`supports_sp`) under sp, and each stage
builds its cache in its model's layout (`init_kv`, or `init_kv_sp` under
sp: gpt_oss's paired cache with both halves flat, as the reference's
`rotating=(sp == 1)`; deepseek_v2's asymmetric MLA cache).

It keeps LocalEngine's session surface (new_session, prefill,
decode_step, prefill_and_sample, the chunked decode, decode_spec, generate,
hidden_states, token_result), which the serving adapter calls unchanged:
the class is a LocalEngine whose `_layers` is the stage walk and whose
`_init_kv` builds a session's cache stage by stage.  So the prefix cache
(`prefix_cache_size`) keeps each snapshot's every stage and rank on its
own device and restores it there (core/prefix_cache.py clones in place),
and speculation (`spec_lookahead`) drafts by prompt lookup and runs one
[tok, drafts] verify block through the stages (core/spec.py
`make_spec_step` over the walk, the reference's `make_ring_spec_fn`); a
draft model never serves under a mesh, as in the reference.

pp = 0 ("infer") takes the devices the caller names, else the cards there
are, over sp, and walks down to a divisor of a flat stack's layers (the
reference's rule); a flat stack that pp does not divide raises the
reference's ValueError.  Not ported, and refused with
EngineCapabilityError (HTTP 422) before any weight loads: tp > 1, dp > 1,
and sp > 1 for a family without `supports_sp`.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Union

import torch

from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.models import ModelConfig, get_ring_model_cls
from dnet_tpu_torch.parallel.mesh import device_count, rank_devices
from dnet_tpu_torch.parallel.ring import StagePlan, resolve_pp
from dnet_tpu_torch.utils.checkpoint import Checkpoint
from dnet_tpu_torch.utils.device import resolve_device
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()


def check_mesh(config: ModelConfig, pp: int, tp: int, dp: int, sp: int, max_seq: int) -> None:
    """Raise EngineCapabilityError for a mesh the port does not serve yet
    (each message names what is not ported), ValueError when sp does not
    divide max_seq (the reference's check)."""
    from dnet_tpu_torch.api.inference import EngineCapabilityError
    from dnet_tpu_torch.models import _REGISTRY

    ported = sorted(name for name, cls in _REGISTRY.items() if cls.supports_sp)
    refused = [
        (tp > 1, f"mesh tp={tp}: tensor parallelism on the mesh engine is not ported"),
        (dp > 1, f"mesh dp={dp}: data parallelism on the mesh engine is not ported"),
        (sp > 1 and not get_ring_model_cls(config.model_type).supports_sp,
         f"mesh sp={sp} for {config.model_type}: sequence parallelism is ported for {', '.join(ported)} only"),
    ]
    for cond, why in refused:
        if cond:
            raise EngineCapabilityError(why)
    if sp < 1 or max_seq % sp:
        raise ValueError(f"sp={sp} must divide max_seq={max_seq}")


class MeshEngine(LocalEngine):
    """LocalEngine's serving surface over pp pipeline stages of sp
    sequence-parallel ranks each.  Its session, sampling, speculation and
    decode methods are LocalEngine's, which reach the model through the
    ones this class overrides: construction, `_init_kv`, `_layers` and
    `stats`.  It runs no streamed weights, draft model or paged pool
    (kv_pool stays None), so LocalEngine's paths for those stay idle."""

    def __init__(
        self,
        model_dir: Union[str, Path],
        sp: int = 2,
        pp: int = 0,
        tp: int = 1,
        dp: int = 1,
        max_seq: int = 2048,
        param_dtype: str = "bfloat16",
        kv_dtype: Optional[str] = None,
        kv_quant_bits: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
        weight_quant_bits: int = 0,
        weight_quant_group: int = 0,
        prefix_cache_size: int = 0,
        spec_lookahead: int = 0,
    ):
        """`devices`: the ranks' devices, pp x sp of them, stage-major (a
        device may repeat: ranks then share it); by default
        parallel/mesh.py `rank_devices` over `device` (CUDA: one card per
        rank, refused with fewer cards; 'cpu': every rank on the CPU).  Each
        stage's weights (quantized under `weight_quant_bits`, as
        LocalEngine's) live on its first device; the sp ranks split the
        cache, not the weights.  `prefix_cache_size` / `spec_lookahead` as
        LocalEngine's (prompt lookup: no draft model under a mesh)."""
        self.ckpt = Checkpoint(model_dir)
        self.config = ModelConfig.from_hf(self.ckpt.config)
        devs = self._start(pp, tp, dp, sp, max_seq, param_dtype, kv_dtype, kv_quant_bits, device, devices,
                           weight_quant_bits, weight_quant_group, prefix_cache_size, spec_lookahead)
        t0 = time.perf_counter()
        m = self.model
        self._place_stages(m.map_layer(self._on_device(self.ckpt.load_layer_raw(a))) for a in m.layers)
        self.edge_params = self._place_edge(m.map_edge(self._on_device(self.ckpt.load_edge_raw())))
        self.ckpt.close()
        log.info("[PROFILE] loaded %d layers (%s, pp=%d) in %.2fs", len(m.layers), self.config.model_type,
                 self.pp, time.perf_counter() - t0)
        self._mesh_ready(devs)

    @classmethod
    def from_params(
        cls,
        config: ModelConfig,
        window_params: Iterable[dict],
        edge_params: dict,
        *,
        sp: int = 2,
        pp: int = 0,
        tp: int = 1,
        dp: int = 1,
        max_seq: int = 2048,
        param_dtype: str = "bfloat16",
        kv_dtype: Optional[str] = None,
        kv_quant_bits: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
        weight_quant_bits: int = 0,
        weight_quant_group: int = 0,
        prefix_cache_size: int = 0,
        spec_lookahead: int = 0,
    ) -> "MeshEngine":
        """A mesh engine around parameters already in the port's form (one
        dict per layer, in layer order, e.g. from models/convert.py
        `from_jax_params`; a generator places each layer as it comes)."""
        self = cls.__new__(cls)
        self.ckpt = None
        self.config = config
        devs = self._start(pp, tp, dp, sp, max_seq, param_dtype, kv_dtype, kv_quant_bits, device, devices,
                           weight_quant_bits, weight_quant_group, prefix_cache_size, spec_lookahead)
        self._place_stages(window_params)
        self.edge_params = self._place_edge(edge_params)
        self._mesh_ready(devs)
        return self

    def _start(self, pp, tp, dp, sp, max_seq, param_dtype, kv_dtype, kv_quant_bits, device, devices,
               weight_quant_bits, weight_quant_group, prefix_cache_size, spec_lookahead) -> list:
        """Check the mesh (before any weight loads), resolve pp and the
        ranks' devices, and set up LocalEngine's state on the home device
        with the whole model's ring model (the edge ops, the sampler) and
        the stage plan; returns the ranks' devices."""
        check_mesh(self.config, pp, tp, dp, sp, max_seq)
        whole = get_ring_model_cls(self.config.model_type)(self.config, range(self.config.num_hidden_layers),
                                                           torch.device("cpu"))
        named = None if devices is None else [torch.device(d) for d in devices]
        pp = resolve_pp(pp, sp, len(named) if named is not None else device_count(), whole)
        # the first pp x sp of the named devices, as the reference's build_mesh takes them
        devs = named[: pp * sp] if named is not None else rank_devices(pp * sp, device)
        if any(d.type == "cuda" for d in devs) and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass CPU devices to run the mesh's ranks there")
        self.device = resolve_device(devs[0]) if devs else torch.device("cpu")
        self.stages = StagePlan(self.config, whole, pp, sp, devs)
        self.pp, self.sp = pp, sp
        self._setup(max_seq, param_dtype, None, kv_dtype, kv_quant_bits, weight_quant_bits, weight_quant_group)
        self.spec_lookahead = int(spec_lookahead)
        self._init_features(prefix_cache_size, False)
        return devs

    def _place_stages(self, per_layer: Iterable[dict]) -> None:
        """Each layer's params (in layer order, as mapped) placed as
        LocalEngine places them (quantized, cast) on the home device, then
        moved to its stage's device; each run's window stacked by its own
        model."""
        runs = self.stages.runs
        placed: List[list] = [[] for _ in runs]
        for a, p in zip(self.model.layers, per_layer):
            i = self.stages.run_of[a]
            placed[i].append(_move(self._place(p), runs[i].device))
        self.window_params = [run.model.stack_layers(ps) for run, ps in zip(runs, placed)]

    def _mesh_ready(self, devs: list) -> None:
        self.devices = devs
        # /health's bytes of one session's cache, by stage and by rank (set
        # by each new session's cache)
        self.kv_bytes_per_stage = [0] * self.pp
        self.kv_bytes_per_rank = [0] * (self.pp * self.sp)
        self._build_kernels()
        log.info("MeshEngine: %s over pp=%d sp=%d (%s), stages %s, %d KV slots per rank", self.config.model_type,
                 self.pp, self.sp, ", ".join(str(d) for d in devs), self.stages.stage_ranges(),
                 self.max_seq // self.sp)

    def _init_kv(self) -> list:
        """One session's cache: each run's on its stage (under sp a shard of
        max_seq / sp slots per rank), in its model's layout; a one-run plan's
        cache is that run's own (the sp ranks' list)."""
        kv = self.stages.init_kv(self.batch, self.max_seq, self.kv_dtype, self.kv_quant_bits)
        per_rank = self.kv_bytes_per_rank = self.stages.kv_bytes_per_rank(kv)
        self.kv_bytes_per_stage = [sum(per_rank[r * self.sp : (r + 1) * self.sp]) for r in range(self.pp)]
        return kv[0] if len(kv) == 1 else kv

    def _layers(self, x: torch.Tensor, kv, pos, t_real: Optional[int]) -> torch.Tensor:
        """Every layer, stage by stage (parallel/ring.py `StagePlan.walk`);
        x comes back on the home device."""
        kv = [kv] if len(self.stages.runs) == 1 else kv
        return self.stages.walk(self.window_params, x, kv, pos, t_real, self.device)

    def stats(self) -> dict:
        """LocalEngine's /health block (the weights' and the cache's forms,
        the bytes they hold, the prefix cache's and speculation's counters)
        with the mesh: pp, sp, the ranks' devices, each stage's layers (in
        the order they run there), devices, KV bytes and kernel launches
        (by counter, since load), and each rank's KV bytes (stage-major)."""
        out = super().stats()
        out.update(pp=self.pp, sp=self.sp, devices=[str(d) for d in self.devices],
                   kv_bytes_per_rank=list(self.kv_bytes_per_rank), kv_bytes_per_stage=list(self.kv_bytes_per_stage),
                   stages=[{"layers": layers, "devices": [str(d) for d in devs], "kv_bytes": nbytes,
                            "launches": launches}
                           for layers, devs, nbytes, launches in zip(self.stages.stage_ranges(),
                                                                     self.stages.stage_devices,
                                                                     self.kv_bytes_per_stage, self.stages.stage_launches())])
        return out


def _move(tree, device: torch.device):
    """A layer's params (tensors, quantized {"q" | "q4", "s"} dicts) on
    `device`; no copy where they lie there already."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return {k: _move(v, device) for k, v in tree.items()}
