"""Model lifecycle on the API node: builds the engine + tokenizer.

Counterpart of dnet_tpu/api/model_manager.py (its local branches):
`batch_slots == 1` serves a single-sequence `LocalEngine` behind a
`LocalAdapter` (with DNET_KV_PAGED=1, its paged admission ledger:
exhaustion answers 429); `batch_slots > 1` a continuously batched
`BatchedEngine` for every family (dense slots; with DNET_KV_PAGED=1 a paged
pool decoded through the dense gather, or in place with DNET_KV_RAGGED=1
where the ragged kernel takes the model and cache; dense slots where the
pool cannot be used) behind a `BatchedLocalAdapter`, or behind the iteration-level scheduler's
`SchedulerAdapter` (sched/) with DNET_SCHED=1, which widens a load to
DNET_SCHED_SLOTS or max(batch_slots, 8) slots, as the reference's manager
does; DNET_API_PREFIX_CACHE gives paged slots a prefix cache; a mesh
(--mesh or DNET_MESH_*) with sp > 1 a sequence-parallel `MeshEngine` (parallel/engine.py) behind a
`LocalAdapter`, its ranks on `mesh_devices` when the caller names them
(else one CUDA card per rank, or the CPU under device 'cpu').  `kv_bits` (DNET_KV_BITS: 0, 16, 8 or 4)
picks the KV cache's form for every engine, and DNET_API_WEIGHT_QUANT_BITS
(8 / 4, groups of DNET_API_WEIGHT_QUANT_GROUP) its weights' form; a model
id `<id>:int8` / `<id>:int4` (api/catalog.py `split_variant`) loads the
base checkpoint at those bits (`<id>:bf16` at none), with the bits'
default group unless one is set.  What is not ported is
refused at load with `EngineCapabilityError` (HTTP 422), the setting named,
instead of being dropped:
the single-sequence and the dense-slot prefix caches (DNET_API_PREFIX_CACHE
with batch_slots 1, or on dense batched slots, also where a paged pool
falls back to them: core/batch.py), speculative decoding
(DNET_API_SPEC_LOOKAHEAD), the draft model (DNET_API_DRAFT_MODEL), and
under a mesh: --batch-slots > 1 and the pp / tp / dp axes.  A
model id is a filesystem path or a subdirectory of `models_dir` (repo id
slashes replaced by `--`, HF-cache style); nothing is downloaded.
"""

from __future__ import annotations

import asyncio
import time
from pathlib import Path
from typing import Optional, Sequence, Union

from dnet_tpu_torch.api.catalog import split_variant
from dnet_tpu_torch.api.inference import EngineCapabilityError
from dnet_tpu_torch.api.strategies import BatchedLocalAdapter, LocalAdapter
from dnet_tpu_torch.config import ApiSettings, api_settings, sched_enabled, sched_settings
from dnet_tpu_torch.core.batch import BatchedEngine
from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.core.kvcache import resolve_kv_bits
from dnet_tpu_torch.ops.quant import DEFAULT_GROUP, DEFAULT_GROUP_Q4
from dnet_tpu_torch.parallel.engine import MeshEngine
from dnet_tpu_torch.sched import SchedulerAdapter
from dnet_tpu_torch.utils.logger import get_logger
from dnet_tpu_torch.utils.tokenizer import load_tokenizer

log = get_logger()


def resolve_model_dir(model_id: str, models_dir: Optional[Union[str, Path]] = None) -> Optional[Path]:
    p = Path(model_id).expanduser()
    if p.is_dir() and (p / "config.json").is_file():
        return p
    if models_dir:
        base = Path(models_dir).expanduser()
        for cand in (base / model_id, base / model_id.replace("/", "--"), base / model_id.split("/")[-1]):
            if cand.is_dir() and (cand / "config.json").is_file():
                return cand
    return None


def weight_quant(model_id: str, settings: ApiSettings) -> tuple:
    """(base model id, weight_quant_bits, weight_quant_group) of a load: a
    `:int8` / `:int4` / `:bf16` variant overrides DNET_API_WEIGHT_QUANT_BITS
    and takes its bits' default group unless DNET_API_WEIGHT_QUANT_GROUP
    is set, as the reference's manager resolves it."""
    base_id, variant_bits = split_variant(model_id)
    bits = settings.weight_quant_bits if variant_bits is None else variant_bits
    group = settings.weight_quant_group
    if variant_bits:
        group = group or (DEFAULT_GROUP_Q4 if variant_bits == 4 else DEFAULT_GROUP)
    return base_id, bits, group


def active_mesh(mesh: Optional[dict]) -> Optional[dict]:
    """The mesh when it asks for one, as the reference's manager decides:
    any axis above 1, or an explicit pp above 1; else None (single device)."""
    if mesh and (any(v > 1 for v in mesh.values()) or mesh.get("pp", 0) > 1):
        return mesh
    return None


def refuse_unported(settings: ApiSettings, batch_slots: int, mesh: Optional[dict] = None) -> None:
    """Raise EngineCapabilityError for the first setting that changes what
    the reference serves and that the port does not serve yet (ROADMAP A4;
    the mesh's own axes and its family: parallel/engine.py check_mesh; a
    prefix cache on dense batched slots: core/batch.py).  `batch_slots` is
    the load's, widened by the scheduler where it serves."""
    refused = [
        (mesh is not None and batch_slots > 1,
         f"--batch-slots {batch_slots} with mesh {mesh}: continuous batching on the mesh engine is not ported"),
        (settings.prefix_cache > 0 and batch_slots <= 1,
         f"DNET_API_PREFIX_CACHE={settings.prefix_cache}: the single-sequence prefix cache is not ported"),
        (settings.spec_lookahead > 0,
         f"DNET_API_SPEC_LOOKAHEAD={settings.spec_lookahead}: speculative decoding is not ported"),
        (bool(settings.draft_model),
         f"DNET_API_DRAFT_MODEL={settings.draft_model!r}: draft-model speculation is not ported"),
    ]
    for cond, why in refused:
        if cond:
            raise EngineCapabilityError(f"{why}; unset it to serve")


class LocalModelManager:
    """Owns the engine + tokenizer for single-process serving."""

    def __init__(
        self,
        inference_manager,
        models_dir: Optional[str] = None,
        max_seq: int = 4096,
        param_dtype: str = "bfloat16",
        device: Optional[str] = None,
        batch_slots: int = 1,
        kv_bits: int = 0,
        mesh: Optional[dict] = None,
        mesh_devices: Optional[Sequence[str]] = None,
    ) -> None:
        self.inference = inference_manager
        self.models_dir = models_dir
        self.max_seq = max_seq
        self.param_dtype = param_dtype
        self.device = device
        self.batch_slots = batch_slots
        self.kv_bits = kv_bits
        self.mesh = active_mesh(mesh)
        self.mesh_devices = mesh_devices
        self.engine: Optional[Union[LocalEngine, BatchedEngine, MeshEngine]] = None

    @property
    def current_model_id(self) -> Optional[str]:
        return self.inference.model_id

    async def load_model(self, model_id: str, max_seq: Optional[int] = None) -> float:
        """Returns the load time in seconds; raises on failure.  A
        `<id>:int8` / `<id>:int4` variant loads the base checkpoint with
        weight-only quantization (`weight_quant`)."""
        settings = api_settings()
        base_id, wq_bits, wq_group = weight_quant(model_id, settings)
        model_dir = resolve_model_dir(base_id, self.models_dir)
        if model_dir is None:
            raise FileNotFoundError(f"model {model_id!r} not found locally (models_dir={self.models_dir})")
        # DNET_SCHED=1 without a mesh: the scheduler serves a batched
        # engine, so a single-sequence load widens (under a mesh the
        # reference serves the mesh engine whatever DNET_SCHED says)
        sched_on = sched_enabled() and self.mesh is None
        batch_slots = self.batch_slots
        if sched_on:
            batch_slots = sched_settings().sched_slots or max(self.batch_slots, 8)
        refuse_unported(settings, batch_slots, self.mesh)
        try:
            kv_dtype, kv_quant_bits = resolve_kv_bits(self.kv_bits)
        except NotImplementedError as exc:
            raise EngineCapabilityError(str(exc)) from None
        t0 = time.perf_counter()
        kwargs = dict(max_seq=max_seq or self.max_seq, param_dtype=self.param_dtype, device=self.device,
                      kv_dtype=kv_dtype, kv_quant_bits=kv_quant_bits, weight_quant_bits=wq_bits,
                      weight_quant_group=wq_group)

        def _build():
            if self.mesh is not None:
                engine = MeshEngine(
                    model_dir, sp=self.mesh.get("sp", 1), pp=self.mesh.get("pp", 0), tp=self.mesh.get("tp", 1),
                    dp=self.mesh.get("dp", 1), devices=self.mesh_devices, **kwargs,
                )
            elif batch_slots > 1:
                engine = BatchedEngine(
                    model_dir, slots=batch_slots,
                    prefix_cache_size=settings.prefix_cache, **kwargs,
                )
            else:
                engine = LocalEngine(model_dir, **kwargs)
            return engine, load_tokenizer(model_dir)

        engine, tokenizer = await asyncio.get_running_loop().run_in_executor(None, _build)
        old_adapter = self.inference.adapter
        if sched_on:
            adapter = SchedulerAdapter(engine)
        elif isinstance(engine, BatchedEngine):
            adapter = BatchedLocalAdapter(engine)
        else:
            adapter = LocalAdapter(engine)
        await adapter.start()
        self.inference.adapter = adapter
        self.inference.tokenizer = tokenizer
        self.inference.model_id = model_id
        self.engine = engine
        if old_adapter is not None:
            await old_adapter.shutdown()
        dt = time.perf_counter() - t0
        log.info("loaded model %s from %s in %.1fs", model_id, model_dir, dt)
        return dt
