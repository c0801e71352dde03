"""MeshEngine: one model served with its KV cache sharded over sequence-
parallel (sp) ranks.

Counterpart of dnet_tpu/parallel/engine.py `MeshEngine` on its sp axis.
The reference compiles the per-token program over a JAX mesh; the port
keeps one controller over an sp group (parallel/mesh.py): the weights and
everything outside attention run once on rank 0's device, each rank holds
max_seq / sp KV slots on its own device, and each layer's attention runs
per rank and merges with one log-sum-exp combine (ops/ring_attention.py).
A decode row goes through the decode kernel's LSE form on every rank (over
the cache's own codes when DNET_KV_BITS is 8 / 4); a prompt chunk through
the dense sp attention, as in the reference.  The families whose models
take an sp group (`supports_sp`: llama and the families derived from it,
qwen2, qwen3, mixtral and qwen3_moe; gpt_oss; deepseek_v2) build their
per-rank caches through their `init_kv_sp` hook: gpt_oss's paired cache
with both halves flat (no ring, as the reference's `rotating=(sp == 1)`),
deepseek_v2's asymmetric MLA cache.

It keeps LocalEngine's session surface (new_session, prefill,
decode_step, prefill_and_sample, the chunked decode, generate,
token_result), which the serving adapter drives unchanged: those drivers
are LocalEngine's own methods, borrowed as the reference borrows them;
only the cache's construction and the forward pass differ.

Not ported, and refused with EngineCapabilityError (HTTP 422) before any
weight loads: pp > 1 (pp = 0, "infer", resolves to 1 here), tp > 1, dp > 1,
and every family without `supports_sp`.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union

import torch

from dnet_tpu_torch.core.engine import LocalEngine, tensor_bytes
from dnet_tpu_torch.models import ModelConfig, get_ring_model_cls
from dnet_tpu_torch.parallel.mesh import SpGroup, rank_devices
from dnet_tpu_torch.utils.checkpoint import Checkpoint
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
        (pp > 1, f"mesh pp={pp}: pipeline parallelism on the mesh engine is not ported"),
        (tp > 1, f"mesh tp={tp}: tensor parallelism on the mesh engine is not ported"),
        (dp > 1, f"mesh dp={dp}: data parallelism on the mesh engine is not ported"),
        (not get_ring_model_cls(config.model_type).supports_sp,
         f"mesh sp={sp} for {config.model_type}: sequence parallelism is ported for {', '.join(ported)} only"),
    ]
    for cond, why in refused:
        if cond:
            raise EngineCapabilityError(why)
    if sp < 1 or max_seq % sp:
        raise ValueError(f"sp={sp} must divide max_seq={max_seq}")


class MeshEngine:
    """LocalEngine's serving surface over R sequence-parallel ranks."""

    batch = 1
    KV_TTL_S = LocalEngine.KV_TTL_S
    DECODE_CHUNK_BUCKETS = LocalEngine.DECODE_CHUNK_BUCKETS
    # the session, sampling and decode drivers are LocalEngine's: they call
    # new_session, _forward and _init_kv, the three this class defines
    _setup = LocalEngine._setup
    _cast = LocalEngine._cast
    _on_device = LocalEngine._on_device
    _place = LocalEngine._place
    _place_edge = LocalEngine._place_edge
    weight_stats = LocalEngine.weight_stats
    _build_kernels = LocalEngine._build_kernels
    new_session = LocalEngine.new_session
    _paged_ensure = LocalEngine._paged_ensure  # no ledger under a mesh (kv_pool stays None)
    _paged_release = LocalEngine._paged_release
    end_session = LocalEngine.end_session
    sweep_sessions = LocalEngine.sweep_sessions
    prefill = LocalEngine.prefill
    _tokens = LocalEngine._tokens
    # no prefix cache, speculation or draft under a mesh (the model
    # manager refuses them: ROADMAP A7.4); prefill and generate ask
    _init_features = LocalEngine._init_features
    _commit_prompt_hist = LocalEngine._commit_prompt_hist
    _advance_draft = LocalEngine._advance_draft
    spec_eligible = LocalEngine.spec_eligible
    _sample_with_counts = LocalEngine._sample_with_counts
    prefill_and_sample = LocalEngine.prefill_and_sample
    decode_step = LocalEngine.decode_step
    decode_chunk_dispatch = LocalEngine.decode_chunk_dispatch
    pending_chunks = LocalEngine.pending_chunks
    pending_width = LocalEngine.pending_width
    decode_chunk_read = LocalEngine.decode_chunk_read
    decode_chunk = LocalEngine.decode_chunk
    generate = LocalEngine.generate
    hidden_states = LocalEngine.hidden_states
    token_result = staticmethod(LocalEngine.token_result)
    close = LocalEngine.close

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
    ):
        """`devices`: the ranks' devices, one per rank (a device may repeat:
        ranks then share it); by default parallel/mesh.py `rank_devices`
        over `device` (CUDA: one card per rank, refused with fewer cards;
        'cpu': every rank on the CPU).  Weights (quantized under
        `weight_quant_bits`, as LocalEngine's) live on the home device: the
        ranks split the cache, not the weights, so every rank reads the same
        codes."""
        config = ModelConfig.from_hf(Checkpoint(model_dir).config)
        group = _group(config, pp, tp, dp, sp, max_seq, device, devices)
        # no paged ledger: mesh caches are sharded, as in the reference
        LocalEngine.__init__(self, model_dir, max_seq=max_seq, param_dtype=param_dtype, device=group.home,
                             kv_dtype=kv_dtype, kv_quant_bits=kv_quant_bits, kv_paged=False,
                             weight_quant_bits=weight_quant_bits, weight_quant_group=weight_quant_group)
        self._mesh_ready(group)

    @classmethod
    def from_params(
        cls,
        config: ModelConfig,
        window_params: List[dict],
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
    ) -> "MeshEngine":
        """A mesh engine around parameters already in the port's form (one
        dict per layer, e.g. from models/convert.py `from_jax_params`)."""
        group = _group(config, pp, tp, dp, sp, max_seq, device, devices)
        self = LocalEngine.from_params.__func__(
            cls, config, window_params, edge_params, max_seq=max_seq, param_dtype=param_dtype,
            device=group.home, kv_dtype=kv_dtype, kv_quant_bits=kv_quant_bits, kv_paged=False,
            weight_quant_bits=weight_quant_bits, weight_quant_group=weight_quant_group,
        )
        self._mesh_ready(group)
        return self

    def _mesh_ready(self, group: SpGroup) -> None:
        self.sp_group = group
        self.sp = group.size
        self.kv_bytes_per_rank = [0] * group.size
        log.info("MeshEngine: %s over sp=%d (%s), %d KV slots per rank", self.config.model_type, self.sp,
                 ", ".join(str(d) for d in group.devices), self.max_seq // self.sp)

    def _init_kv(self) -> list:
        """One session's cache: a shard of max_seq / sp slots per rank, in
        the model's layout (`init_kv_sp`)."""
        kv = self.model.init_kv_sp(len(self.model.layers), self.batch, self.max_seq, self.kv_dtype,
                                   self.kv_quant_bits, self.sp_group.devices)
        self.kv_bytes_per_rank = [tensor_bytes(c) for c in kv]
        return kv

    def _forward(self, tokens: torch.Tensor, kv: list, pos: int, last_idx: int) -> torch.Tensor:
        """LocalEngine._forward with the sp group threaded to the layers."""
        m = self.model
        x = m.embed(self.edge_params, tokens)
        x, _ = m.apply_window(self.window_params, x, kv, pos, t_real=last_idx + 1, sp=self.sp_group)
        x_last = m.normalize(self.edge_params, x[:, last_idx : last_idx + 1])
        return m.lm_project(self.edge_params, x_last)[:, 0]

    def _final_hidden(self, tokens: torch.Tensor, kv: list, t_real: int) -> torch.Tensor:
        """LocalEngine._final_hidden with the sp group threaded to the layers."""
        m = self.model
        x, _ = m.apply_window(self.window_params, m.embed(self.edge_params, tokens), kv, 0, t_real=t_real,
                              sp=self.sp_group)
        return m.normalize(self.edge_params, x)

    def stats(self) -> dict:
        """The weights' and the KV cache's form, the sp ranks' devices, the
        weights' bytes and the bytes one session's cache holds, in all and
        per rank (for /health)."""
        return {"kv_dtype": self.kv_dtype, "kv_quant_bits": self.kv_quant_bits, "kv_bytes": self.kv_bytes,
                "sp": self.sp, "devices": [str(d) for d in self.sp_group.devices],
                "kv_bytes_per_rank": list(self.kv_bytes_per_rank), **self.weight_stats()}


def _group(config, pp, tp, dp, sp, max_seq, device, devices) -> SpGroup:
    """Check the mesh (before any weight loads), then its sp group."""
    check_mesh(config, pp, tp, dp, sp, max_seq)
    devs = list(devices) if devices is not None else rank_devices(sp, device)
    if len(devs) != sp:
        raise ValueError(f"mesh sp={sp} needs {sp} rank devices, got {len(devs)}")
    group = SpGroup(devs)
    if any(d.type == "cuda" for d in group.devices) and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass CPU devices to run the sp ranks there")
    return group
