"""Single-process inference engine: prefill + token-by-token decode on one
device with a preallocated KV cache and per-nonce sessions.

Counterpart of dnet_tpu/core/engine.py `LocalEngine`: dense KV, resident or
streamed weights, the snapshot prefix cache and speculative decoding by
prompt lookup or by a draft model.  PyTorch runs eagerly, so where the
reference jits one program per step,
each step here is a sequence of launches on the current CUDA stream; the
fused `lax.scan` decode chunk becomes a Python loop that feeds each
sampled token back on the device, so a chunk needs one device-to-host
read.  Prompts are padded to power-of-two buckets as in the
reference, and never past `max_seq - pos` (the KV write must fit); each
forward tells the model how many of its tokens are real (`t_real`), so a
ring-buffer cache (gpt_oss's sliding layers) never takes a padded row.

Under DNET_KV_PAGED=1 (`kv_paged`) the engine keeps the reference's
paged admission ledger: a `BlockPool` (kv/paged.py) that each session
debits block by block as its prompt and decode grow (the KV itself stays
the session's dense cache).  A prefill or a decode step the pool cannot
cover raises `KVPoolExhausted` before any compute, which the HTTP layer
answers with 429; a session's blocks return when it ends or the TTL sweep
drops it.  A block size that does not divide max_seq serves without the
ledger, with the reference's warning.

In shard mode (`layers=`, `shard_mode=True`) the engine holds one ring
shard's layer range and serves hidden states in and out: `embed_window`
on the head, `run_layers` in the middle, `hidden_tail` / `sample_hidden`
on the tail (shard/compute.py drives them).

Weight streaming (`window_size` / `residency_size`, the reference's
plan: core/weights.py `plan_policy`): under an offload or sliding_fit plan
the edge params (embedding, final norm, LM head) stay on the device and
the layers live in host memory (`HostLayerStore`), reaching the device a
window at a time through a `WeightCache` of at most `residency` layers.
`_stream_windows` is the reference's loop: prefetch the next window
(wrapping to window 0 for the next token) while this one computes, run
each layer as a single-layer window over its own cache (the session's KV
is a list of per-layer caches), release it, evict it at once under
sliding_fit, and evict the window behind.  Decode chunks are refused
(single steps: each step re-reads every window), as in the reference.

The prefix cache (`prefix_cache_size`, DNET_API_PREFIX_CACHE) keeps the
KV of whole prompts (core/prefix_cache.py `PrefixCache`, or under the
paged ledger kv/prefix.py `PagedPrefixCache`, whose entries are
refcounted block runs restored as a dense row): a prompt that extends a
stored one starts from its snapshot and prefills only the rest.

Speculative decoding (`spec_lookahead` L, DNET_API_SPEC_LOOKAHEAD) runs a
greedy request's decode as verify blocks: L drafted tokens after the fed
one go through ONE forward of L+1 rows (the prefill kernel at pos > 0),
and the agreeing prefix plus the first correction is emitted, 1..L+1
tokens a block, each an argmax of the logits plain decode computes
(core/spec.py).  Drafts come from prompt lookup over the session's
device-resident history (`hist`) or, with `draft_dir`
(DNET_API_DRAFT_MODEL), from a second, same-vocab checkpoint that drafts
L tokens by its own decode steps over its own cache.  Only greedy requests
without logprobs, penalties or logit bias, on resident weights and a
rewindable (slot-addressed) cache, speculate (`spec_eligible`), and a
session whose drafts rarely land falls back to plain steps
(`spec_worthwhile`).  Streamed weights disable both features with a
warning, as in the reference.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from dnet_tpu_torch.core.prefix_cache import PrefixCache
from dnet_tpu_torch.core.sampler import (
    MAX_TOP_LOGPROBS,
    SamplePlan,
    SampleParams,
    SampleResult,
    pack_chunk_results,
    sample,
)
from dnet_tpu_torch.core.spec import accept_drafts, commit_history, make_spec_step
from dnet_tpu_torch.core.types import DecodingParams, TokenResult
from dnet_tpu_torch.core.weights import HostLayerStore, WeightCache, plan_policy
from dnet_tpu_torch.kv.paged import BlockPool, KVPoolExhausted, PagedKVConfig, PageTable, paged_enabled
from dnet_tpu_torch.models import ModelConfig, get_ring_model_cls
from dnet_tpu_torch.ops.quant import is_quantized
from dnet_tpu_torch.utils.checkpoint import Checkpoint
from dnet_tpu_torch.utils.device import resolve_device
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()


def bucket_length(n: int, min_bucket: int = 16) -> int:
    b = min_bucket
    while b < n:
        b *= 2
    return b


@dataclass
class Session:
    """Per-nonce decode state."""

    nonce: str = ""
    # stacked [L, B, S, KVH, Hd] cache (+ scales when quantized); a
    # streaming engine's is a list of one-layer caches
    kv: dict = None
    pos: int = 0
    generator: torch.Generator = None  # Gumbel noise for sampled requests
    counts: torch.Tensor = None  # [B, V] int32 generated-token counts (repetition penalty)
    last_used: float = field(default_factory=time.time)
    # chunked decode: last sampled token ON DEVICE (chains the next chunk
    # without a host round trip) + dispatched-but-unread chunk queue
    last_token: torch.Tensor = None  # [B, 1] int64
    pending: deque = field(default_factory=deque)
    pages: PageTable = None  # the paged ledger's blocks (kv_paged)
    # speculative decoding: the committed tokens by position, on the device
    # (hist[:, i] is the token fed at position i), when spec_lookahead > 0
    hist: torch.Tensor = None  # [B, max_seq] int64
    dkv: dict = None  # the draft model's own cache (draft_dir)
    # verify blocks run and tokens they emitted (spec_worthwhile's gate)
    spec_blocks: int = 0
    spec_emitted: int = 0


@dataclass
class Draft:
    """The draft model of draft-model speculation: its ring model, config
    and params (window as its stack_layers makes them, edge)."""

    model: object
    config: ModelConfig
    window: object
    edge: dict


class LocalEngine:
    """One process, one device: the full hot path over resident or streamed
    weights."""

    # chunk widths tried largest-first
    DECODE_CHUNK_BUCKETS = (32, 16, 8, 4, 2)
    batch = 1  # sequences per session
    KV_TTL_S = 600.0  # idle sessions older than this are swept
    # the acceptance gate: a verify block costs one (L+1)-wide forward and
    # one host read; below ~1.5 tokens a block, plain steps win
    SPEC_WARMUP_BLOCKS = 4
    SPEC_MIN_TOKENS_PER_BLOCK = 1.5

    def __init__(
        self,
        model_dir: Union[str, Path],
        max_seq: int = 2048,
        param_dtype: str = "bfloat16",
        device: Optional[Union[str, torch.device]] = None,
        layers: Optional[Sequence[int]] = None,
        shard_mode: bool = False,
        kv_dtype: Optional[str] = None,
        kv_quant_bits: int = 0,
        kv_paged: Optional[bool] = None,
        weight_quant_bits: int = 0,
        weight_quant_group: int = 0,
        window_size: int = 0,
        residency_size: int = 0,
        repack_dir: Optional[Union[str, Path]] = None,
        prefix_cache_size: int = 0,
        spec_lookahead: int = 0,
        draft_dir: Optional[Union[str, Path]] = None,
    ):
        """layers=None is the whole model; a sub-range with shard_mode=True
        makes this engine a ring shard's compute core: it loads only the
        edge weights the range needs (the embedding on the head, the final
        norm and LM head on the tail, the embedding on the tail too when
        it is tied) and serves hidden states in and out.  The KV cache is
        `kv_dtype` (default: the param dtype), or int8 / packed int4 with
        f32 scales for `kv_quant_bits` 8 / 4 (core/kvcache.py
        `resolve_kv_bits` maps DNET_KV_BITS to these two).  `kv_paged`
        (default: DNET_KV_PAGED) turns on the paged admission ledger; a
        shard never keeps one, as in the reference.  `weight_quant_bits` 8 /
        4 serves int8 / packed-int4 weights (ops/quant.py, groups of
        `weight_quant_group` along the contraction axis, 0: the bits'
        default): each layer is quantized on the device as it loads, and
        so is the LM projection.  `window_size` / `residency_size` pick the
        weight plan (0: all local layers); a streaming plan keeps the layers
        in host memory (`repack_dir`: a cache of mapped layers on disk).
        `prefix_cache_size` entries of prompt KV snapshots, `spec_lookahead`
        drafted tokens a verify block, and `draft_dir` a same-vocab
        checkpoint that drafts them (prompt lookup without it)."""
        if draft_dir is not None and spec_lookahead <= 0:
            raise ValueError("draft_dir needs spec_lookahead > 0 (the draft model exists only to draft "
                             "verify blocks)")
        self.device = resolve_device(device)
        self.ckpt = Checkpoint(model_dir)
        self.config = ModelConfig.from_hf(self.ckpt.config)
        self._setup(max_seq, param_dtype, layers, kv_dtype, kv_quant_bits, weight_quant_bits, weight_quant_group)
        self.spec_lookahead = int(spec_lookahead)
        m = self.model
        self.plan = plan_policy(len(m.layers), window_size, residency_size)
        if paged_enabled() if kv_paged is None else kv_paged:
            if shard_mode:
                log.warning("paged KV not supported for shard engines (the ring runtime owns shard "
                            "admission); serving the dense path")
            else:
                self._init_paged(slots=8 + prefix_cache_size)
        self._init_features(prefix_cache_size, shard_mode)
        if draft_dir is not None:
            self._load_draft(draft_dir)
        t0 = time.perf_counter()
        if self.plan.streams_weights:
            self._start_streaming(HostLayerStore(
                self.ckpt, m, param_dtype=param_dtype, repack_dir=repack_dir,
                weight_quant_bits=weight_quant_bits, weight_quant_group=weight_quant_group, device=self.device,
            ))
        else:
            self.window_params = m.stack_layers(
                [self._place(m.map_layer(self._on_device(self.ckpt.load_layer_raw(a)))) for a in m.layers]
            )
        names = None  # every edge tensor
        if shard_mode:
            names = []
            if m.is_first or (m.is_last and self.config.tie_word_embeddings):
                names.append("model.embed_tokens.weight")
            if m.is_last:
                names += ["model.norm.weight", "lm_head.weight"]
        self.edge_params = self._place_edge(m.map_edge(self._on_device(self.ckpt.load_edge_raw(names))))
        if not self.plan.streams_weights:
            self.ckpt.close()
        log.info(
            "[PROFILE] loaded %d layers (%s, %s) in %.2fs",
            len(m.layers), self.config.model_type, self.plan.name, time.perf_counter() - t0,
        )
        self._build_kernels()

    @classmethod
    def from_params(
        cls,
        config: ModelConfig,
        window_params: Iterable[dict],
        edge_params: dict,
        *,
        max_seq: int = 2048,
        param_dtype: str = "bfloat16",
        device: Optional[Union[str, torch.device]] = None,
        kv_dtype: Optional[str] = None,
        kv_quant_bits: int = 0,
        kv_paged: Optional[bool] = None,
        weight_quant_bits: int = 0,
        weight_quant_group: int = 0,
        window_size: int = 0,
        residency_size: int = 0,
        prefix_cache_size: int = 0,
        spec_lookahead: int = 0,
    ) -> "LocalEngine":
        """An engine around already-materialised parameters (no checkpoint
        on disk; `window_params` one dict per layer, in layer order, which
        may be a generator: with `weight_quant_bits` each layer is quantized
        as it arrives and its full-precision copy is dropped before the
        next is made).  Params that are quantized already (e.g. the
        reference's, through models/convert.py) are kept as they are.  A
        streaming plan (`window_size` / `residency_size`) packs each layer
        into host memory as it arrives (page-locked on CUDA) and drops it
        from the device: the host layer source of the streamed engine.
        `prefix_cache_size` / `spec_lookahead` as in __init__ (no draft
        model: it comes from a checkpoint)."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.ckpt = None
        self.config = config
        self._setup(max_seq, param_dtype, None, kv_dtype, kv_quant_bits, weight_quant_bits, weight_quant_group)
        self.spec_lookahead = int(spec_lookahead)
        self.plan = plan_policy(len(self.model.layers), window_size, residency_size)
        if paged_enabled() if kv_paged is None else kv_paged:
            self._init_paged(slots=8 + prefix_cache_size)
        self._init_features(prefix_cache_size, False)
        self.edge_params = self._place_edge(edge_params)
        if self.plan.streams_weights:
            self._start_streaming(HostLayerStore.from_layers(
                self.model, window_params, param_dtype=param_dtype, weight_quant_bits=weight_quant_bits,
                weight_quant_group=weight_quant_group, device=self.device,
            ))
        else:
            self.window_params = self.model.stack_layers([self._place(p) for p in window_params])
        self._build_kernels()
        return self

    def _setup(
        self, max_seq: int, param_dtype: str, layers: Optional[Sequence[int]] = None,
        kv_dtype: Optional[str] = None, kv_quant_bits: int = 0, weight_quant_bits: int = 0,
        weight_quant_group: int = 0,
    ) -> None:
        if kv_quant_bits not in (0, 4, 8):
            raise ValueError(f"kv_quant_bits={kv_quant_bits} (supported: 0/4/8)")
        if weight_quant_bits not in (0, 4, 8):
            raise NotImplementedError("weight quantization supports 4 (packed int4) or 8 (int8) bits")
        self.model = get_ring_model_cls(self.config.model_type)(
            self.config, range(self.config.num_hidden_layers) if layers is None else layers, self.device
        )
        if weight_quant_bits and not self.model.supports_weight_quant:
            raise NotImplementedError(f"weight quantization not supported for {self.config.model_type}")
        self.weight_quant_bits = weight_quant_bits
        self.weight_quant_group = weight_quant_group
        self.max_seq = max_seq
        self.param_dtype = getattr(torch, param_dtype)
        self.kv_dtype = kv_dtype or param_dtype
        self.kv_quant_bits = kv_quant_bits
        self.kv_bytes = 0  # bytes of the last cache a session allocated
        self.sessions: Dict[str, Session] = {}
        self.kv_pool: Optional[BlockPool] = None  # the paged ledger (_init_paged)
        self._kv_paged_cfg: Optional[PagedKVConfig] = None
        # the prefix cache, speculation and the draft model: off unless
        # asked for (_init_features, _load_draft)
        self.prefix_cache = None
        self.spec_lookahead = 0
        self.draft = None
        self.spec_blocks = self.spec_emitted = 0  # every session's verify blocks and their tokens
        # resident weights unless a streaming plan says otherwise
        self.plan = plan_policy(len(self.model.layers))
        self.weight_cache: Optional[WeightCache] = None
        self._windows: List[List[int]] = []

    def _start_streaming(self, store: HostLayerStore) -> None:
        """Serve the layers from `store` through a WeightCache of
        `plan.residency` layers, window 0 already on its way."""
        m, w = self.model, self.plan.window_size
        self.weight_cache = WeightCache(store, max_resident=self.plan.residency, device=self.device)
        self._windows = [m.layers[i : i + w] for i in range(0, len(m.layers), w)]
        self.window_params = None
        self.weight_cache.prefetch(self._windows[0])

    # ---- paged KV ledger ------------------------------------------------
    def _init_paged(self, slots: int = 8) -> None:
        """The BlockPool admission ledger (DNET_KV_PAGED=1).  `slots` sizes
        the pool when DNET_KV_POOL_BLOCKS is 0: that many max_seq
        sequences' worth of blocks."""
        try:
            cfg = PagedKVConfig.from_settings(self.max_seq, slots=slots)
        except ValueError as exc:
            log.warning("paged KV disabled (%s); serving the dense path", exc)
            return
        self._kv_paged_cfg = cfg
        self.kv_pool = BlockPool(cfg)
        log.info("paged KV on: %d blocks x %d tokens (%s sequences' worth)", cfg.pool_blocks,
                 cfg.block_tokens, cfg.pool_blocks * cfg.block_tokens // self.max_seq)

    # ---- the prefix cache, speculation and the draft model ---------------
    def _init_features(self, prefix_cache_size: int, shard_mode: bool) -> None:
        """The prefix cache (not on a shard or under streamed weights, with
        the reference's warning) and the streaming warning for speculation
        (spec_eligible refuses it)."""
        if prefix_cache_size > 0:
            if self.plan.streams_weights or shard_mode:
                log.warning("prefix cache requested but unsupported for %s engines; disabled",
                            "weight-streaming" if self.plan.streams_weights else "shard")
            else:
                self.prefix_cache = self._build_prefix_cache(prefix_cache_size)
        if self.spec_lookahead > 0 and self.plan.streams_weights:
            log.warning("speculative decoding needs resident weights (a streamed verify re-reads every window); "
                        "serving plain decode")

    def _build_prefix_cache(self, capacity: int):
        """A dense PrefixCache, or under the paged ledger the block-sharing
        PagedPrefixCache (the same lookup / store surface; snapshots share a
        parent entry's full blocks instead of copying them)."""
        if self.kv_pool is None:
            return PrefixCache(capacity)
        from dnet_tpu_torch.kv.prefix import PagedPrefixCache
        from dnet_tpu_torch.kv.store import BlockStore

        try:
            store = BlockStore(self.model, len(self.model.layers), self._kv_paged_cfg, self.kv_dtype,
                               self.kv_quant_bits, session_tokens=self.max_seq)
        except NotImplementedError as exc:
            log.warning("paged prefix sharing unavailable (%s); using dense snapshots", exc)
            return PrefixCache(capacity)
        return PagedPrefixCache(self.kv_pool, store, capacity, row_tokens=self.max_seq)

    def _load_draft(self, draft_dir: Union[str, Path]) -> None:
        """The draft model: a same-vocab checkpoint whose cache can rewind,
        its params in this engine's dtype (never quantized), on this
        engine's device."""
        ckpt = Checkpoint(draft_dir)
        cfg = ModelConfig.from_hf(ckpt.config)
        if cfg.vocab_size != self.config.vocab_size:
            raise ValueError(f"draft model vocab {cfg.vocab_size} != target vocab {self.config.vocab_size}; "
                             "speculation needs a shared token space")
        dm = get_ring_model_cls(cfg.model_type)(cfg, range(cfg.num_hidden_layers), self.device)
        if not dm.kv_rewindable(self.max_seq):
            raise ValueError(f"draft model {cfg.model_type} uses rotating SWA caches, which cannot rewind after "
                             "partial acceptance")
        try:
            window = dm.stack_layers([self._cast(dm.map_layer(self._on_device(ckpt.load_layer_raw(a))))
                                      for a in dm.layers])
            edge = {k: self._cast(v) for k, v in dm.map_edge(self._on_device(ckpt.load_edge_raw())).items()}
        finally:
            ckpt.close()
        self.draft = Draft(model=dm, config=cfg, window=window, edge=edge)
        log.info("draft model loaded: %s (%d layers) drafting for %s", cfg.model_type, cfg.num_hidden_layers,
                 self.config.model_type)

    def _paged_ensure(self, sess: Session, n_tokens: int) -> None:
        """Debit the pool for the blocks a session needs to cover n_tokens;
        raises KVPoolExhausted before any compute."""
        if self.kv_pool is None:
            return
        if sess.pages is None:
            sess.pages = PageTable()
        self.kv_pool.ensure(sess.pages, min(n_tokens, self.max_seq))

    def _paged_release(self, sess: Optional[Session]) -> None:
        if self.kv_pool is not None and sess is not None:
            self.kv_pool.release_table(sess.pages)

    def _cast(self, params: dict) -> dict:
        """Params on the device, floats in the param dtype; quantized
        weights are kept as they are."""
        return {
            k: v if is_quantized(v) else
            v.to(device=self.device, dtype=self.param_dtype if v.is_floating_point() else v.dtype)
            for k, v in params.items()
        }

    def _on_device(self, tensors: dict) -> dict:
        """Tensors moved to the device in their own dtype (quantized weights
        kept as given), so that the checkpoint mapping's transposes and
        expert stacks, and the quantizer, run there."""
        return {k: v if is_quantized(v) else v.to(self.device) for k, v in tensors.items()}

    def _place(self, params: dict) -> dict:
        """One layer's params on the device.  Under weight quantization the
        model's quant keys are quantized from the values as loaded (before
        the cast, as the reference does), their scales in the param dtype."""
        if self.weight_quant_bits:
            params = self.model.quantize_params(
                self._on_device(params), self.weight_quant_bits, scale_dtype=self.param_dtype,
                group_size=self.weight_quant_group,
            )
        return self._cast(params)

    def _place_edge(self, edge: dict) -> dict:
        """The edge params on the device (the LM projection quantized under
        weight quantization, `quantize_edge`)."""
        if self.weight_quant_bits:
            edge = self.model.quantize_edge(
                {k: self._on_device(leaves) for k, leaves in edge.items()}, self.weight_quant_bits,
                scale_dtype=self.param_dtype, group_size=self.weight_quant_group,
            )
        return {k: self._cast(v) for k, v in edge.items()}

    def _build_kernels(self) -> None:
        """Build the attention kernels now, not on the first request."""
        if self.device.type == "cuda":
            from dnet_tpu_torch.kernels.build import build_all

            t0 = time.perf_counter()
            build_all()
            log.info("[PROFILE] kernels ready in %.2fs", time.perf_counter() - t0)

    # ---- forward ------------------------------------------------------
    def _forward(self, tokens: torch.Tensor, kv: dict, pos: int, last_idx: int) -> torch.Tensor:
        """Embed + every layer + final norm + LM head at `last_idx`:
        logits [B, V] in the param dtype.  Writes kv in place; tokens past
        `last_idx` are bucket padding."""
        m = self.model
        x = self._layers(m.embed(self.edge_params, tokens), kv, pos, last_idx + 1)
        x_last = m.normalize(self.edge_params, x[:, last_idx : last_idx + 1])
        return m.lm_project(self.edge_params, x_last)[:, 0]

    def _layers(self, x: torch.Tensor, kv, pos: int, t_real: Optional[int]) -> torch.Tensor:
        """Every layer of this engine over x under the weight plan."""
        if self.weight_cache is None:
            x, _ = self.model.apply_window(self.window_params, x, kv, pos, t_real=t_real)
            return x
        return self._stream_windows(x, kv, pos, t_real)

    def _stream_windows(self, x: torch.Tensor, kv: list, pos: int, t_real: Optional[int]) -> torch.Tensor:
        """The weight-streaming loop: prefetch the next window (window 0
        after the last, for the next token) while this one runs, each layer
        over its own cache; release each layer as it is done (sliding_fit:
        evict it at once) and evict the window behind."""
        m, wc, windows = self.model, self.weight_cache, self._windows
        sliding = self.plan.name == "sliding_fit"
        for wi, window in enumerate(windows):
            if len(windows) > 1:
                wc.prefetch(windows[wi + 1] if wi + 1 < len(windows) else windows[0])
            for layer in window:
                p = wc.get(layer)
                x, _ = m.apply_window(p, x, kv[m.abs_to_local[layer]], pos, t_real=t_real)
                wc.release([layer])
                if sliding:
                    wc.evict([layer])
            if len(windows) > 1 and not sliding:
                wc.evict(window)  # room for what comes next
        return x

    # ---- shard paths (a ring shard's hidden states in and out) ---------
    def run_layers(self, sess: Session, x: torch.Tensor, pos: int, t_real: Optional[int] = None) -> torch.Tensor:
        """This engine's layers over hidden x [B, T, D] starting at `pos`
        (`t_real` of its rows real); writes the session's KV in place."""
        return self._layers(x, sess.kv, pos, t_real)

    def embed_window(
        self, sess: Session, tokens: torch.Tensor, pos: int, t_real: Optional[int] = None
    ) -> torch.Tensor:
        """Head shard: embed tokens [B, T] and run this engine's layers."""
        return self.run_layers(sess, self.model.embed(self.edge_params, tokens), pos, t_real)

    def sample_hidden(
        self, sess: Session, x: torch.Tensor, last_idx: int, decoding: DecodingParams
    ) -> SampleResult:
        """Tail shard: final norm + LM head at `last_idx`, then the sample
        exactly as the single-process step draws it."""
        m = self.model
        x_last = m.normalize(self.edge_params, x[:, last_idx : last_idx + 1])
        logits = m.lm_project(self.edge_params, x_last)[:, 0]
        return self._sample_with_counts(
            sess, logits,
            SampleParams.from_decoding(decoding, self.device), SamplePlan.from_decoding(decoding),
        )

    def hidden_tail(
        self, sess: Session, x: torch.Tensor, pos: int, last_idx: int, decoding: DecodingParams
    ) -> SampleResult:
        """Tail shard: this engine's layers, then sample at `last_idx`."""
        return self.sample_hidden(sess, self.run_layers(sess, x, pos), last_idx, decoding)

    def close(self) -> None:
        """Drop sessions and parameters (a shard reloading frees the old
        engine's device memory first)."""
        self.sessions.clear()
        if self.weight_cache is not None:
            self.weight_cache.shutdown()
            self.weight_cache = None
        if self.ckpt is not None:
            self.ckpt.close()
        self.window_params = []
        self.edge_params = {}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def weight_stats(self) -> dict:
        """The weights' form and the bytes they hold on the device (codes,
        scales and every float tensor, the edge included; streaming: the
        edge and the weight cache's slabs)."""
        if self.weight_cache is not None:
            layer_bytes = self.weight_cache.snapshot()["slab_bytes"]
        else:
            layer_bytes = tensor_bytes(self.window_params)
        return {"weight_quant_bits": self.weight_quant_bits,
                "weight_bytes": layer_bytes + tensor_bytes(self.edge_params)}

    def stats(self) -> dict:
        """The weights' and the KV cache's form, the bytes the weights and
        one session's cache hold, the weight plan (and, streaming, the
        weight cache's counters), the paged ledger's blocks when it is on,
        the prefix cache's counters, and the verify blocks run and the
        tokens they emitted when speculating (for /health)."""
        out = {"kv_dtype": self.kv_dtype, "kv_quant_bits": self.kv_quant_bits, "kv_bytes": self.kv_bytes,
               "weight_policy": self.plan.name, **self.weight_stats()}
        if self.weight_cache is not None:
            out["weight_cache"] = self.weight_cache.snapshot()
        if self.kv_pool is not None:
            out.update(kv_mode="paged", kv_pool_blocks=self.kv_pool.total, kv_blocks_used=self.kv_pool.used,
                       kv_blocks_free=self.kv_pool.free, kv_blocks_peak=self.kv_pool.peak_used)
        if self.prefix_cache is not None:
            out["prefix_cache"] = dict(self.prefix_cache.stats, entries=len(self.prefix_cache))
        if self.spec_lookahead > 0:
            out.update(spec_lookahead=self.spec_lookahead, spec_draft=self.draft is not None,
                       spec_blocks=self.spec_blocks, spec_emitted=self.spec_emitted)
        return out

    # ---- sessions -----------------------------------------------------
    def new_session(self, nonce: str, seed: Optional[int] = None, kv=None, pos: int = 0) -> Session:
        """A fresh session, or (kv, pos) one seeded from a prefix-cache
        snapshot instead of a new zero-filled cache."""
        if seed is None:
            # fresh entropy per unseeded request: two users must not share a stream
            seed = int.from_bytes(os.urandom(4), "little")
        if kv is None:
            kv = self._init_kv()
            self.kv_bytes = tensor_bytes(kv)
        sess = Session(
            nonce=nonce,
            kv=kv,
            pos=pos,
            generator=torch.Generator(device=self.device).manual_seed(int(seed)),
            counts=torch.zeros(
                (self.batch, self.config.vocab_size), dtype=torch.int32, device=self.device
            ),
        )
        if self.spec_lookahead > 0:
            sess.hist = torch.zeros((self.batch, self.max_seq), dtype=torch.int64, device=self.device)
        if self.draft is not None:
            d = self.draft
            sess.dkv = d.model.init_kv(d.config.num_hidden_layers, self.batch, self.max_seq, self.kv_dtype)
        self.sessions[nonce] = sess
        return sess

    def _init_kv(self):
        """A new session's cache (parallel/engine.py's MeshEngine shards it;
        a streaming engine keeps one cache per layer)."""
        m = self.model
        if self.weight_cache is not None:
            return [m.init_offload_kv(a, self.batch, self.max_seq, self.kv_dtype, self.kv_quant_bits)
                    for a in m.layers]
        return m.init_kv(len(m.layers), self.batch, self.max_seq, self.kv_dtype, self.kv_quant_bits)

    def end_session(self, nonce: str) -> None:
        self._paged_release(self.sessions.pop(nonce, None))

    def sweep_sessions(self) -> int:
        now = time.time()
        dead = [n for n, s in self.sessions.items() if now - s.last_used > self.KV_TTL_S]
        for n in dead:
            # the sweep is the paged ledger's collector too
            self._paged_release(self.sessions.pop(n))
        return len(dead)

    # ---- inference ----------------------------------------------------
    def _tokens(self, ids: Sequence[int], pos: int) -> torch.Tensor:
        """ids [T] as a [B, Tpad] int64 tensor on the device, zero-padded to
        the power-of-two bucket and never past max_seq - pos: the padded
        width's KV write must fit too."""
        T = len(ids)
        tokens = np.zeros((self.batch, min(bucket_length(T), self.max_seq - pos)), dtype=np.int64)
        tokens[:, :T] = np.asarray(ids, dtype=np.int64)
        return torch.from_numpy(tokens).to(self.device)

    def prefill(
        self, nonce: str, prompt_ids: Sequence[int], seed: Optional[int] = None, allow_store: bool = True
    ) -> torch.Tensor:
        """Run the prompt; returns logits [B, V] at the last real position.
        Reusing a live session continues at its pos (chunked prefill).  A
        new session starts from the prefix cache's longest hit, and a fresh
        session's whole prompt is stored there afterwards unless
        `allow_store` is False (a chunked caller stores the full prompt
        itself, `store_prefix`)."""
        full_ids = list(prompt_ids)
        if not full_ids:
            raise ValueError("empty prompt")
        sess = self.sessions.get(nonce)
        # checked against the whole prompt before any session changes: a
        # too-long prompt leaves no half-restored session behind
        start = 0 if sess is None else sess.pos
        if start + len(full_ids) > self.max_seq:
            raise ValueError(f"prompt length {start + len(full_ids)} exceeds max_seq {self.max_seq}")
        t_pf = time.perf_counter()
        fresh = sess is None
        ids = full_ids
        if sess is None:
            hit = self.prefix_cache.lookup(full_ids) if self.prefix_cache is not None else None
            if hit is not None:
                n, kv = hit
                sess = self.new_session(nonce, seed, kv=kv, pos=n)
                ids = full_ids[n:]  # at least one token is left, by the cache's rule
            else:
                sess = self.new_session(nonce, seed)
        else:
            fresh = sess.pos == 0  # an explicit chunked continuation
        T = len(ids)
        try:
            # admission before the forward: exhaustion costs nothing
            self._paged_ensure(sess, sess.pos + T)
        except KVPoolExhausted:
            if fresh:
                self.end_session(nonce)
            raise
        self._commit_prompt_hist(sess, full_ids, ids)
        logits = self._forward(self._tokens(ids, sess.pos), sess.kv, sess.pos, T - 1)
        if self.draft is not None:
            if fresh and len(ids) != len(full_ids):
                # a hit restored the target's KV only: the draft re-reads the prompt
                self._advance_draft(sess, full_ids, 0)
            else:
                self._advance_draft(sess, ids, sess.pos)
        # repetition penalty counts GENERATED tokens only (prompt tokens are
        # not seeded), as in the reference
        sess.pos += T
        sess.last_used = time.time()
        if self.prefix_cache is not None and allow_store and fresh and sess.pos == len(full_ids):
            self.prefix_cache.store(full_ids, sess.kv)  # copied: the session goes on writing its cache
        log.info("[PROFILE] prefill %d tokens: %.2fms dispatch", T, (time.perf_counter() - t_pf) * 1000)
        return logits

    def seed_from_prefix(self, nonce: str, full_ids: Sequence[int], seed: Optional[int] = None) -> int:
        """The chunked prefill's prefix-cache entry: seed a NEW session from
        the longest cached prefix of the whole prompt (a chunked prefill
        would look up its first chunk only).  Returns the tokens covered (0:
        no cache, no hit, or the session exists)."""
        if self.prefix_cache is None or nonce in self.sessions:
            return 0
        hit = self.prefix_cache.lookup(list(full_ids))
        if hit is None:
            return 0
        n, kv = hit
        self._restore_session(nonce, full_ids, n, kv, seed)
        return n

    def _restore_session(self, nonce: str, full_ids: Sequence[int], n: int, kv, seed) -> Session:
        """A new session from a restored n-token prefix: the session, its
        speculation history (the follow-up prefill writes only its own
        rest) and the draft model's context (its cache is not snapshotted:
        the small model re-reads the prefix)."""
        sess = self.new_session(nonce, seed, kv=kv, pos=n)
        if sess.hist is not None:
            commit_history(sess.hist, 0, self._id_rows(full_ids[:n]))
        self._advance_draft(sess, list(full_ids[:n]), 0)
        return sess

    def _advance_draft(self, sess: Session, ids: Sequence[int], pos0: int) -> None:
        """Run the draft model over `ids` from position pos0, so that its
        cache holds the committed context (draft-model speculation)."""
        if self.draft is None or sess.dkv is None or not ids:
            return
        d = self.draft
        x = d.model.embed(d.edge, self._tokens(ids, pos0))
        d.model.apply_window(d.window, x, sess.dkv, pos0, t_real=len(ids))

    def store_prefix(self, nonce: str, full_ids: Sequence[int]) -> None:
        """Snapshot a fully prefilled session's KV under its whole prompt
        (the chunked prefill's counterpart of prefill's own store)."""
        sess = self.sessions.get(nonce)
        if self.prefix_cache is not None and sess is not None and sess.pos == len(full_ids):
            self.prefix_cache.store(list(full_ids), sess.kv)

    def _id_rows(self, ids: Sequence[int]) -> torch.Tensor:
        """ids as a [B, n] int64 tensor on the device (every row the same)."""
        row = torch.as_tensor(np.asarray(ids, dtype=np.int64)).to(self.device)
        return row[None, :].expand(self.batch, len(ids))

    def _sample_with_counts(
        self, sess: Session, logits: torch.Tensor, sp: SampleParams, plan: SamplePlan
    ) -> SampleResult:
        """THE place owning the sample/counts invariants: every path updates
        the penalty counts the same way."""
        res = sample(logits, sp, sess.generator, token_counts=sess.counts, plan=plan)
        sess.counts.scatter_add_(
            1, res.token[:, None].long(), torch.ones_like(sess.counts[:, :1])
        )
        return res

    def prefill_and_sample(
        self, nonce: str, prompt_ids: Sequence[int], decoding: DecodingParams
    ) -> SampleResult:
        """Prefill the prompt and sample the first token."""
        logits = self.prefill(nonce, prompt_ids, decoding.seed)
        return self._sample_with_counts(
            self.sessions[nonce], logits,
            SampleParams.from_decoding(decoding, self.device), SamplePlan.from_decoding(decoding),
        )

    def decode_step(self, nonce: str, token_id: int, decoding: DecodingParams) -> SampleResult:
        sess = self.sessions[nonce]
        if sess.pos >= self.max_seq:
            raise ValueError(f"sequence length {sess.pos} reached max_seq {self.max_seq}")
        self._paged_ensure(sess, sess.pos + 1)  # may raise KVPoolExhausted
        token = torch.full((self.batch, 1), int(token_id), dtype=torch.int64, device=self.device)
        logits = self._forward(token, sess.kv, sess.pos, 0)
        res = self._sample_with_counts(
            sess, logits,
            SampleParams.from_decoding(decoding, self.device), SamplePlan.from_decoding(decoding),
        )
        sess.pos += 1
        sess.last_used = time.time()
        return res

    # ---- speculative decoding ----------------------------------------
    def _commit_prompt_hist(self, sess: Session, full_ids: Sequence[int], ids: Sequence[int]) -> None:
        """Commit the prompt to the speculation history: on a prefix hit the
        whole prompt at 0 (the cached tokens never went through this
        session), else the chunk at the session's position."""
        if sess.hist is None:
            return
        n_cached = len(full_ids) - len(ids)
        commit_history(sess.hist, sess.pos - n_cached, self._id_rows(full_ids))

    def spec_eligible(self, decoding: DecodingParams) -> bool:
        """Whether this engine and request may speculate: greedy (the block
        emits raw argmaxes), no logprobs, no repetition penalty, no logit
        bias, resident weights, and a rewindable cache layout (a rotating
        ring cannot rewind: core/spec.py)."""
        return (
            self.spec_lookahead > 0
            and not self.plan.streams_weights
            and self.model.kv_rewindable(self.max_seq)
            and decoding.temperature == 0.0
            and not decoding.logprobs
            and decoding.repetition_penalty == 1.0
            and not decoding.logit_bias
        )

    def spec_worthwhile(self, nonce: str) -> bool:
        """The per-session acceptance gate: after SPEC_WARMUP_BLOCKS blocks,
        a session whose blocks emit fewer than SPEC_MIN_TOKENS_PER_BLOCK
        tokens on average takes plain steps (the callers ask every block,
        and speculation does not resume within the session)."""
        sess = self.sessions.get(nonce)
        if sess is None or sess.spec_blocks < self.SPEC_WARMUP_BLOCKS:
            return True
        return sess.spec_emitted / sess.spec_blocks >= self.SPEC_MIN_TOKENS_PER_BLOCK

    def _verify(self, block: torch.Tensor, kv, pos: int) -> torch.Tensor:
        """The target's forward over a verify block [B, L+1] at `pos`:
        logits [B, L+1, V] (its KV rows written in place)."""
        m = self.model
        x = self._layers(m.embed(self.edge_params, block), kv, pos, block.shape[1])
        return m.lm_project(self.edge_params, m.normalize(self.edge_params, x))

    def _spec_block_draft(self, sess: Session, tok: torch.Tensor) -> torch.Tensor:
        """The draft model's verify block: L greedy decode steps of the draft
        over its own cache (each fed token's row written: the rows past the
        accepted count are stale, as the target's), then one (L+1)-wide
        verify.  Returns accept_drafts' out [B, L+1]."""
        d, L = self.draft, self.spec_lookahead
        t, drafts = tok, []
        for i in range(L):
            x = d.model.embed(d.edge, t)
            x, _ = d.model.apply_window(d.window, x, sess.dkv, sess.pos + i, t_real=1)
            t = d.model.lm_project(d.edge, d.model.normalize(d.edge, x))[:, 0].argmax(dim=-1, keepdim=True)
            drafts.append(t)
        drafts = torch.cat(drafts, dim=1)  # [B, L]
        preds = self._verify(torch.cat([tok, drafts], dim=1), sess.kv, sess.pos).argmax(dim=-1)
        return accept_drafts(preds, drafts)[1]

    def decode_spec(
        self, nonce: str, token_id: Optional[int], decoding: DecodingParams, max_new: int
    ) -> List[SampleResult]:
        """One verify block: feed `token_id` (None chains from the session's
        device-resident last token), draft spec_lookahead tokens, verify
        them in ONE forward and emit the accepted prefix plus the first
        correction, at most `max_new` tokens.  The session advances by
        exactly what was emitted (the next block overwrites the stale KV and
        history rows).  At the sequence's end, or when the paged ledger
        cannot cover the block, one plain step keeps the stream moving."""
        sess = self.sessions[nonce]
        L = self.spec_lookahead
        if sess.pos >= self.max_seq:
            raise ValueError(f"sequence length {sess.pos} reached max_seq {self.max_seq}")
        budget = min(max_new, self.max_seq - sess.pos)
        if self.kv_pool is not None and sess.pos + L + 1 <= self.max_seq:
            try:
                # the block writes L+1 rows; a pool that cannot cover them
                # degrades to a plain step, whose own admission raises
                self._paged_ensure(sess, sess.pos + L + 1)
            except KVPoolExhausted:
                budget = 1
        if budget <= 1 or sess.pos + L + 1 > self.max_seq:
            tid = token_id if token_id is not None else int(sess.last_token[0, 0])
            return [self.decode_step(nonce, tid, decoding)]
        if token_id is None:
            if sess.last_token is None:
                raise RuntimeError("no device-resident token to chain from")
            tok = sess.last_token
        else:
            tok = torch.full((self.batch, 1), int(token_id), dtype=torch.int64, device=self.device)
        if self.draft is not None:
            out = self._spec_block_draft(sess, tok)
        else:
            step = make_spec_step(self.model, self._layers, L)
            out, sess.hist = step(self.edge_params, tok, sess.hist, sess.kv, sess.pos)
        out_h = out.cpu().numpy()  # [B, L+1]; waits for the block
        emitted = min(int((out_h[0] >= 0).sum()), budget)
        sess.pos += emitted
        sess.spec_blocks += 1
        sess.spec_emitted += emitted
        self.spec_blocks += 1
        self.spec_emitted += emitted
        sess.last_used = time.time()
        sess.last_token = torch.from_numpy(out_h[:, emitted - 1 : emitted].astype(np.int64)).to(self.device)
        B = out_h.shape[0]
        zero_lp = np.zeros((B,), np.float32)
        zero_tt = np.zeros((B, MAX_TOP_LOGPROBS), np.int32)
        zero_tlp = np.zeros((B, MAX_TOP_LOGPROBS), np.float32)
        return [SampleResult(out_h[:, i].astype(np.int32), zero_lp, zero_tt, zero_tlp) for i in range(emitted)]

    def decode_chunk_dispatch(
        self,
        nonce: str,
        token_id: Optional[int],
        decoding: DecodingParams,
        max_steps: int,
    ) -> int:
        """Enqueue a chunk of up to `max_steps` decode steps on the device.

        token_id None chains from the device-resident last token of the
        previous chunk, so the host never reads a token to keep the device
        busy.  Returns the dispatched width (0 = not chunkable; the caller
        falls back to decode_step).  decode_chunk_read reads chunks in
        dispatch order."""
        sess = self.sessions[nonce]
        if sess.pos >= self.max_seq:
            # not an error here: the caller may be speculating past a chunk
            # that exactly filled the sequence; decode_step raises for real
            return 0
        budget = min(max_steps, self.max_seq - sess.pos)
        K = next((b for b in self.DECODE_CHUNK_BUCKETS if b <= budget), 1)
        if K == 1 or self.weight_cache is not None:
            return 0
        try:
            self._paged_ensure(sess, sess.pos + K)
        except KVPoolExhausted:
            # an un-extendable chunk falls back to single steps, whose own
            # admission raises the definitive error
            return 0
        if token_id is None:
            if sess.last_token is None:
                raise RuntimeError("no device-resident token to chain from")
            token = sess.last_token
        else:
            token = torch.full((self.batch, 1), int(token_id), dtype=torch.int64, device=self.device)
        sp = SampleParams.from_decoding(decoding, self.device)
        plan = SamplePlan.from_decoding(decoding)
        results = []
        for i in range(K):
            logits = self._forward(token, sess.kv, sess.pos + i, 0)
            res = self._sample_with_counts(sess, logits, sp, plan)
            token = res.token[:, None].long()
            results.append(res)
        sess.pending.append((K, pack_chunk_results(results, plan.logprobs), plan))
        sess.last_token = token
        sess.pos += K
        sess.last_used = time.time()
        return K

    def pending_chunks(self, nonce: str) -> int:
        """Dispatched-but-unread chunk count (0 for unknown sessions)."""
        sess = self.sessions.get(nonce)
        return len(sess.pending) if sess is not None else 0

    def pending_width(self, nonce: str) -> int:
        """Total tokens in flight across dispatched-but-unread chunks."""
        sess = self.sessions.get(nonce)
        return sum(k for k, _, _ in sess.pending) if sess is not None else 0

    def decode_chunk_read(self, nonce: str) -> List[SampleResult]:
        """Read the oldest dispatched chunk: ONE device-to-host copy of the
        packed [K, B, W] block, split on the host."""
        sess = self.sessions[nonce]
        K, packed, plan = sess.pending.popleft()
        arr = packed.cpu().numpy()  # waits for the chunk's launches
        toks = arr[..., 0].astype(np.int32)  # [K, B]
        if plan.logprobs:
            M = MAX_TOP_LOGPROBS
            lps = arr[..., 1]
            tt = arr[..., 2 : 2 + M].astype(np.int32)
            tlp = arr[..., 2 + M : 2 + 2 * M]
        else:
            B = arr.shape[1]
            lps = np.zeros((K, B), np.float32)
            tt = np.zeros((K, B, MAX_TOP_LOGPROBS), np.int32)
            tlp = np.zeros((K, B, MAX_TOP_LOGPROBS), np.float32)
        return [SampleResult(toks[i], lps[i], tt[i], tlp[i]) for i in range(K)]

    def decode_chunk(
        self, nonce: str, token_id: int, decoding: DecodingParams, max_steps: int
    ) -> List[SampleResult]:
        """Up to `max_steps` decode steps (dispatch + read in one call); one
        host-side SampleResult per generated token.  The caller owns EOS /
        stop checks and discards any overshoot with the session."""
        if self.decode_chunk_dispatch(nonce, token_id, decoding, max_steps) == 0:
            return [self.decode_step(nonce, token_id, decoding)]
        return self.decode_chunk_read(nonce)

    def generate(
        self,
        prompt_ids: Sequence[int],
        decoding: Optional[DecodingParams] = None,
        max_tokens: int = 256,
        eos_token_ids: Optional[set] = None,
        nonce: str = "local",
    ):
        """Autoregressive generation, yielding per-token TokenResults."""
        decoding = decoding or DecodingParams()
        eos = eos_token_ids or set()
        self.end_session(nonce)
        res = self.prefill_and_sample(nonce, prompt_ids, decoding)
        sess = self.sessions[nonce]
        token = int(res.token[0])
        yield self.token_result(nonce, res, step=0, decoding=decoding)
        use_spec = self.spec_eligible(decoding)
        step = 1
        while step < max_tokens and token not in eos and sess.pos < self.max_seq:
            if use_spec and self.spec_worthwhile(nonce):
                results = self.decode_spec(nonce, token, decoding, max_tokens - step)
            else:
                results = [self.decode_step(nonce, token, decoding)]
            for res in results:
                token = int(res.token[0])
                yield self.token_result(nonce, res, step=step, decoding=decoding)
                step += 1
                if token in eos:
                    break
        self.end_session(nonce)

    @staticmethod
    def token_result(nonce: str, res: SampleResult, step: int, decoding: DecodingParams) -> TokenResult:
        top = None
        if decoding.logprobs and decoding.top_logprobs > 0:
            n = min(decoding.top_logprobs, res.top_tokens.shape[-1])
            top = list(
                zip(
                    _host(res.top_tokens)[0, :n].tolist(),
                    _host(res.top_logprobs)[0, :n].tolist(),
                )
            )
        return TokenResult(
            nonce=nonce,
            token_id=int(res.token[0]),
            logprob=float(res.logprob[0]) if decoding.logprobs else None,
            top_logprobs=top,
            step=step,
        )


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) dict or list of tensors: a flat
    cache, gpt_oss's paired {"a": cache, "b": cache}, or the sp ranks'
    shards [cache, ...]."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(tensor_bytes(v) for v in (tree.values() if isinstance(tree, dict) else tree))


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
