"""Continuous batching: N session slots share one batched decode step, over
dense per-slot KV rows or a paged KV pool.

Counterpart of dnet_tpu/core/batch.py `BatchedEngine` in its three decode
modes, for every family (each has the lane hook, models/base.py
`supports_kv_commit`):

- **Dense slots** (the reference's default, DNET_KV_PAGED unset): a
  [L, slots, S, ...] cache, plain or quantized (DNET_KV_BITS=8|4), where a
  request owns one row from prefill to EOS (gpt_oss: the paired
  {"a", "b"} cache, its sliding half a W-row ring).  Each layer writes the
  active lanes' new K/V rows (codes and scales together) at their own
  positions (a ring: p % W), then the decode kernel (ops/flash_decode.py)
  attends every lane's live slots through a lengths vector (0 for an idle
  lane) in one launch, in its plain, rotating or (192, 128) MLA form: the
  reference's vmap of the single-example step with `kv_commit=active`
  (ops/attention.py `lane_cached_attend`).
- **Paged, dense gather** (DNET_KV_PAGED=1; the reference's default paged
  mode, and its fallback for what the ragged kernel refuses: quantized
  pools, layers without llama's attention body): a request's KV lives in
  blocks of a shared pool ([L, N_blocks, bt, ...], kv/store.py) reached
  through its page table (kv/paged.py).  A dispatch gathers the page
  tables into a dense [L, slots, nb * bt, ...] view, runs the dense-slot
  steps over it, and scatters back only the blocks the active lanes wrote.
  Admission and growth are counted in free blocks; a shortfall raises the
  typed `KVPoolExhausted`.
- **Paged + ragged** (DNET_KV_PAGED=1 DNET_KV_RAGGED=1, eligible models):
  each layer's attention reads the pool in place through the page tables
  (ops/paged_attention.py) and the new K/V rows are appended to their
  blocks afterwards, for active lanes only.

A paged pool the model cannot use (a block size that does not divide
max_seq, a session layout the pool cannot address: gpt_oss's rings) falls
back to dense slots with the reference's warning.

In all three, prefill runs per request on the wrapped B=1 `LocalEngine` (the
prefill kernel, a dense staging row), then the row moves into the slot's
row or commits into pool blocks.  With a prefix cache
(`prefix_cache_size`): on dense slots the inner engine's snapshot cache
(core/prefix_cache.py `PrefixCache`) restores a hit into the staging row;
on paged slots (kv/prefix.py) a prompt that extends a stored one aliases
its full blocks into the new page table, prefills only the rest, and
copies a shared partial tail block through its staging row
(copy-on-write), and a prefilled prompt is stored by aliasing its blocks.

Speculation (`spec_lookahead` L > 0, dense slots only: a verify block's
rows would bypass the paged scatter, so it is off under a pool with the
reference's warning; and off for a rotating cache): within one
`decode_batch` call, the greedy lanes with budget to spare draft L tokens
each by prompt lookup over their own history row (core/spec.py, on the
device) and verify them together in ONE forward of L+1 rows a lane
(`_decode_spec_lanes`: each layer writes the speculating lanes' rows at
their positions and attends through the prefill kernel's per-lane form,
ops/attention.py `lane_chunk_attend`); each lane advances by its own
accepted count (its extra tokens buffer here), while sampled lanes take the
plain batched step.

A decode step is one forward over all slots with static [slots] shapes and
an active mask: inactive lanes are not written, attend nothing, and
advance neither their counts nor their random stream (core/sampler.py `sample_lanes`).  Budgets widen a dispatch
into an R-step chunk (CHUNK_BUCKETS): sampled tokens feed the next step on
the device, and the chunk's results come back in one device-to-host read;
the extra tokens buffer here.

Where the reference jits one vmapped program per step, this is eager
PyTorch: a chunk is a Python loop whose launches queue on the current CUDA
stream.  A streaming weight plan is refused with `EngineCapabilityError`
(422) as the reference refuses it: batching needs resident weights.

Each dispatch observes dnet_decode_step_ms at its wall time over the tokens
it served (as LocalEngine does), and, under `obs_enabled()`, the four
phases of the reference's `dnet_step_phase_ms{phase}`: `kv_gather` (the
page-table gather, gather path only), `compute` (the steps' launches,
sampling included), `kv_scatter` (the blocks' write-back, gather path
only) and `sample` (the one device-to-host read).  Only then are the phase
boundaries fenced (obs/jit.py `fence`, a synchronize of the card), so that
each phase's time covers its kernels; with obs off nothing waits.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dnet_tpu_torch.core.engine import LocalEngine, tensor_bytes
from dnet_tpu_torch.core.sampler import (
    MAX_TOP_LOGPROBS,
    LaneSampling,
    SamplePlan,
    SampleParams,
    SampleResult,
    pack_chunk_results,
    sample_lanes,
)
from dnet_tpu_torch.core.spec import accept_drafts, commit_history, ngram_draft
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.kv import (
    BlockPool,
    BlockStore,
    KVPoolExhausted,
    PagedKVConfig,
    PagedPrefixCache,
    PageTable,
    paged_enabled,
    ragged_enabled,
)
from dnet_tpu_torch.kv.store import tree_get, tree_leaves
from dnet_tpu_torch.obs import get_recorder, metric, obs_enabled
from dnet_tpu_torch.obs.jit import fence
from dnet_tpu_torch.obs.phases import PHASE_COMPUTE, PHASE_KV_GATHER, PHASE_KV_SCATTER, PHASE_SAMPLE
from dnet_tpu_torch.ops.attention import LaneChunk, LaneStep, lane_chunk_attend, lane_cached_attend
from dnet_tpu_torch.ops.paged_attention import paged_attend, ragged_refusal
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

_PHASE_MS = metric("dnet_step_phase_ms")
_DECODE_STEP_MS = metric("dnet_decode_step_ms")


def _bucket_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class BatchedEngine:
    """LocalEngine-compatible surface plus `decode_batch` for the adapter."""

    token_result = staticmethod(LocalEngine.token_result)
    # chunk widths tried largest-first
    CHUNK_BUCKETS = (16, 8, 4, 2)
    # the acceptance gate's thresholds, LocalEngine's
    SPEC_WARMUP_BLOCKS = LocalEngine.SPEC_WARMUP_BLOCKS
    SPEC_MIN_TOKENS_PER_BLOCK = LocalEngine.SPEC_MIN_TOKENS_PER_BLOCK

    def __init__(
        self, model_dir: str | Path, slots: int = 8, prefix_cache_size: int = 0, **engine_kwargs
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        # the inner B=1 engine only stages prefills: this engine owns the pool
        # (and, paged, the prefix cache); on dense slots the prefix cache is
        # the inner engine's
        self.eng = LocalEngine(model_dir, **self._inner_kwargs(prefix_cache_size, engine_kwargs))
        self._init_state(slots, prefix_cache_size)

    @classmethod
    def from_params(
        cls, config, window_params, edge_params, *, slots: int = 8, prefix_cache_size: int = 0, **kw
    ) -> "BatchedEngine":
        """Build around already-materialised params (mirrors
        LocalEngine.from_params)."""
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self = cls.__new__(cls)
        self.eng = LocalEngine.from_params(config, window_params, edge_params,
                                           **self._inner_kwargs(prefix_cache_size, kw))
        self._init_state(slots, prefix_cache_size)
        return self

    @staticmethod
    def _inner_kwargs(prefix_cache_size: int, kw: dict) -> dict:
        """The inner engine's arguments: never its own ledger, and the
        prefix cache's capacity when the slots will be dense."""
        return {**kw, "kv_paged": False, "prefix_cache_size": 0 if paged_enabled() else prefix_cache_size}

    def _init_state(self, slots: int, prefix_size: int = 0) -> None:
        from dnet_tpu_torch.api.inference import EngineCapabilityError

        m = self.eng.model
        if self.eng.plan.streams_weights:
            self.eng.close()
            raise EngineCapabilityError(
                "continuous batching needs resident weights (fit policy); weight streaming serves single-sequence"
            )
        if not m.supports_kv_commit:
            raise EngineCapabilityError(
                f"continuous batching not supported for {m.config.model_type} (no gated KV writes yet)"
            )
        self.slots = slots
        self.max_seq = self.eng.max_seq
        self.config = self.eng.config
        self.model = m
        self.device = self.eng.device
        # per-lane speculation: the inner engine's staging sessions keep the
        # prompt's history, which each lane adopts
        self.spec_lookahead = self.eng.spec_lookahead
        if self.spec_lookahead > 0 and not m.kv_rewindable(self.max_seq):
            log.warning("speculative decoding needs a rewind-safe cache layout; %s uses rotating SWA buffers "
                        "- disabled for this model", m.config.model_type)
            self.spec_lookahead = 0
        self.kv = None  # dense slots: [L, slots, S, ...] (+ scales)
        self.kv_pool = self.kv_store = self._kv_cfg = None  # paged
        self._tables: List[Optional[PageTable]] = [None] * slots
        self.paged_prefix: Optional[PagedPrefixCache] = None
        # nonce -> (n_tokens, blocks, n_full) of a prefix hit not yet
        # committed into its slot's page table (one reference each)
        self._adopt: Dict[str, Tuple[int, List[int], int]] = {}
        paged = paged_enabled()
        if paged:
            try:
                # the pool's default size covers the prefix entries too
                cfg = PagedKVConfig.from_settings(self.max_seq, slots=slots + prefix_size)
                store = BlockStore(m, len(m.layers), cfg, self.eng.kv_dtype, self.eng.kv_quant_bits,
                                   session_tokens=self.max_seq)
            except (ValueError, NotImplementedError) as exc:
                log.warning("paged KV disabled for batched engine (%s); serving dense slots", exc)
                paged = False
                if prefix_size > 0:
                    # the pool was to hold the prefix cache: the slots are
                    # dense, so the inner engine keeps the snapshots
                    self.eng.prefix_cache = self.eng._build_prefix_cache(prefix_size)
            else:
                self._kv_cfg = cfg
                self.kv_pool = BlockPool(cfg)
                self.kv_store = store
                if prefix_size > 0:
                    self.paged_prefix = PagedPrefixCache(self.kv_pool, self.kv_store, prefix_size,
                                                         row_tokens=self.max_seq)
                if self.spec_lookahead > 0:
                    log.warning("per-lane speculation disabled under paged KV (verify blocks bypass the block "
                                "scatter path)")
                    self.spec_lookahead = 0
                log.info("paged KV on: %d blocks x %d tokens serving %d slots",
                         cfg.pool_blocks, cfg.block_tokens, slots)
        # ragged paged attention (DNET_KV_RAGGED=1): decode attends the pool
        # in place; the dense gather serves everything the kernel refuses
        self.kv_ragged = False
        if paged and ragged_enabled():
            why = ragged_refusal(m, self.eng.kv_quant_bits)
            if why is not None:
                log.warning("ragged paged attention disabled (%s); serving dense-gather decode", why)
            else:
                self.kv_ragged = True
                log.info("ragged paged attention on: decode attends the block pool in place")
        if not paged:
            self.kv = m.init_kv(len(m.layers), slots, self.max_seq, self.eng.kv_dtype, self.eng.kv_quant_bits)
            log.info(
                "dense KV: %d slots x %d tokens (%s), %d bytes", slots, self.max_seq,
                f"int{self.eng.kv_quant_bits}" if self.eng.kv_quant_bits else self.eng.kv_dtype,
                self._kv_bytes(),
            )
        self.counts = torch.zeros(
            (slots, self.config.vocab_size), dtype=torch.int32, device=self.device
        )
        # per-slot random streams, adopted from each request's prefill session
        self.generators: List[Optional[torch.Generator]] = [None] * slots
        self.pos = np.zeros(slots, dtype=np.int64)  # host-side per-slot length
        self.last_used = np.zeros(slots, dtype=np.float64)
        self.slot_of: Dict[str, int] = {}  # nonce -> slot
        self._free: List[int] = list(range(slots))
        # chunk results not yet handed to the decode loop (nonce -> FIFO)
        self._buffer: Dict[str, List[SampleResult]] = {}
        # forward steps the batched decode has run (an R-step chunk counts R)
        # and the host time of the last dispatch before its one read
        self.decode_steps = 0
        self.last_dispatch_ms = 0.0
        # speculation: each lane's committed tokens by position, the
        # acceptance counts per request (nonce -> [blocks, emitted]), the
        # verify forwards run, the lanes they verified and the tokens emitted
        self.hist = (torch.zeros((slots, self.max_seq), dtype=torch.int64, device=self.device)
                     if self.spec_lookahead > 0 else None)
        self._spec_stats: Dict[str, List[int]] = {}
        self.spec_blocks = self.spec_lane_blocks = self.spec_emitted = 0

    def _kv_bytes(self) -> int:
        return tensor_bytes(self.kv if self.kv is not None else self.kv_store.kv)

    # ---- slot lifecycle ----------------------------------------------
    def alloc_slot(self, nonce: str) -> int:
        if nonce in self.slot_of:
            return self.slot_of[nonce]
        if not self._free:
            raise RuntimeError(f"no free batch slots (capacity {self.slots})")
        slot = self._free.pop(0)
        self.slot_of[nonce] = slot
        self.pos[slot] = 0
        self.last_used[slot] = time.time()
        return slot

    def free_slot(self, nonce: str) -> None:
        self._buffer.pop(nonce, None)
        self._spec_stats.pop(nonce, None)
        stash = self._adopt.pop(nonce, None)
        if stash is not None:
            # a prefix hit whose prefill never committed (cancelled, starved)
            self.kv_pool.free_blocks(stash[1])
        slot = self.slot_of.pop(nonce, None)
        if slot is not None:
            if self.kv_pool is not None:
                # a finished request's blocks return to the free list
                tbl, self._tables[slot] = self._tables[slot], None
                self.kv_pool.release_table(tbl)
            self.counts[slot].zero_()
            if self.hist is not None:
                self.hist[slot].zero_()
            self.generators[slot] = None
            self.pos[slot] = 0
            self._free.append(slot)

    def end_session(self, nonce: str) -> None:
        self.free_slot(nonce)
        self.eng.end_session(nonce)

    def reset(self) -> None:
        for nonce in list(self.slot_of):
            self.free_slot(nonce)
        self.eng.sessions.clear()

    def sweep_sessions(self, ttl_s: float = 600.0) -> int:
        now = time.time()
        dead = [n for n, s in self.slot_of.items() if now - self.last_used[s] > ttl_s]
        for n in dead:
            self.free_slot(n)
        return len(dead) + self.eng.sweep_sessions()

    def close(self) -> None:
        self.reset()

    @property
    def sessions(self):  # adapter compatibility (membership checks)
        return self.slot_of

    def stats(self) -> dict:
        """Slot (and pool) occupancy, the decode-step count, the KV cache's
        form and bytes and the weights' (for /health)."""
        out = {
            "slots": self.slots,
            "active": len(self.slot_of),
            "decode_steps": self.decode_steps,
            "kv_mode": "dense" if self.kv_pool is None else "paged",
            "kv_ragged": self.kv_ragged,
            "kv_quant_bits": self.eng.kv_quant_bits,
            "kv_bytes": self._kv_bytes(),
            **self.eng.weight_stats(),
        }
        if self.kv_pool is not None:
            out.update(
                kv_pool_blocks=self.kv_pool.total,
                kv_blocks_used=self.kv_pool.used,
                kv_blocks_free=self.kv_pool.free,
                kv_blocks_peak=self.kv_pool.peak_used,
            )
        if self.paged_prefix is not None:
            out["prefix_cache"] = dict(
                self.paged_prefix.stats, entries=len(self.paged_prefix),
                blocks=self.paged_prefix.held_blocks(),
                shared_blocks=self.kv_pool.shared_blocks, cow_copies=self.kv_pool.cow_copies,
            )
        elif self.eng.prefix_cache is not None:
            out["prefix_cache"] = dict(self.eng.prefix_cache.stats, entries=len(self.eng.prefix_cache))
        if self.spec_lookahead > 0:
            out.update(spec_lookahead=self.spec_lookahead, spec_blocks=self.spec_blocks,
                       spec_lane_blocks=self.spec_lane_blocks, spec_emitted=self.spec_emitted)
        return out

    # ---- prefix cache -------------------------------------------------
    def seed_from_prefix(self, nonce, full_ids, seed=None) -> int:
        """A new request's prefix-cache entry.  Dense slots: the inner
        engine's snapshot restores its staging session.  Paged slots: a
        hit's blocks are held for this request's page table (full blocks
        aliased, no copy) and its staging session starts from them,
        gathered into a dense row, at the hit's length.  Returns the tokens
        covered (0 on a miss, without a cache, or when the session already
        exists)."""
        if self.kv_pool is None:
            return self.eng.seed_from_prefix(nonce, full_ids, seed)
        if self.paged_prefix is None or nonce in self.eng.sessions:
            return 0
        full = list(full_ids)
        hit = self.paged_prefix.lookup_blocks(full)
        if hit is None:
            return 0
        n, blocks, n_full = hit
        self.eng._restore_session(nonce, full, n, self.kv_store.gather_row(blocks, self.max_seq), seed)
        self._adopt[nonce] = (n, blocks, n_full)
        return n

    def store_prefix(self, nonce, full_ids) -> None:
        """Snapshot `full_ids`' KV into the prefix cache: an adopted slot's
        live page table is aliased (zero copies); a prompt still staging
        commits its tail blocks, aliasing a parent entry's full blocks.
        Dense slots: the inner engine snapshots a staging session."""
        if self.kv_pool is None:
            return self.eng.store_prefix(nonce, full_ids)
        if self.paged_prefix is None:
            return
        full = list(full_ids)
        slot = self.slot_of.get(nonce)
        if slot is not None and self._tables[slot] is not None and int(self.pos[slot]) == len(full):
            self.paged_prefix.store_blocks(full, len(full), self._tables[slot].blocks)
            return
        sess = self.eng.sessions.get(nonce)
        if sess is not None and sess.kv is not None and sess.pos == len(full):
            self.paged_prefix.store(full, sess.kv)

    def _held_full_blocks(self, nonce) -> int:
        """Full blocks a prefix hit already holds for this request: only
        these count as covered at admission (a shared partial tail block is
        copied into a fresh one)."""
        return self._adopt.get(nonce, (0, [], 0))[2]

    # ---- prefill ------------------------------------------------------
    def reserve_slot(self, nonce) -> None:
        """Claim a batch slot before chunked prefill burns any compute."""
        self.alloc_slot(nonce)

    def prefill_chunk(self, nonce, ids, seed=None) -> torch.Tensor:
        """One prompt chunk on the B=1 engine (continuing the session when it
        exists); returns last-position logits.  The adapter interleaves these
        with batched decode steps so a long prompt never stalls active lanes
        for its whole prefill.  The pool must be able to cover the prompt so
        far: a doomed long prompt stops before its remaining chunks."""
        if self.kv_pool is not None:
            sess = self.eng.sessions.get(nonce)
            pos = 0 if sess is None else int(sess.pos)
            need = self._kv_cfg.blocks_for(min(pos + len(ids), self.max_seq))
            self.kv_pool.require(max(need - self._held_full_blocks(nonce), 0))
        # the full prompt's snapshot is the caller's (store_prefix)
        return self.eng.prefill(nonce, list(ids), seed, allow_store=False)

    def abandon_prefill(self, nonce) -> None:
        """Drop a half-prefilled request (cancelled mid-chunks)."""
        self.free_slot(nonce)
        self.eng.end_session(nonce)

    def _sample_session(self, sess, logits: torch.Tensor, decoding: DecodingParams) -> SampleResult:
        return self.eng._sample_with_counts(
            sess, logits, SampleParams.from_decoding(decoding, self.device),
            SamplePlan.from_decoding(decoding),
        )

    def adopt_prefilled(self, nonce, logits, decoding: DecodingParams) -> SampleResult:
        """Sample the first token from a fully chunk-prefilled session and
        move its KV and sampling state into this request's batch slot."""
        sess = self.eng.sessions[nonce]
        res = self._sample_session(sess, logits, decoding)
        self._move_to_slot(nonce, sess)
        return res

    def _commit_paged_slot(self, nonce: str, slot: int, sess) -> None:
        """Turn a staged B=1 prefill into this slot's page table: a prefix
        hit's full blocks stay in place, and every block from the first
        unshared one commits out of the staged dense row (all or nothing),
        which already merged a shared partial block with the new tokens:
        the copy-on-write."""
        cfg = self._kv_cfg
        nb = cfg.blocks_for(int(sess.pos))
        stash = self._adopt.pop(nonce, None)
        n_sh, blocks, n_full = stash if stash is not None else (0, [], 0)
        try:
            own = self.kv_pool.alloc(nb - n_full)
        except KVPoolExhausted:
            if stash is not None:
                self._adopt[nonce] = stash  # abandon_prefill releases it
            raise
        self.kv_store.commit_row(sess.kv, list(range(n_full, nb)), own)
        if stash is not None:
            if n_sh % cfg.block_tokens:
                self.kv_pool.count_cow()
            self.kv_pool.free_blocks(blocks[n_full:])  # the transient hold
        # a re-prefilled nonce keeps its slot: drop the superseded table
        self.kv_pool.release_table(self._tables[slot])
        self._tables[slot] = PageTable(blocks=list(blocks[:n_full]) + own)

    def _move_to_slot(self, nonce: str, sess) -> None:
        slot = self.alloc_slot(nonce)
        if self.kv_pool is not None:
            self._commit_paged_slot(nonce, slot, sess)
        else:
            # the staged row's live slots, codes and scales alike (a W-row
            # ring whole once it has wrapped: staging and slot both hold
            # position p at p % W); the slot's later rows keep stale values
            # that no length ever reaches
            n = int(sess.pos)
            for path, big in tree_leaves(self.kv):
                m = min(n, big.shape[2])
                big[:, slot, :m] = tree_get(sess.kv, path)[:, 0, :m]
        self.counts[slot] = sess.counts[0]
        if self.hist is not None and sess.hist is not None:
            self.hist[slot] = sess.hist[0]  # the prompt the staging prefill committed
        self.generators[slot] = sess.generator
        self.pos[slot] = sess.pos
        self.last_used[slot] = time.time()
        self.eng.end_session(nonce)  # the staging row is no longer needed

    def prefill_and_sample(
        self, nonce: str, prompt_ids: Sequence[int], decoding: DecodingParams
    ) -> SampleResult:
        """Prefill on the B=1 engine (from a prefix hit where there is one),
        then move the session's KV row and sampling state into this
        request's batch slot, and store the prompt in the prefix cache (on
        dense slots the inner engine's prefill looks up and stores)."""
        self.alloc_slot(nonce)  # fail on a full slot pool BEFORE burning prefill
        full = list(prompt_ids)
        if self.kv_pool is None:
            try:
                res = self.eng.prefill_and_sample(nonce, full, decoding)
                self._move_to_slot(nonce, self.eng.sessions[nonce])
            except Exception:
                self.abandon_prefill(nonce)
                raise
            return res
        try:
            n = self.seed_from_prefix(nonce, full, decoding.seed)
            # admission: the pool must cover the uncovered prompt before prefill burns
            need = self._kv_cfg.blocks_for(min(len(full), self.max_seq))
            self.kv_pool.require(max(need - self._held_full_blocks(nonce), 0))
            logits = self.eng.prefill(nonce, full[n:], decoding.seed, allow_store=False)
            res = self._sample_session(self.eng.sessions[nonce], logits, decoding)
            self._move_to_slot(nonce, self.eng.sessions[nonce])
        except Exception:
            self.abandon_prefill(nonce)
            raise
        self.store_prefix(nonce, full)
        return res

    # ---- decode -------------------------------------------------------
    def decode_batch(
        self,
        requests: Dict[str, Tuple[int, DecodingParams]],
        budgets: Optional[Dict[str, Optional[int]]] = None,
    ) -> Tuple[Dict[str, SampleResult], Dict[str, str]]:
        """One batched decode step for every (nonce -> last token) request.
        Slots not in `requests` stay frozen.  Returns (results, per-nonce
        errors): a request whose slot vanished, hit max_seq or cannot get a
        block fails alone.

        `budgets` (nonce -> tokens the request will still accept) widen the
        dispatch into an R-step chunk: active lanes chain their sampled
        tokens on the device and the extra results buffer here, resolving
        later calls at once.  The active set is fixed across a chunk, so the
        stream equals R serial steps with the same request set."""
        errors: Dict[str, str] = {}
        if not requests:
            return {}, errors
        # buffered tokens from an earlier chunk resolve first
        out: Dict[str, SampleResult] = {}
        now = time.time()
        for nonce in list(requests):
            buf = self._buffer.get(nonce)
            if buf:
                out[nonce] = buf.pop(0)
                slot = self.slot_of.get(nonce)
                if slot is not None:
                    self.last_used[slot] = now
        requests = {n: r for n, r in requests.items() if n not in out}
        if not requests:
            return out, errors
        # per-lane speculation: greedy lanes with budget to spare verify a
        # drafted block instead of stepping once, each advancing by its own
        # accepted count; the other lanes take the plain step below
        if self.spec_lookahead > 0 and budgets:
            spec_reqs = {}
            for nonce, (tok, dec) in requests.items():
                slot = self.slot_of.get(nonce)
                budget = budgets.get(nonce) or 1
                if (
                    slot is not None
                    and dec.temperature == 0.0
                    and not dec.logprobs
                    and dec.repetition_penalty == 1.0
                    and not dec.logit_bias  # the verify's argmaxes are unbiased
                    and budget > 1
                    and self.pos[slot] + self.spec_lookahead + 1 <= self.max_seq
                    and self._spec_worthwhile(nonce)
                ):
                    spec_reqs[nonce] = (tok, slot, budget)
            if spec_reqs:
                out.update(self._decode_spec_lanes(spec_reqs))
                requests = {n: r for n, r in requests.items() if n not in spec_reqs}
                if not requests:
                    return out, errors
        token = np.zeros((self.slots, 1), dtype=np.int64)
        active = np.zeros(self.slots, dtype=bool)
        decs: Dict[int, DecodingParams] = {}
        order: Dict[str, int] = {}
        for nonce, (tok, dec) in requests.items():
            slot = self.slot_of.get(nonce)
            if slot is None:
                errors[nonce] = f"request {nonce!r} has no batch slot (cancelled?)"
                continue
            if self.pos[slot] >= self.max_seq:
                errors[nonce] = f"sequence length {self.pos[slot]} reached max_seq {self.max_seq}"
                continue
            token[slot, 0] = tok
            active[slot] = True
            decs[slot] = dec
            order[nonce] = slot
        if not order:
            return out, errors
        # chunk width: bounded by the smallest remaining budget and by every
        # active lane's sequence capacity
        R = 1
        if budgets:
            cap = min((budgets.get(n) or 1) for n in order)
            cap = min(cap, *(int(self.max_seq - self.pos[s]) for s in order.values()))
            R = next((r for r in self.CHUNK_BUCKETS if r <= cap), 1)
        if self.kv_pool is not None:
            # block-table extension is admission: a lane the pool cannot
            # cover fails alone with the typed backpressure message
            R = self._paged_extend(order, errors, active, R)
            if not order:
                return out, errors
        # phase attribution fences its boundaries only while obs is on
        attribute = obs_enabled()
        t0 = time.perf_counter()
        lanes = sorted(order.values())
        if self.kv_pool is None:
            dispatch = self._dispatch_dense
        else:
            dispatch = self._dispatch_ragged if self.kv_ragged else self._dispatch_gather
        packed, with_lp = dispatch(order, lanes, active, R, token, decs, attribute)
        self.last_dispatch_ms = (time.perf_counter() - t0) * 1000.0
        # ONE device-to-host read per dispatch, then host-side slicing
        t_read = time.perf_counter()
        arr = packed.cpu().numpy()  # [R, lanes, 1, W]
        if attribute:
            self._observe_phase(PHASE_SAMPLE, t_read, order, R)
        toks = arr[..., 0].astype(np.int32)
        if with_lp:
            M = MAX_TOP_LOGPROBS
            lps = arr[..., 1]
            tts = arr[..., 2 : 2 + M].astype(np.int32)
            tlps = arr[..., 2 + M : 2 + 2 * M]
        else:
            lps = np.zeros(toks.shape, np.float32)
            tts = np.zeros(toks.shape + (MAX_TOP_LOGPROBS,), np.int32)
            tlps = np.zeros(toks.shape + (MAX_TOP_LOGPROBS,), np.float32)
        now = time.time()
        nonce_of = {s: n for n, s in order.items()}
        for i, slot in enumerate(lanes):
            nonce = nonce_of[slot]
            self.pos[slot] += R
            self.last_used[slot] = now
            rows = [SampleResult(toks[k, i], lps[k, i], tts[k, i], tlps[k, i]) for k in range(R)]
            out[nonce] = rows[0]
            if R > 1:
                self._buffer.setdefault(nonce, []).extend(rows[1:])
        # the dispatch's wall time over the tokens it served, observed that
        # many times: the count is the tokens served on every path
        n_tok = R * len(order)
        _DECODE_STEP_MS.observe_n((time.perf_counter() - t0) * 1000.0 / n_tok, n_tok)
        return out, errors

    def _observe_phase(self, phase: str, t0: float, order: Dict[str, int], R: int) -> None:
        """One observation of `phase` since `t0` a dispatch, and a span on
        each participating request's timeline."""
        dur_ms = (time.perf_counter() - t0) * 1000.0
        _PHASE_MS.labels(phase=phase).observe(dur_ms)
        rec = get_recorder()
        for nonce in order:
            rec.span(nonce, phase, dur_ms, batch=len(order), chunk=R)

    def _paged_extend(self, order, errors, active, R: int) -> int:
        """Extend every stepping lane's page table to cover R more tokens.
        If the pool cannot cover the full chunk width, the whole dispatch
        shrinks to single steps and only lanes that cannot get even one
        block fail, alone, with the typed backpressure message."""
        while True:
            appended: Dict[int, List[int]] = {}
            for nonce, slot in list(order.items()):
                try:
                    appended[slot] = self.kv_pool.ensure(self._tables[slot], int(self.pos[slot]) + R)
                except KVPoolExhausted as exc:
                    if R > 1:
                        break  # shrink the chunk and re-try every lane
                    errors[nonce] = str(exc)
                    active[slot] = False
                    del order[nonce]
            else:
                return R
            # roll the failed wide pass back before retrying at R=1: a lane's
            # unused hoard (blocks past its next single step) must not starve
            # the lanes after it in the retry
            for slot, fresh in appended.items():
                tbl = self._tables[slot]
                keep = max(
                    len(tbl.blocks) - len(fresh),
                    self._kv_cfg.blocks_for(int(self.pos[slot]) + 1),
                )
                if keep < len(tbl.blocks):
                    self.kv_pool.free_blocks(tbl.blocks[keep:])
                    del tbl.blocks[keep:]
            R = 1

    def _table_ids(self, order: Optional[Dict[str, int]] = None) -> np.ndarray:
        """[slots, nb] physical block ids, 0-padded past each table (entries
        the kernel never reads: each slot's loop stops at its live length).
        With `order` (an R == 1 dispatch's active lanes), nb is the pow2
        bucket of the widest active table instead of max_seq / bt; frozen
        lanes' longer tables truncate harmlessly, since they attend nothing."""
        nb = self.max_seq // self._kv_cfg.block_tokens
        if order:
            widest = max(
                (len(self._tables[s].blocks) for s in order.values() if self._tables[s] is not None),
                default=1,
            )
            nb = min(_bucket_pow2(max(widest, 1)), nb)
        ids = np.zeros((self.slots, nb), dtype=np.int32)
        for slot, tbl in enumerate(self._tables):
            if tbl is not None and tbl.blocks:
                n = min(len(tbl.blocks), nb)
                ids[slot, :n] = tbl.blocks[:n]
        return ids

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _ragged_step(self, token, tables, pos, max_live: int):
        """One batched forward against the pool (read-only here): logits
        [slots, V] and the stacked per-layer new K/V rows [L, slots, KVH, Hd]
        for the caller to append."""
        m = self.model
        ep = self.eng.edge_params

        def attend_fn(q, k, v, kvs):
            # the kernel reads dense rows; these are views of fresh tensors
            k_new, v_new = k[:, 0].contiguous(), v[:, 0].contiguous()
            attn = paged_attend(q.contiguous(), kvs["k"], kvs["v"], tables, pos, k_new, v_new,
                                max_live=max_live)
            return attn, {"k": k_new, "v": v_new}

        x = m.embed(ep, token)  # [slots, 1, D]
        x, rows = m.apply_window(self.eng.window_params, x, self.kv_store.kv, pos[:, None],
                                 attend_fn=attend_fn)
        x = m.normalize(ep, x[:, -1:])
        return m.lm_project(ep, x)[:, 0], rows

    def _lane_inputs(self, lanes: List[int], active: np.ndarray, token: np.ndarray,
                     decs: Dict[int, DecodingParams]):
        """A dispatch's device inputs: per-slot positions (0 for inactive
        lanes) on the host and the device, the active mask as a 0/1 step,
        the tokens, the active lane indices, and each lane's sampling."""
        pos = np.zeros(self.slots, dtype=np.int32)
        pos[lanes] = self.pos[lanes]
        sampling = [
            LaneSampling(s, SampleParams.from_decoding(decs[s], self.device),
                         SamplePlan.from_decoding(decs[s]), self.generators[s])
            for s in lanes
        ]
        return (pos, self._to_device(pos), self._to_device(active.astype(np.int32)),
                self._to_device(token), self._to_device(np.asarray(lanes, dtype=np.int64)), sampling)

    def _dispatch_ragged(self, order: Dict[str, int], lanes: List[int], active: np.ndarray, R: int,
                         token: np.ndarray, decs: Dict[int, DecodingParams], attribute: bool = False):
        """Queue R decode steps for the active `lanes` on the device: each
        step attends the pool through the page tables, samples every active
        lane, appends the lanes' new rows at their positions, and feeds the
        sampled tokens to the next step.  Returns the steps' results packed
        [R, lanes, 1, W] (still on the device) and whether W holds logprobs."""
        bt = self._kv_cfg.block_tokens
        tables = self._to_device(self._table_ids(order if R == 1 else None))
        pos, pos_t, step_t, tok, lane_t, sampling = self._lane_inputs(lanes, active, token, decs)
        with_lp = any(ls.plan.logprobs for ls in sampling)
        max_live = int(pos.max()) + R - 1
        steps = []
        t0 = time.perf_counter()
        for r in range(R):
            logits, rows = self._ragged_step(tok, tables, pos_t, max_live)
            res = sample_lanes(logits, sampling, self.counts)
            steps.append(pack_chunk_results(res, with_lp))
            p = self.pos[lanes] + r
            phys = [self._tables[s].blocks[int(q) // bt] for s, q in zip(lanes, p)]
            self.kv_store.append_rows(rows, lanes, phys, (p % bt).tolist())
            self.decode_steps += 1
            if r + 1 < R:
                # active lanes chain their sampled token on the device
                tok = tok.clone()
                tok[lane_t, 0] = torch.cat([x.token for x in res]).long()
                pos_t = pos_t + step_t
        packed = torch.stack(steps)
        if attribute:
            # the pool is attended in place: the whole dispatch is compute
            fence(self.device)
            self._observe_phase(PHASE_COMPUTE, t0, order, R)
        return packed, with_lp

    def _dense_step(self, kv: dict, token, pos, step: LaneStep) -> torch.Tensor:
        """One batched forward over dense slots `kv` (the slots' cache, or a
        gathered view of the pool): each layer writes the active lanes' new
        K/V rows at their positions (codes and scales together on a
        quantized cache; a ring at p % W), then the decode kernel attends
        each lane's [0, lengths[b]) slots.  Returns logits [slots, V]."""
        m = self.model
        ep = self.eng.edge_params

        def attend_fn(q, k, v, kvs, sinks=None, scale=None, window=0):
            attn = lane_cached_attend(q, k, v, kvs, step, sinks=sinks, scale=scale, window=window)
            return attn, {}  # written in place: nothing for apply_window to stack

        x = m.embed(ep, token)  # [slots, 1, D]
        x, _ = m.apply_window(self.eng.window_params, x, kv, pos[:, None], attend_fn=attend_fn)
        x = m.normalize(ep, x[:, -1:])
        return m.lm_project(ep, x)[:, 0]

    def _dispatch_gather(self, order: Dict[str, int], lanes: List[int], active: np.ndarray, R: int,
                         token: np.ndarray, decs: Dict[int, DecodingParams], attribute: bool = False):
        """The dense-gather paged decode: gather the page tables into a dense
        view (a single step at the pow2 bucket of the widest active table,
        an R-step chunk at max_seq), run the R dense steps over it, and
        scatter back each active lane's blocks p0 // bt .. (p0 + R - 1) //
        bt, which copy-on-write has made private (a block shared through the
        prefix cache is never written).  Returns what _dispatch_dense
        does."""
        t0 = time.perf_counter()
        view = self.kv_store.gather(self._table_ids(order if R == 1 else None))
        if attribute:
            fence(self.device)
            self._observe_phase(PHASE_KV_GATHER, t0, order, R)
        out = self._dense_steps(view, lanes, active, R, token, decs, order if attribute else None)
        bt = self._kv_cfg.block_tokens
        triples = []
        for slot in lanes:
            p0, blocks = int(self.pos[slot]), self._tables[slot].blocks
            triples.extend((slot, b, blocks[b]) for b in range(p0 // bt, (p0 + R - 1) // bt + 1))
        t0 = time.perf_counter()
        self.kv_store.scatter(view, triples)
        if attribute:
            fence(self.device)
            self._observe_phase(PHASE_KV_SCATTER, t0, order, R)
        return out

    def _dispatch_dense(self, order: Dict[str, int], lanes: List[int], active: np.ndarray, R: int,
                        token: np.ndarray, decs: Dict[int, DecodingParams], attribute: bool = False):
        return self._dense_steps(self.kv, lanes, active, R, token, decs, order if attribute else None)

    def _dense_steps(self, kv: dict, lanes: List[int], active: np.ndarray, R: int, token: np.ndarray,
                     decs: Dict[int, DecodingParams], attribute: Optional[Dict[str, int]] = None):
        """Queue R decode steps for the active `lanes` over dense slots `kv`:
        each step writes and attends the lanes' rows, samples every active
        lane and feeds the sampled tokens to the next step.  Returns the
        steps' results packed [R, lanes, 1, W] (still on the device) and
        whether W holds logprobs.  `attribute` (the dispatch's nonce ->
        slot order, under obs) fences the steps and observes them as the
        compute phase."""
        pos, pos_t, step_t, tok, lane_t, sampling = self._lane_inputs(lanes, active, token, decs)
        with_lp = any(ls.plan.logprobs for ls in sampling)
        # the chunk's longest lane ends at position max + R - 1
        max_live = int(pos.max()) + R
        lane_pos = pos_t[lane_t].long()
        steps = []
        t0 = time.perf_counter()
        for r in range(R):
            lengths = (pos_t + 1) * step_t  # 0 for an idle lane
            logits = self._dense_step(kv, tok, pos_t, LaneStep(lane_t, lane_pos, lengths, max_live))
            res = sample_lanes(logits, sampling, self.counts)
            steps.append(pack_chunk_results(res, with_lp))
            self.decode_steps += 1
            if r + 1 < R:
                tok = tok.clone()
                tok[lane_t, 0] = torch.cat([x.token for x in res]).long()
                pos_t = pos_t + step_t
                lane_pos = lane_pos + 1
        packed = torch.stack(steps)
        if attribute is not None:
            fence(self.device)
            self._observe_phase(PHASE_COMPUTE, t0, attribute, R)
        return packed, with_lp

    # ---- speculation ----------------------------------------------------
    def _spec_worthwhile(self, nonce: str) -> bool:
        """LocalEngine.spec_worthwhile's gate on this request's counts."""
        st = self._spec_stats.get(nonce)
        if st is None or st[0] < self.SPEC_WARMUP_BLOCKS:
            return True
        return st[1] / st[0] >= self.SPEC_MIN_TOKENS_PER_BLOCK

    def _decode_spec_lanes(self, spec_reqs: Dict[str, Tuple[int, int, int]]) -> Dict[str, SampleResult]:
        """One verify block over the speculating lanes (nonce -> (fed token,
        slot, budget)): each commits its fed token to its history row,
        drafts L tokens by prompt lookup there and writes them too; then
        ONE forward over every slot's L+1 rows (lanes that do not speculate
        ride along, neither written nor read back) verifies them, and each
        lane emits its agreeing prefix plus the first correction (at most
        its budget).  The first token returns now, the rest buffer."""
        L = self.spec_lookahead
        m, ep = self.model, self.eng.edge_params
        t_blk = time.perf_counter()
        lanes = sorted(slot for _tok, slot, _b in spec_reqs.values())
        tok = np.zeros(self.slots, dtype=np.int64)
        pos = np.zeros(self.slots, dtype=np.int64)
        for _nonce, (t, slot, _b) in spec_reqs.items():
            tok[slot], pos[slot] = t, self.pos[slot]
        lane_t = self._to_device(np.asarray(lanes, dtype=np.int64))
        start_t = self._to_device(pos[lanes])
        fed = self._to_device(tok[lanes])[:, None]  # [n, 1]
        # the lanes' history rows: the fed token at pos, the drafts after it
        hist = commit_history(self.hist[lane_t], start_t, fed)
        drafts = ngram_draft(hist, start_t + 1, L)  # [n, L], on the device
        self.hist[lane_t] = commit_history(hist, start_t + 1, drafts)
        block = torch.zeros((self.slots, L + 1), dtype=torch.int64, device=self.device)
        block[lane_t] = torch.cat([fed, drafts], dim=1)
        chunk = LaneChunk(lane_t, start_t[:, None] + torch.arange(L + 1, device=self.device),
                          self._to_device(pos.astype(np.int32)), int(pos.max()))

        def attend_fn(q, k, v, kvs, sinks=None, scale=None, window=0):
            return lane_chunk_attend(q, k, v, kvs, chunk, sinks=sinks, scale=scale, window=window), {}

        x = m.embed(ep, block)
        x, _ = m.apply_window(self.eng.window_params, x, self.kv, self._to_device(pos)[:, None],
                              attend_fn=attend_fn)
        preds = m.lm_project(ep, m.normalize(ep, x[lane_t])).argmax(dim=-1)  # [n, L+1]
        out_h = accept_drafts(preds, drafts)[1].cpu().numpy()  # -1 past each lane's acceptance
        self.spec_blocks += 1
        self.spec_lane_blocks += len(lanes)
        now = time.time()
        zero_lp = np.zeros((1,), np.float32)
        zero_tt = np.zeros((1, MAX_TOP_LOGPROBS), np.int32)
        zero_tlp = np.zeros((1, MAX_TOP_LOGPROBS), np.float32)
        blk_ms = (time.perf_counter() - t_blk) * 1000.0
        res: Dict[str, SampleResult] = {}
        total_emitted = 0
        for nonce, (_t, slot, budget) in spec_reqs.items():
            row = out_h[lanes.index(slot)]
            emitted = min(int((row >= 0).sum()), budget)
            total_emitted += emitted
            rows = [SampleResult(row[i : i + 1].astype(np.int32), zero_lp, zero_tt, zero_tlp)
                    for i in range(emitted)]
            self.pos[slot] += emitted
            self.last_used[slot] = now
            st = self._spec_stats.setdefault(nonce, [0, 0])
            st[0] += 1
            st[1] += emitted
            self.spec_emitted += emitted
            res[nonce] = rows[0]
            if rows[1:]:
                self._buffer.setdefault(nonce, []).extend(rows[1:])
        # the block's wall time over every accepted token, as a plain dispatch
        _DECODE_STEP_MS.observe_n(blk_ms / max(total_emitted, 1), total_emitted)
        return res

    def generate(
        self,
        prompt_ids: Sequence[int],
        decoding: Optional[DecodingParams] = None,
        max_tokens: int = 256,
        eos_token_ids: Optional[set] = None,
        nonce: str = "batched",
    ):
        """Single-sequence loop over the batched step (tests; parity with
        LocalEngine.generate)."""
        decoding = decoding or DecodingParams()
        eos = eos_token_ids or set()
        self.end_session(nonce)
        res = self.prefill_and_sample(nonce, prompt_ids, decoding)
        token = int(res.token[0])
        yield self.token_result(nonce, res, step=0, decoding=decoding)
        if token in eos:
            self.end_session(nonce)
            return
        for step in range(1, max_tokens):
            if self.pos[self.slot_of[nonce]] >= self.max_seq:
                break
            res_map, errs = self.decode_batch({nonce: (token, decoding)})
            if errs:
                raise RuntimeError(errs[nonce])
            res_row = res_map[nonce]
            token = int(res_row.token[0])
            yield self.token_result(nonce, res_row, step=step, decoding=decoding)
            if token in eos:
                break
        self.end_session(nonce)
