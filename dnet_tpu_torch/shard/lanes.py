"""Batched lanes for the ring: N concurrent requests a ring pass.

Counterpart of dnet_tpu/shard/lanes.py `LanePool`.  The API coalesces
concurrent requests' decode steps into multi-lane frames (api/ring.py), and
each shard serves every member with one batched step over a pooled dense
KV cache of `slots` rows: `init_kv`'s layout at `slots` rows (the quantized
caches' codes and scales, gpt_oss's W-row rings).  A request prefills on
the shard engine's B=1 session; its first lane frame adopts the session's
KV row, position, random generator and repetition counts into a free lane,
so its stream continues exactly as its solo session's would.

A step is the batched engine's dense step applied to a ring shard's range
(core/batch.py `_dense_step`): `apply_window`'s lane hook writes the active
lanes' new K/V rows at their positions and attends every lane over its
lengths vector with one decode-kernel launch a layer (`lane_cached_attend`:
the rotating lane form on a ring, the (192, 128) form at deepseek_v2's
widths); inactive lanes are untouched and advance nothing.  The head embeds
the members' tokens, the tail normalizes, projects and samples each active
lane with its own knobs and generator (`sample_lanes`), a one-shard ring
does both.  A faulted member (no session to adopt, a stale position, a
full pool, a duplicate) is flagged on its lane dict, which rides the
remaining hops, and fails alone.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dnet_tpu_torch.core.sampler import LaneSampling, SampleParams, SamplePlan, SampleResult, sample_lanes
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.kv.store import tree_get, tree_leaves
from dnet_tpu_torch.ops.attention import LaneStep, lane_cached_attend
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()


class LanePool:
    """Pooled per-lane KV and sampling state, and the batched steps."""

    def __init__(self, engine, slots: int) -> None:
        if slots < 2:
            raise ValueError(f"lanes need >= 2 slots, got {slots}")
        if engine.plan.streams_weights:
            raise NotImplementedError("batched lanes need resident weights (fit policy)")
        if not engine.model.supports_kv_commit:
            raise NotImplementedError(f"batched lanes not supported for {engine.config.model_type} (no gated KV writes)")
        self.eng = engine
        self.model = engine.model
        self.slots = slots
        self.max_seq = engine.max_seq
        self.device = engine.device
        m = self.model
        self.kv = m.init_kv(len(m.layers), slots, self.max_seq, engine.kv_dtype, engine.kv_quant_bits)
        self.counts = torch.zeros((slots, engine.config.vocab_size), dtype=torch.int32, device=self.device)
        self.generators: List[Optional[torch.Generator]] = [None] * slots
        self.pos = np.zeros(slots, dtype=np.int64)
        self.last_used = np.zeros(slots, dtype=np.float64)
        self.slot_of: Dict[str, int] = {}
        self._free: List[int] = list(range(slots))

    # ---- lane lifecycle ----------------------------------------------
    def adopt(self, nonce: str) -> int:
        """Move the nonce's prefilled B=1 session into a free lane: its live
        KV rows (codes and scales alike; a W-row ring whole once it has
        wrapped), position, generator and repetition counts."""
        slot = self.slot_of.get(nonce)
        if slot is not None:
            return slot
        sess = self.eng.sessions.get(nonce)
        if sess is None:
            raise ValueError(f"no prefilled session for {nonce!r} to adopt")
        if not self._free:
            raise RuntimeError(f"no free lanes (capacity {self.slots})")
        slot = self._free.pop(0)
        self.slot_of[nonce] = slot
        n = int(sess.pos)
        for path, big in tree_leaves(self.kv):
            rows = min(n, big.shape[2])
            big[:, slot, :rows] = tree_get(sess.kv, path)[:, 0, :rows]
        self.counts[slot] = sess.counts[0]
        self.generators[slot] = sess.generator
        self.pos[slot] = n
        self.last_used[slot] = time.time()
        self.eng.end_session(nonce)  # the B=1 row is dead weight now
        return slot

    def release(self, nonce: str) -> None:
        """Host bookkeeping only: a reset arrives on the event loop while a
        step may be running on the compute thread, and adopt overwrites a
        lane's rows, counts and generator for its next owner."""
        slot = self.slot_of.pop(nonce, None)
        if slot is not None:
            self.pos[slot] = 0
            self._free.append(slot)

    def reset(self) -> None:
        for nonce in list(self.slot_of):
            self.release(nonce)

    def sweep(self, ttl_s: float) -> int:
        now = time.time()
        dead = [n for n, s in self.slot_of.items() if now - self.last_used[s] > ttl_s]
        for n in dead:
            self.release(n)
        return len(dead)

    # ---- batched step -------------------------------------------------
    def _scatter(self, msg) -> list:
        """Each member's lane (None for a faulted member, its lane dict then
        carrying the error), adopting members on their first frame."""
        order: List[Optional[int]] = []
        used: set = set()
        for lane in msg.lanes:
            if lane.get("error"):  # faulted on an earlier shard
                order.append(None)
                continue
            nonce = lane["nonce"]
            try:
                slot = self.slot_of.get(nonce)
                if slot is None:
                    slot = self.adopt(nonce)
                lpos = int(lane["pos"])
                if lpos != self.pos[slot]:
                    raise ValueError(f"frame pos {lpos} != lane pos {int(self.pos[slot])} (stale or out-of-order frame)")
                if lpos >= self.max_seq:
                    raise ValueError(f"sequence length {lpos} reached max_seq {self.max_seq}")
                if slot in used:
                    raise ValueError("duplicate nonce in a batch frame")
            except Exception as exc:
                log.warning("lane %s faulted: %s", nonce, exc)
                lane["error"] = str(exc)
                order.append(None)
                continue
            used.add(slot)
            order.append(slot)
        return order

    def _forward(self, x: torch.Tensor, lanes: List[int]) -> torch.Tensor:
        """This range's layers over x [slots, 1, D] for the active `lanes`
        at their positions (one decode-kernel launch a layer)."""
        pos = np.zeros(self.slots, dtype=np.int32)
        pos[lanes] = self.pos[lanes]
        active = np.zeros(self.slots, dtype=np.int32)
        active[lanes] = 1
        dev = self.device
        pos_t = torch.from_numpy(pos).to(dev, non_blocking=True)
        step_t = torch.from_numpy(active).to(dev, non_blocking=True)
        lane_t = torch.tensor(lanes, dtype=torch.int64, device=dev)
        step = LaneStep(lane_t, pos_t[lane_t].long(), (pos_t + 1) * step_t, int(pos.max()) + 1)

        def attend_fn(q, k, v, kvs, sinks=None, scale=None, window=0):
            attn = lane_cached_attend(q, k, v, kvs, step, sinks=sinks, scale=scale, window=window)
            return attn, {}  # written in place: nothing for apply_window to stack

        x, _ = self.model.apply_window(self.eng.window_params, x, self.kv, pos_t[:, None], attend_fn=attend_fn)
        return x

    def _sample(self, msg, order: list, x: torch.Tensor) -> List[Optional[SampleResult]]:
        """The tail: each active lane normalized, projected and sampled with
        its own knobs, generator and counts; None for a faulted member."""
        m, ep = self.model, self.eng.edge_params
        logits = m.lm_project(ep, m.normalize(ep, x[:, -1:]))[:, 0]
        sampling = []
        for lane, slot in zip(msg.lanes, order):
            if slot is not None:
                dec = DecodingParams(**(lane.get("decoding") or {}))
                sampling.append(LaneSampling(slot, SampleParams.from_decoding(dec, self.device),
                                             SamplePlan.from_decoding(dec), self.generators[slot]))
        results = iter(sample_lanes(logits, sampling, self.counts))
        return [None if slot is None else next(results) for slot in order]

    def _advance(self, order: list) -> None:
        now = time.time()
        for slot in order:
            if slot is not None:
                self.pos[slot] += 1
                self.last_used[slot] = now

    def _run(self, msg, order: list, x: torch.Tensor, is_last: bool):
        lanes = [s for s in order if s is not None]
        x = self._forward(x, lanes)
        out = self._sample(msg, order, x) if is_last else x[[s if s is not None else 0 for s in order]]
        self._advance(order)
        return out

    def _inert(self, order: list, is_last: bool):
        """Every member faulted: the flagged lane dicts carry the errors,
        the rows are inert."""
        if is_last:
            return [None] * len(order)
        return torch.zeros((len(order), 1, self.eng.config.hidden_size), dtype=self.eng.param_dtype,
                           device=self.device)

    def step_entry(self, msg, tokens: np.ndarray, is_last: bool):
        """Head shard: the members' tokens [n, 1] in member order -> hidden
        [n, 1, D] (the ring continues) or per-member SampleResults (a
        one-shard ring)."""
        order = self._scatter(msg)
        if all(o is None for o in order):
            return self._inert(order, is_last)
        token_full = np.zeros((self.slots, 1), dtype=np.int64)
        for slot, row in zip(order, tokens):
            if slot is not None:
                token_full[slot] = row
        x = self.model.embed(self.eng.edge_params, torch.from_numpy(token_full).to(self.device))
        return self._run(msg, order, x, is_last)

    def step_hidden(self, msg, hidden: torch.Tensor, is_last: bool):
        """Middle or tail shard: hidden [n, 1, D] in member order."""
        order = self._scatter(msg)
        good = [i for i, o in enumerate(order) if o is not None]
        if not good:
            return self._inert(order, is_last)
        x = torch.zeros((self.slots, 1, hidden.shape[-1]), dtype=self.eng.param_dtype, device=self.device)
        x[[order[i] for i in good]] = hidden[good].to(self.eng.param_dtype)
        return self._run(msg, order, x, is_last)
