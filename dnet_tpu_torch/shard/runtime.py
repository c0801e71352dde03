"""ShardRuntime: the bounded ingress queue, the compute thread, and the
model's lifecycle.

Counterpart of dnet_tpu/shard/runtime.py: frames queue for ONE compute
thread (device work never runs on the event loop), results flow back to an
asyncio output queue, an expired request's frame is dropped at dequeue with
a payload-free error final, and idle KV sessions expire by TTL.  Each
frame's compute is a `shard_compute` span on the request's timeline (keyed
by its nonce), and a drop counts dnet_deadline_exceeded_total{stage=
"shard_dequeue"} with a `shed` event and a `deadline_drop` span, as the
reference's.  The chaos point `shard_compute` sits before each frame's
compute: an injected fault takes the path a real compute failure takes
(an error final upstream).  The topology epoch is pinned at load or by a
delta update (`set_epoch`) and published as dnet_topology_epoch.  A batch
frame's failure fails each member with its own error final.  A dropped
frame whose payload is a pipelined encode (output overflow, stop)
releases its encode-ring slot without a readback, and an overflow counts
dnet_shard_outq_dropped_total.
"""

from __future__ import annotations

import asyncio
import gc
import queue
import threading
import time
from typing import Optional

import torch

from dnet_tpu_torch.core.types import ActivationMessage
from dnet_tpu_torch.membership import set_epoch_gauge
from dnet_tpu_torch.obs import get_recorder, metric
from dnet_tpu_torch.obs.events import bind, log_event
from dnet_tpu_torch.resilience import chaos
from dnet_tpu_torch.shard.compute import ShardCompute, refuse_model, refuse_unsupported
from dnet_tpu_torch.transport.wire_pipeline import PendingWirePayload
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

_DEADLINE_EXCEEDED = metric("dnet_deadline_exceeded_total")
_OUTQ_DROPPED = metric("dnet_shard_outq_dropped_total")


def _error_final(msg: ActivationMessage, error: str, members: Optional[list] = None) -> ActivationMessage:
    """Payload-free error final for `msg`: the one shape every failure path
    emits upstream (compute failure, deadline drop, output overflow).
    `members` ({"nonce", "seq"} dicts: a batch frame's) fails each member
    alone; without it the frame's own nonce carries the error."""
    out = ActivationMessage(
        nonce=msg.nonce, layer_id=msg.layer_id, seq=msg.seq, dtype="error", shape=(),
        pos=msg.pos, callback_url=msg.callback_url, is_final=True, epoch=msg.epoch,
    )
    if members:
        out.lane_finals = [{"nonce": m["nonce"], "step": int(m["seq"]), "token_id": -1, "error": error}
                           for m in members]
    else:
        out.token_id, out.error = -1, error
    return out


class ShardRuntime:
    def __init__(self, shard_id: str, queue_size: int = 256, device=None) -> None:
        self.shard_id = shard_id
        self.device = device
        self.compute: Optional[ShardCompute] = None
        self.model_path: str = ""
        self.epoch: int = 0  # pinned at load; carried on every egress message
        self._model_lock = threading.Lock()
        self.recv_q: queue.Queue = queue.Queue(maxsize=queue_size)
        self.out_q: Optional[asyncio.Queue] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._pending_errs: set = set()  # awaited overflow-replacement puts
        # frames computed and their host time on the compute thread (the
        # window, the sample or the hop encode included), read by /health
        self.compute_stats = {"frames": 0, "ms": 0.0}

    # ---- lifecycle ------------------------------------------------------
    def start(self, loop: asyncio.AbstractEventLoop) -> None:
        self._loop = loop
        self.out_q = asyncio.Queue(maxsize=1024)
        self._stop.clear()
        self._thread = threading.Thread(target=self._compute_worker, name="shard-compute", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self.recv_q.put_nowait(None)  # wake the worker
        except queue.Full:  # it exits at the next poll
            pass
        # frames left in out_q may hold encode-ring slots nobody will
        # finalize now: release them, or a compute thread waiting in the
        # ring's acquire would outlast the join below
        if self.out_q is not None:
            while not self.out_q.empty():
                out = self.out_q.get_nowait()
                if isinstance(out.data, PendingWirePayload):
                    out.data.discard()
        if self._thread:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                log.warning("compute thread failed to join within 5s; leaving it as a daemon")
            self._thread = None

    # ---- model ----------------------------------------------------------
    def load_model_core(self, model_dir: str, layers: list, epoch: int = 0, **kwargs) -> None:
        """Blocking (call from an executor).  kwargs go to ShardCompute.  An
        option this shard does not serve raises before anything happens,
        and a model already loaded keeps serving."""
        refuse_unsupported(layers, **kwargs)
        refuse_model(model_dir, layers, **kwargs)
        with self._model_lock:
            t0 = time.perf_counter()
            if self.compute is not None:  # reload: free the old engine first
                self.compute.engine.close()
                self.compute = None
            kwargs.setdefault("device", self.device)
            self.compute = ShardCompute(model_dir, layers, **kwargs)
            self.model_path = str(model_dir)
            self._set_epoch_locked(epoch)
            log.info(
                "shard %s loaded layers %d..%d (epoch %d) in %.1fs",
                self.shard_id, min(layers), max(layers), self.epoch, time.perf_counter() - t0,
            )

    def set_epoch(self, epoch: int) -> None:
        """Pin the topology epoch this shard serves under (a delta update)
        and publish it.  Takes the model lock: an epoch write must not race
        a full reload pinning its own."""
        with self._model_lock:
            self._set_epoch_locked(epoch)

    def _set_epoch_locked(self, epoch: int) -> None:
        self.epoch = int(epoch)
        set_epoch_gauge(self.epoch)

    def unload_model_core(self) -> None:
        with self._model_lock:
            self._drain_queue()
            if self.compute is not None:
                self.compute.engine.close()
            self.compute = None
            self.model_path = ""
            self._set_epoch_locked(0)
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()

    def drain_ingress(self) -> None:
        """Drop every queued frame (a delta update: frames minted under the
        old epoch must not burn compute)."""
        self._drain_queue()

    def _drain_queue(self) -> None:
        try:
            while True:
                self.recv_q.get_nowait()
        except queue.Empty:
            pass

    # ---- data path --------------------------------------------------------
    def submit(self, msg: ActivationMessage, timeout: float = 5.0) -> bool:
        """From the event loop; bounded for backpressure."""
        try:
            self.recv_q.put(msg, timeout=timeout)
            return True
        except queue.Full:
            return False

    @property
    def queue_depth(self) -> int:
        return self.recv_q.qsize()

    def _compute_worker(self) -> None:
        while not self._stop.is_set():
            try:
                msg = self.recv_q.get(timeout=0.5)
            except queue.Empty:
                continue
            if msg is None:
                continue
            if self.compute is None:
                log.warning("dropping frame for %s: no model loaded", msg.nonce)
                continue
            # every log line and event of this frame carries its request
            with bind(rid=msg.nonce, node=self.shard_id, epoch=msg.epoch):
                self._process_frame(msg)

    def _process_frame(self, msg: ActivationMessage) -> None:
        compute = self.compute
        if compute is None:
            return
        if msg.deadline and time.time() >= msg.deadline:
            # nobody waits for this result any more: drop it before spending
            # compute, and fail the request fast upstream
            self._drop_expired(msg)
            return
        try:
            t0 = time.perf_counter()
            chaos.inject("shard_compute")
            out = compute.process(msg)
            dt_ms = (time.perf_counter() - t0) * 1e3
            self.compute_stats["frames"] += 1
            self.compute_stats["ms"] += dt_ms
            get_recorder().span(msg.nonce, "shard_compute", dt_ms, seq=msg.seq, layer_id=msg.layer_id)
            # the deadline and epoch ride every downstream hop
            out.deadline = msg.deadline
            out.epoch = msg.epoch
            self._emit(out)
        except Exception as exc:
            log.exception("compute failed for nonce %s", msg.nonce)
            # a batch frame's carrier has no request: fail every member
            self._emit(_error_final(msg, str(exc), msg.lanes))

    def _drop_expired(self, msg: ActivationMessage) -> None:
        _DEADLINE_EXCEEDED.labels(stage="shard_dequeue").inc()
        log_event("shed", reason="deadline", stage="shard_dequeue", seq=msg.seq)
        get_recorder().span(msg.nonce, "deadline_drop", 0.0, seq=msg.seq, deadline=msg.deadline)
        log.warning(
            "dropping expired frame for %s seq=%d (deadline %.3fs past)",
            msg.nonce, msg.seq, time.time() - msg.deadline,
        )
        self._emit(_error_final(msg, "deadline exceeded at shard dequeue", msg.lanes))

    def _emit(self, out: ActivationMessage) -> None:
        if self._loop is None or self.out_q is None:
            return
        self._loop.call_soon_threadsafe(self._put_out, out)

    def _put_out(self, out: ActivationMessage) -> None:
        try:
            self.out_q.put_nowait(out)
        except asyncio.QueueFull:
            # never lose a token silently: an error final takes its place,
            # through an awaited put that runs when egress frees a slot
            _OUTQ_DROPPED.inc()
            log.error("output queue full; dropping frame for %s seq=%d", out.nonce, out.seq)
            if isinstance(out.data, PendingWirePayload):
                out.data.discard()  # its encode-ring slot, without a readback
            # a dropped batch frame fails every member (lane finals name
            # theirs by `step`)
            members = out.lanes or [{"nonce": f["nonce"], "seq": f["step"]} for f in (out.lane_finals or [])]
            task = asyncio.ensure_future(
                self.out_q.put(_error_final(out, "shard output queue overflowed; frame dropped", members))
            )
            self._pending_errs.add(task)
            task.add_done_callback(self._pending_errs.discard)

    # ---- maintenance ------------------------------------------------------
    async def sweeper(self, interval_s: float = 30.0) -> None:
        while True:
            await asyncio.sleep(interval_s)
            if self.compute is not None:
                n = self.compute.sweep_sessions()
                if n:
                    log.info("swept %d expired KV sessions", n)
