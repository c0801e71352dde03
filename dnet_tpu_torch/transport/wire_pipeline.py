"""The overlapped wire pipeline (DNET_WIRE_PIPELINE=1).

Counterpart of dnet_tpu/transport/wire_pipeline.py.  Without it a shard's
compute thread pays the whole hop encode of step N (the codec's kernels,
the device-to-host readback and the byte packing) before it starts step
N + 1.  With it:

- tx: the compute thread only launches the encode (compression/wire.py
  `launch_encode`: the kernels, then copies into page-locked buffers and an
  event) and wraps it in a :class:`PendingWirePayload`; the adapter's
  egress worker has the :class:`WireTxStage`'s own thread wait on the event
  and pack the bytes, while the compute thread is already launching the
  next step.  The tx thread launches nothing.
- backpressure: a bounded :class:`EncodeRing` of `depth` slots (2 by
  default), each with its own page-locked buffers, lets the compute thread
  run at most `depth` launched but unsent frames ahead; past that `acquire` blocks until the tx stage releases a
  slot, and after 10 s it gives up and the caller encodes synchronously
  (the same kernels, logged), rather than deadlock.
- rx: ShardCompute.predecode, at adapter ingress, uploads a queued frame's
  compact buffers (page-locked, asynchronous) and launches its dequant +
  scatter from the event loop, so the frame's decode is queued on the
  card behind the step the compute thread is launching.

One CUDA stream carries all of it, so what overlaps is host work: the
readback wait and the packing against the next step's launches (and, at
ingress, the upload's and the dequant's launches against the compute
thread's); the device runs the codec's kernels in stream order.

Attribution: ``dnet_wire_encode_ms`` / ``dnet_wire_decode_ms`` observe each
codec run, and :data:`overlap` folds them into ``dnet_wire_overlap_ratio``,
the share of codec milliseconds spent off the compute thread.  The chaos
points ``wire_encode`` / ``wire_decode`` sit inside the codec work.
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from dnet_tpu_torch.config import env_flag, wire_settings
from dnet_tpu_torch.obs import get_recorder, metric
from dnet_tpu_torch.resilience import chaos
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

_ENCODE_MS = metric("dnet_wire_encode_ms")
_DECODE_MS = metric("dnet_wire_decode_ms")
_OVERLAP = metric("dnet_wire_overlap_ratio")


def wire_pipeline_enabled() -> bool:
    """DNET_WIRE_PIPELINE=1 (WireSettings.pipeline), read from the
    environment at each call as the reference's gate is."""
    return wire_settings().pipeline or env_flag("DNET_WIRE_PIPELINE")


class _OverlapTracker:
    """Cumulative serial and hidden codec milliseconds -> the overlap gauge.
    `serial` ran on the compute thread (the launch, or the whole codec
    without the pipeline), `hidden` on the tx stage or at ingress.  `stall`
    (encode-ring backpressure waits) is kept apart and left out of the
    ratio: it is the depth bound at work, not codec time."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._serial_ms = self._hidden_ms = self._stall_ms = 0.0

    def add(self, serial_ms: float = 0.0, hidden_ms: float = 0.0, stall_ms: float = 0.0) -> None:
        with self._lock:
            self._serial_ms += serial_ms
            self._hidden_ms += hidden_ms
            self._stall_ms += stall_ms
            total = self._serial_ms + self._hidden_ms
            ratio = self._hidden_ms / total if total > 0 else 0.0
        _OVERLAP.set(round(ratio, 6))

    def snapshot(self) -> dict:
        with self._lock:
            total = self._serial_ms + self._hidden_ms
            return {"serial_ms": self._serial_ms, "hidden_ms": self._hidden_ms, "stall_ms": self._stall_ms,
                    "ratio": self._hidden_ms / total if total > 0 else 0.0}


#: the process's overlap books (one wire a process)
overlap = _OverlapTracker()


def observe_encode(ms: float, hidden: bool) -> None:
    _ENCODE_MS.observe(ms)
    overlap.add(hidden_ms=ms if hidden else 0.0, serial_ms=0.0 if hidden else ms)


def observe_decode(ms: float, hidden: bool) -> None:
    _DECODE_MS.observe(ms)
    overlap.add(hidden_ms=ms if hidden else 0.0, serial_ms=0.0 if hidden else ms)


class EncodeRing:
    """The bounded ring of in-flight encode slots, numbered 0 .. depth - 1.
    `acquire` (compute thread, before the launch) blocks while `depth`
    encodes are in flight and returns the slot it took; `release(slot)`
    (tx stage, after the packing, or a discard) frees it.  A slot owns its
    staging buffers (compression/wire.py `EncodeStaging`) from its acquire
    to its release.  `acquire` returns None after `max_wait_s` (a wedged tx
    stage), and the caller encodes synchronously.  `peak` is the most slots
    ever held at once."""

    MAX_WAIT_S = 10.0

    def __init__(self, depth: int = 2) -> None:
        self.depth = max(int(depth), 1)
        self._slots = threading.BoundedSemaphore(self.depth)
        self._lock = threading.Lock()
        self._free = list(range(self.depth))
        self.peak = 0

    def acquire(self, max_wait_s: Optional[float] = None) -> Optional[int]:
        budget = self.MAX_WAIT_S if max_wait_s is None else max_wait_s
        if not self._slots.acquire(timeout=budget):
            log.warning("encode ring full for %.1fs (tx stage wedged?); falling back to synchronous encode", budget)
            return None
        with self._lock:
            slot = self._free.pop(0)
            self.peak = max(self.peak, self.depth - len(self._free))
        return slot

    def release(self, slot: int) -> None:
        with self._lock:
            if slot in self._free or not 0 <= slot < self.depth:
                raise ValueError(f"encode slot {slot} is not held")
            self._free.append(slot)
        self._slots.release()

    @property
    def inflight(self) -> int:
        with self._lock:
            return self.depth - len(self._free)


class PendingWirePayload:
    """A hop whose payload is still a launched encode (compression/wire.py
    `DeviceEncode`).  It rides ActivationMessage.data from the compute
    thread to the egress worker, which has the tx stage finalize it before
    building the frame (its dtype and shape are the encode's, final at
    launch).  Its slot in the encode ring (`slot` of `ring`; none after a
    synchronous fallback) is released whatever happens."""

    __slots__ = ("encode", "ring", "slot")

    def __init__(self, encode, ring: Optional[EncodeRing] = None, slot: int = 0) -> None:
        self.encode = encode
        self.ring = ring
        self.slot = slot

    def finalize(self, hidden: bool = True) -> bytes:
        """The chaos gate, the wait and the packing, then the slot's
        release.  `hidden` False books the time as serial (the compute
        thread's fallback, or a probe consuming its own frame)."""
        t0 = time.perf_counter()
        try:
            chaos.inject("wire_encode")
            return self.encode.finalize()
        finally:
            ring, self.ring = self.ring, None
            if ring is not None:
                ring.release(self.slot)
            observe_encode((time.perf_counter() - t0) * 1000.0, hidden=hidden)

    def finalize_sync(self) -> bytes:
        return self.finalize(hidden=False)

    def discard(self) -> None:
        """Drop the encode without reading it back (a frame dropped before
        its send): the slot must still be released, or the compute thread
        waits behind a payload nobody finalizes."""
        ring, self.ring = self.ring, None
        if ring is not None:
            ring.release(self.slot)


class WireTxStage:
    """The tx stage: finalizes pending encodes on its own thread, so the
    event loop never waits on a readback and the compute thread never packs
    bytes.  One thread keeps each stream's frames in order (the egress
    worker awaits each finalize before its send)."""

    def __init__(self) -> None:
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="wire-tx")

    async def finalize(self, pending: PendingWirePayload, nonce: str = "", seq: int = -1) -> bytes:
        t0 = time.perf_counter()
        cfut = self._executor.submit(pending.finalize)
        try:
            data = await asyncio.wrap_future(cfut)
        except asyncio.CancelledError:
            # the egress task was cancelled while the finalize was queued:
            # it will never run, so its slot is released here (one already
            # running releases its own)
            if cfut.cancel() or cfut.cancelled():
                pending.discard()
            raise
        if nonce:
            get_recorder().span(nonce, "wire_tx_stage", (time.perf_counter() - t0) * 1000.0, seq=seq,
                                bytes=len(data))
        return data

    def shutdown(self) -> None:
        self._executor.shutdown(wait=False, cancel_futures=True)
