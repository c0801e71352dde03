"""Weight streaming: a host-memory layer store and a bounded device cache.

Counterpart of dnet_tpu/core/weights.py for a CUDA card:

- `plan_policy` picks fit / offload / sliding_fit with the reference's
  thresholds.
- `HostLayerStore` holds each layer's params mapped (renamed, transposed),
  quantized under weight quantization and cast to the param dtype, packed
  into ONE host buffer per layer (`HostLayer`: every tensor at a 256-byte
  aligned offset).  On a CUDA engine the buffer is page-locked
  (cudaHostRegister on plain host memory, exact size: PyTorch's pinned
  allocator would round a 1.7 GB layer up to 2 GiB), so its copy to the
  card is one asynchronous DMA.  Layers come lazily from a checkpoint
  (through the native store's zero-copy views, with disk readahead in
  `prefetch_disk`, the file's pages released once a layer is packed) or
  eagerly from params made elsewhere (`from_layers`).
  Quantization runs on the engine's device, as the fit path's does, so the
  streamed codes equal the fit path's bit for bit.  An optional repack
  cache keeps mapped layers as safetensors files under
  <repack_dir>/<model tag>/<key>/layer_<i>.safetensors, the key hashing
  this package's format tag, the dtype, the bits, the group and the layer
  set.
- `WeightCache` keeps at most `max_resident` layers on the device: one
  load future per layer (concurrent getters share it), ref-counted
  pin / release, LRU eviction of unpinned layers when a get would pass the
  budget, eager `evict`, and `stats` {loads, hits, evictions}.  On CUDA a
  layer's copy runs on the cache's own copy stream, issued from the loader
  thread into a device slab (one layer's bytes); the stream that gets the
  layer waits on the copy's event before its first kernel.  An evicted
  layer's slab goes back to a free list with an event recorded on the
  compute stream after its last kernel, and the next copy into it waits on
  that event: a queued kernel never reads weights that a newer copy
  overwrote.  Slabs are made on demand and reused, so the device holds the
  resident layers plus the prefetched ones and nothing churns.
"""

from __future__ import annotations

import hashlib
import threading
import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from dnet_tpu_torch.ops.quant import is_quantized
from dnet_tpu_torch.utils.checkpoint import save_safetensors
from dnet_tpu_torch.utils.logger import get_logger
from dnet_tpu_torch.utils.native_store import NativeSafetensors

log = get_logger()

ALIGN = 256  # bytes: every tensor of a packed layer starts at a multiple
REPACK_FORMAT = "torch-v1"  # the repack cache's format tag (part of its key)
PREFETCH_WORKERS = 2  # loader threads making layers not yet in host memory


# ---- policy planning -------------------------------------------------------


@dataclass(frozen=True)
class PolicyPlan:
    name: str  # "fit" | "offload" | "sliding_fit"
    window_size: int
    residency: int  # most layers resident on the device

    @property
    def streams_weights(self) -> bool:
        return self.name != "fit"


def plan_policy(local_count: int, window_size: int = 0, residency_size: int = 0) -> PolicyPlan:
    """The reference's thresholds: residency < window -> sliding_fit
    (evict inside the window); window and residency >= the local layers ->
    fit (everything resident); else offload (a window at a time)."""
    w = window_size or local_count
    n = residency_size or local_count
    if w >= local_count and n >= local_count:
        return PolicyPlan("fit", local_count, local_count)
    if n < w:
        return PolicyPlan("sliding_fit", w, max(n, 1))
    return PolicyPlan("offload", w, min(max(n, w), local_count))


# ---- packed host layers ----------------------------------------------------


def _leaves(tree, path: tuple = ()) -> Iterable[Tuple[tuple, torch.Tensor]]:
    """(path, tensor) of a nested dict / list of tensors, in order."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))


def _build(items: Iterable[Tuple[tuple, torch.Tensor]]):
    """The nested dict / list that `_leaves` walked (int keys are list
    positions)."""
    root: dict = {}
    for path, leaf in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in range(len(out))]
        return out

    return listify(root)


class HostLayer:
    """One layer's params packed into one host buffer: `buf` (uint8), the
    layout (path, dtype, shape, offset, bytes) and `tree`, the params as
    CPU views of `buf`."""

    def __init__(self, tree, pin: bool):
        items = list(_leaves(tree))
        self.layout = []
        off = 0
        for path, t in items:
            nbytes = t.numel() * t.element_size()
            self.layout.append((path, t.dtype, tuple(t.shape), off, nbytes))
            off += -(-nbytes // ALIGN) * ALIGN
        self.nbytes = max(off, ALIGN)
        self.buf = torch.empty(self.nbytes, dtype=torch.uint8)
        self.pinned = pin
        if pin:
            self.buf.fill_(0)  # fault the pages in on every core before locking them
            cudart = torch.cuda.cudart()
            err = cudart.cudaHostRegister(self.buf.data_ptr(), self.nbytes, 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of {self.nbytes} bytes failed: {err}")
            # unlocked when this object goes; it holds the buffer until then
            weakref.finalize(self, cudart.cudaHostUnregister, self.buf.data_ptr()).atexit = False
        self.tree = self.unpack(self.buf)
        # each tensor straight into its place (from the device too: a copy
        # into page-locked memory runs at the link's rate)
        for (_, src), dst in zip(items, _leaves_of(self.tree)):
            if src.numel():
                dst.copy_(src)

    def unpack(self, base: torch.Tensor):
        """The params as views of `base` (this layer's bytes, on any device)."""
        return _build(
            (path, base[off : off + nbytes].view(dtype).view(shape) if nbytes else
             torch.empty(shape, dtype=dtype, device=base.device))
            for path, dtype, shape, off, nbytes in self.layout
        )


def _leaves_of(tree) -> List[torch.Tensor]:
    return [t for _, t in _leaves(tree)]


# ---- host store ------------------------------------------------------------


class HostLayerStore:
    """Each layer's params in host memory, packed (`HostLayer`), made once
    and kept.  `layer_host(layer)` is the reference's surface: the layer as
    a single-layer window (`model.wrap_offload_layer`) of CPU tensors."""

    def __init__(
        self,
        ckpt,
        model,
        param_dtype: str = "bfloat16",
        repack_dir: Optional[Union[str, Path]] = None,
        weight_quant_bits: int = 0,
        weight_quant_group: int = 0,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.ckpt = ckpt
        self.model = model
        self.param_dtype = getattr(torch, param_dtype) if isinstance(param_dtype, str) else param_dtype
        self.weight_quant_bits = weight_quant_bits
        self.weight_quant_group = weight_quant_group
        # the quantizer and the page-locking follow the engine's device
        self.device = torch.device(device or "cpu")
        self.pin = self.device.type == "cuda"
        self._cache: Dict[int, HostLayer] = {}
        self._lock = threading.Lock()
        self.repack_path: Optional[Path] = None
        if repack_dir is not None and ckpt is not None:
            dtype_name = str(self.param_dtype).removeprefix("torch.")
            key = hashlib.sha1(
                f"{REPACK_FORMAT}:{dtype_name}:wq{weight_quant_bits}g{weight_quant_group}:"
                f"{','.join(map(str, model.layers))}".encode()
            ).hexdigest()[:10]
            self.repack_path = Path(repack_dir).expanduser() / Path(ckpt.dir).name / key
            self.repack_path.mkdir(parents=True, exist_ok=True)

    @classmethod
    def from_layers(
        cls, model, layers: Iterable[dict], param_dtype: str = "bfloat16", weight_quant_bits: int = 0,
        weight_quant_group: int = 0, device: Optional[Union[str, torch.device]] = None,
    ) -> "HostLayerStore":
        """A store over params made elsewhere, one dict per layer in the
        model's layer order (a generator: each layer is quantized on its
        own device when asked, packed into host memory, and dropped before
        the next is made)."""
        self = cls(None, model, param_dtype, None, weight_quant_bits, weight_quant_group, device)
        for layer, params in zip(model.layers, layers):
            self._cache[layer] = self._pack(layer, self._finish(params))
            del params
        if len(self._cache) != len(model.layers):
            raise ValueError(f"{len(self._cache)} layers given for {len(model.layers)}")
        return self

    # -- making a layer ------------------------------------------------------
    def _finish(self, params: dict) -> dict:
        """Quantize (on the engine's device, from the values as given, as
        the fit path does) and cast floats to the param dtype, on the
        device each tensor lies on."""
        if self.weight_quant_bits and not any(is_quantized(v) for v in params.values()):
            params = self.model.quantize_params(
                {k: v.to(self.device) for k, v in params.items()}, self.weight_quant_bits,
                scale_dtype=self.param_dtype, group_size=self.weight_quant_group,
            )
        return {k: v if is_quantized(v) or not v.is_floating_point() else v.to(self.param_dtype)
                for k, v in params.items()}

    def _pack(self, layer: int, flat: dict) -> HostLayer:
        return HostLayer(self.model.wrap_offload_layer(flat, layer), self.pin)

    def _repack_file(self, layer: int) -> Optional[Path]:
        return None if self.repack_path is None else self.repack_path / f"layer_{layer}.safetensors"

    def _load_layer_flat(self, layer: int) -> dict:
        f = self._repack_file(layer)
        if f is not None and f.is_file():
            st = NativeSafetensors(f)
            return _unflatten({k: st.tensor(k) for k in st.keys()})
        t0 = time.perf_counter()
        flat = self._finish(self.model.map_layer(self.ckpt.load_layer_raw(layer, view=True)))
        log.info("[PROFILE] host-load layer %d in %.1fms", layer, (time.perf_counter() - t0) * 1e3)
        if f is not None:
            tmp = f.with_suffix(".tmp")
            save_safetensors(tmp, _flatten(flat))
            tmp.rename(f)
        return flat

    # -- public --------------------------------------------------------------
    def host_layer(self, layer: int) -> HostLayer:
        """The packed layer, made on first use (the packed copy replaces the
        checkpoint's pages, which are released)."""
        with self._lock:
            hl = self._cache.get(layer)
        if hl is None:
            f = self._repack_file(layer)
            from_ckpt = f is None or not f.is_file()
            hl = self._pack(layer, self._load_layer_flat(layer))
            if from_ckpt:
                self.ckpt.release_layer(layer)
            with self._lock:
                hl = self._cache.setdefault(layer, hl)
        return hl

    def layer_host(self, layer: int):
        """One layer's host params as a single-layer window."""
        return self.host_layer(layer).tree

    def has(self, layer: int) -> bool:
        """Whether the layer is made (in host memory) already."""
        with self._lock:
            return layer in self._cache

    def host_bytes(self) -> int:
        """Bytes of the layers made so far (page-locked on CUDA)."""
        with self._lock:
            return sum(hl.nbytes for hl in self._cache.values())

    def prefetch_disk(self, layers: Sequence[int]) -> None:
        """Start the disk-to-page-cache reads of layers not made yet (the
        native store's background page-touch); repacked layers read their
        own file instead."""
        if self.ckpt is None:
            return
        for layer in layers:
            with self._lock:
                if layer in self._cache:
                    continue
            f = self._repack_file(layer)
            if f is None or not f.is_file():
                self.ckpt.prefetch_layer(layer)


def _flatten(tree: dict) -> Dict[str, torch.Tensor]:
    """One level of quantized leaves ({"wq": {"q", "s"}}) -> "wq::q" keys."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                flat[f"{k}::{k2}"] = v2
        else:
            flat[k] = v
    return flat


def _unflatten(flat: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for k, v in flat.items():
        if "::" in k:
            k1, _, k2 = k.partition("::")
            out.setdefault(k1, {})[k2] = v
        else:
            out[k] = v
    return out


# ---- device weight cache ---------------------------------------------------


class _DeviceLayer:
    """A resident layer: its params (views of `slab`) and, on CUDA, the
    event its copy recorded."""

    __slots__ = ("params", "slab", "ready")

    def __init__(self, params, slab: torch.Tensor, ready):
        self.params, self.slab, self.ready = params, slab, ready


class WeightCache:
    """Bounded device residency with load-once futures and LRU eviction."""

    def __init__(
        self, store: HostLayerStore, max_resident: int, device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.store = store
        self.max_resident = max_resident
        self.device = torch.device(device or "cpu")
        self.cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._use_stream = None  # the stream that last got a layer (the compute stream)
        self._lock = threading.RLock()
        self._futures: Dict[int, Future] = {}  # layer -> Future[_DeviceLayer]
        self._resident: Dict[int, _DeviceLayer] = {}
        self._refs: Dict[int, int] = {}
        self._last_used: Dict[int, float] = {}
        self._free: Dict[int, List[tuple]] = {}  # slab bytes -> [(slab, event after its last use)]
        self.slabs = 0  # slabs made
        self.slab_bytes = 0
        self.h2d_bytes = 0  # bytes copied to the device
        self._pool = ThreadPoolExecutor(max_workers=PREFETCH_WORKERS, thread_name_prefix="prefetch")
        self.stats = {"loads": 0, "hits": 0, "evictions": 0}

    # -- internal ------------------------------------------------------------
    def _take_slab(self, nbytes: int) -> Tuple[torch.Tensor, object]:
        """A free slab of `nbytes` and the event to wait on before writing
        it (None: never used), else a new one."""
        with self._lock:
            free = self._free.get(nbytes)
            if free:
                return free.pop()
            self.slabs += 1
            self.slab_bytes += nbytes
        return torch.empty(nbytes, dtype=torch.uint8, device=self.device), None

    def _recycle(self, dl: _DeviceLayer) -> None:
        """Caller holds the lock.  The slab is free once the compute stream
        has passed this point (every kernel queued on the layer)."""
        done = None
        if self.cuda and self._use_stream is not None:
            done = torch.cuda.Event()
            done.record(self._use_stream)
        self._free.setdefault(dl.slab.numel(), []).append((dl.slab, done))

    def _load_to_device(self, layer: int) -> _DeviceLayer:
        hl = self.store.host_layer(layer)
        t0 = time.perf_counter()
        ready = None
        if self.cuda:
            with torch.cuda.stream(self._copy_stream):
                slab, after = self._take_slab(hl.nbytes)
                if after is not None:
                    self._copy_stream.wait_event(after)
                slab.copy_(hl.buf, non_blocking=hl.pinned)
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
        else:
            slab, _ = self._take_slab(hl.nbytes)
            slab.copy_(hl.buf)
        with self._lock:
            self.h2d_bytes += hl.nbytes
        log.debug("device-load layer %d issued in %.1fms", layer, (time.perf_counter() - t0) * 1e3)
        return _DeviceLayer(hl.unpack(slab), slab, ready)

    def _ensure_future(self, layer: int) -> Future:
        """Caller holds the lock: one future per layer in flight.  A layer
        already in host memory has its copy issued here (it only queues on
        the copy stream); one still to be made goes to the loader threads."""
        fut = self._futures.get(layer)
        if fut is None:
            if self.store.has(layer):
                fut = Future()
                fut.set_result(self._load_to_device(layer))
            else:
                fut = self._pool.submit(self._load_to_device, layer)
            self._futures[layer] = fut
            self.stats["loads"] += 1
        return fut

    def _drop(self, layer: int) -> None:
        """Caller holds the lock: take a resident layer off the device."""
        self._recycle(self._resident.pop(layer))
        self._refs.pop(layer, None)
        self._last_used.pop(layer, None)

    def _evict_to_budget(self, incoming: int = 1) -> None:
        """Caller holds the lock: evict LRU unpinned layers until the
        incoming load fits the budget (everything pinned: over it briefly)."""
        while len(self._resident) + incoming > self.max_resident:
            candidates = [(self._last_used.get(l, 0.0), l) for l in self._resident if self._refs.get(l, 0) == 0]
            if not candidates:
                return
            self._drop(min(candidates)[1])
            self.stats["evictions"] += 1

    def _handout(self, layer: int, dl: _DeviceLayer, pin: bool):
        """Caller holds the lock: pin, stamp and hand the params to the
        calling thread's stream, which waits for the copy."""
        if pin:
            self._refs[layer] = self._refs.get(layer, 0) + 1
        self._last_used[layer] = time.monotonic()
        if self.cuda:
            self._use_stream = torch.cuda.current_stream(self.device)
            if dl.ready is not None:
                self._use_stream.wait_event(dl.ready)
        return dl.params

    # -- public --------------------------------------------------------------
    def prefetch(self, layers: Sequence[int]) -> None:
        """Start host-to-device loads without waiting (disk readahead of
        the whole window first)."""
        self.store.prefetch_disk(layers)
        with self._lock:
            for layer in layers:
                if layer not in self._resident:
                    self._ensure_future(layer)

    def get(self, layer: int, pin: bool = True):
        """The layer's device params, loading them if needed; pins by ref."""
        with self._lock:
            if layer in self._resident:
                self.stats["hits"] += 1
                return self._handout(layer, self._resident[layer], pin)
            fut = self._ensure_future(layer)
        try:
            dl = fut.result()  # outside the lock: others proceed
        except Exception:
            with self._lock:  # a failed load must not poison the layer
                if self._futures.get(layer) is fut:
                    self._futures.pop(layer, None)
            raise
        with self._lock:
            if layer not in self._resident:
                self._evict_to_budget(incoming=1)
                self._resident[layer] = dl
            elif self._resident[layer] is not dl:
                self._recycle(dl)
            self._futures.pop(layer, None)
            return self._handout(layer, self._resident[layer], pin)

    def release(self, layers: Sequence[int]) -> None:
        with self._lock:
            for layer in layers:
                if self._refs.get(layer, 0) > 0:
                    self._refs[layer] -= 1

    def evict(self, layers: Sequence[int]) -> None:
        """Take unpinned layers off the device now."""
        with self._lock:
            for layer in layers:
                if layer in self._resident and self._refs.get(layer, 0) == 0:
                    self._drop(layer)

    def resident_layers(self) -> List[int]:
        with self._lock:
            return sorted(self._resident)

    def snapshot(self) -> dict:
        """Counters for /health: loads, hits, evictions, resident layers,
        slabs and their bytes, bytes copied to the device, host bytes."""
        with self._lock:
            out = dict(self.stats, resident=len(self._resident), max_resident=self.max_resident,
                       slabs=self.slabs, slab_bytes=self.slab_bytes, h2d_bytes=self.h2d_bytes)
        out["host_bytes"] = self.store.host_bytes()
        return out

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)
        if self.cuda:
            torch.cuda.synchronize(self.device)
        with self._lock:
            self._resident.clear()
            self._futures.clear()
            self._refs.clear()
            self._free.clear()
