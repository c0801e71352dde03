"""The port's weight-streaming store and cache (dnet_tpu_torch/core/weights.py)
against dnet_tpu/core/weights.py, on the tiny Llama checkpoint.

`plan_policy` equals the reference's on a grid of layer counts, windows
and residencies.  The host store's layers equal the reference
HostLayerStore's (f32 and bf16, every tensor bit for bit), and under
int8 / int4 weights their codes and scales equal both the reference's and
the port's own fit engine's bit for bit.  The repack cache writes
safetensors files under the port's own key and a fresh store reads them
back unchanged.  The WeightCache cases are tests/test_weights.py's:
residency and LRU eviction, a pinned layer kept over budget, one load
shared by concurrent getters, prefetch ahead of the get, and slabs reused.
"""

import os
import sys
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from dnet_tpu.core import weights as ref_weights
from dnet_tpu.models.base import ModelConfig as RefConfig
from dnet_tpu.models.llama import LlamaRingModel as RefLlama
from dnet_tpu.utils.checkpoint import Checkpoint as RefCheckpoint
from dnet_tpu_torch.core.engine import LocalEngine
from dnet_tpu_torch.core.weights import HostLayerStore, WeightCache, plan_policy
from dnet_tpu_torch.models import ModelConfig
from dnet_tpu_torch.models.llama import LlamaRingModel
from dnet_tpu_torch.ops.quant import is_quantized
from dnet_tpu_torch.utils.checkpoint import Checkpoint

pytestmark = pytest.mark.core


def _np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _ref_np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _port_store(d, **kw):
    ckpt = Checkpoint(d)
    return HostLayerStore(ckpt, LlamaRingModel(ModelConfig.from_hf(ckpt.config), range(4), "cpu"), **kw)


def _ref_store(d, **kw):
    ckpt = RefCheckpoint(d)
    return ref_weights.HostLayerStore(ckpt, RefLlama(RefConfig.from_hf(ckpt.config), range(4)), **kw)


def test_plan_policy_equals_the_reference():
    for n in (1, 2, 3, 8, 80):
        for w in range(0, n + 2):
            for r in range(0, n + 2):
                got, want = plan_policy(n, w, r), ref_weights.plan_policy(n, w, r)
                assert (got.name, got.window_size, got.residency, got.streams_weights) == (
                    want.name, want.window_size, want.residency, want.streams_weights), (n, w, r)


@pytest.mark.parametrize("dtype,bits", [("float32", 0), ("bfloat16", 0), ("float32", 8), ("float32", 4),
                                        ("bfloat16", 8)])
def test_host_layers_equal_the_reference(tiny_llama_dir, dtype, bits):
    port = _port_store(tiny_llama_dir, param_dtype=dtype, weight_quant_bits=bits)
    ref = _ref_store(tiny_llama_dir, param_dtype=dtype, weight_quant_bits=bits)
    for layer in (0, 3):
        (got,) = port.layer_host(layer)  # a one-layer window: [params]
        want = ref.layer_host(layer)  # the reference's: a leading axis of 1
        assert set(got) == set(want)
        for k, v in got.items():
            if is_quantized(v):
                assert set(v) == set(want[k])
                for kk in v:
                    np.testing.assert_array_equal(_np(v[kk]), _ref_np(want[k][kk])[0])
            else:
                assert v.dtype == getattr(torch, dtype)
                np.testing.assert_array_equal(_np(v), _ref_np(want[k])[0])
    assert port.layer_host(0) is port.layer_host(0)  # made once


@pytest.mark.parametrize("bits", [8, 4])
def test_streamed_codes_equal_the_fit_path(tiny_llama_dir, bits):
    fit = LocalEngine(tiny_llama_dir, max_seq=32, param_dtype="float32", device="cpu", weight_quant_bits=bits)
    store = _port_store(tiny_llama_dir, param_dtype="float32", weight_quant_bits=bits)
    for layer in range(4):
        (got,) = store.layer_host(layer)
        want = fit.window_params[layer]
        for k, v in want.items():
            if is_quantized(v):
                assert all(torch.equal(got[k][kk], v[kk]) for kk in v), k
            else:
                assert torch.equal(got[k], v), k


def test_repack_cache_round_trip(tiny_llama_dir, tmp_path):
    s1 = _port_store(tiny_llama_dir, param_dtype="bfloat16", repack_dir=tmp_path, weight_quant_bits=8)
    (p1,) = s1.layer_host(2)
    f = s1.repack_path / "layer_2.safetensors"
    assert f.is_file() and s1.repack_path.parent.name == tiny_llama_dir.name
    # another format, dtype or bits keys another directory
    s_other = _port_store(tiny_llama_dir, param_dtype="float32", repack_dir=tmp_path)
    assert s_other.repack_path != s1.repack_path
    s2 = _port_store(tiny_llama_dir, param_dtype="bfloat16", repack_dir=tmp_path, weight_quant_bits=8)
    s2.ckpt = None  # a repacked layer never reads the checkpoint
    (p2,) = s2.layer_host(2)
    for k, v in p1.items():
        for kk, vv in (v.items() if is_quantized(v) else [("", v)]):
            other = p2[k][kk] if kk else p2[k]
            assert vv.dtype == other.dtype and torch.equal(vv.view(torch.uint8), other.view(torch.uint8))


@pytest.fixture(scope="module")
def store(tiny_llama_dir):
    return _port_store(tiny_llama_dir, param_dtype="float32")


def test_weight_cache_residency_and_eviction(store):
    wc = WeightCache(store, max_resident=2)
    try:
        wc.get(0)
        wc.release([0])
        wc.get(1)
        wc.release([1])
        assert wc.resident_layers() == [0, 1]
        wc.get(2)  # evicts the LRU layer (0)
        wc.release([2])
        assert 0 not in wc.resident_layers() and len(wc.resident_layers()) == 2
        assert wc.stats["evictions"] == 1
        wc.get(0)  # a reload, not a hit
        wc.release([0])
        assert wc.stats["loads"] == 4
        # the evicted layers' slabs were reused: never more than budget + 1
        assert wc.snapshot()["slabs"] == 3
    finally:
        wc.shutdown()


def test_weight_cache_pinned_not_evicted(store):
    wc = WeightCache(store, max_resident=1)
    try:
        wc.get(0)  # pinned
        wc.get(1)  # over budget, but 0 is pinned: the budget is passed briefly
        assert 0 in wc.resident_layers()
        wc.release([0, 1])
        wc.get(2)
        assert len(wc.resident_layers()) <= 2
    finally:
        wc.shutdown()


def test_weight_cache_load_once_under_concurrency(store):
    """More getters than cores, the interpreter switching threads as often
    as it can: one load, every getter the same params."""
    wc = WeightCache(store, max_resident=4)
    results = []

    def worker():
        results.append(wc.get(3, pin=False))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(4 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads) and len(results) == len(threads)
        assert wc.stats["loads"] == 1  # one future shared by every getter
        assert all(r is results[0] for r in results)
        (p,) = results[0]
        (want,) = store.layer_host(3)
        assert all(torch.equal(p[k], want[k]) for k in want)
    finally:
        sys.setswitchinterval(interval)
        wc.shutdown()


def test_prefetch_overlaps(store):
    wc = WeightCache(store, max_resident=4)
    try:
        wc.prefetch([0, 1])
        time.sleep(0.2)
        t0 = time.perf_counter()
        wc.get(0, pin=False)
        wc.get(1, pin=False)
        assert wc.stats["loads"] == 2
        assert time.perf_counter() - t0 < 0.5  # loaded already (not a strict timing test)
    finally:
        wc.shutdown()
