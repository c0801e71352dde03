"""The port's native host store (dnet_tpu_torch/csrc/hoststore.cpp through
dnet_tpu_torch/utils/native_store.py) against dnet_tpu's
(native/hoststore.cpp through dnet_tpu/utils/native_store.py), on one
safetensors file made from a seed.

Every tensor viewed by the port equals the reference's view bit for bit
(f32, bf16 read as its bits, f16, int8, uint8, int64, an empty tensor);
the spans of a layer merge into the same runs as the reference's
`_coalesced`; prefetch (synchronous and with the background page-touch)
and release leave the data readable and equal; closing a store while the
background touch still reads it does not crash; a checkpoint's layer reads
go through the store; a bad path raises in both.
"""

import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from dnet_tpu.utils import native_store as ref_store
from dnet_tpu_torch.utils import native_store
from dnet_tpu_torch.utils.checkpoint import Checkpoint, save_checkpoint, save_safetensors

pytestmark = pytest.mark.core

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tensors():
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(33, 17)).astype(np.float32)
    return {
        "model.layers.0.a.weight": torch.from_numpy(f32),
        "model.layers.0.b.weight": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)).to(torch.bfloat16),
        "model.layers.0.c.weight": torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float16)),
        "model.layers.1.q": torch.from_numpy(rng.integers(-128, 128, (7, 9), dtype=np.int8)),
        "model.layers.1.q4": torch.from_numpy(rng.integers(0, 256, (11,), dtype=np.uint8)),
        "model.layers.1.idx": torch.from_numpy(rng.integers(0, 1 << 40, (3,), dtype=np.int64)),
        "model.norm.weight": torch.from_numpy(rng.normal(size=(0,)).astype(np.float32)),
    }


@pytest.fixture(scope="module")
def st_file(tmp_path_factory, tensors):
    path = tmp_path_factory.mktemp("native") / "model.safetensors"
    save_safetensors(path, tensors)
    return path


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _ref_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def test_views_equal_the_reference(st_file, tensors):
    port = native_store.NativeSafetensors(st_file)
    ref = ref_store.NativeSafetensors(st_file)
    assert port.keys() == ref.keys() == sorted(tensors)
    for name, want in tensors.items():
        got = port.tensor(name)
        assert got.dtype == want.dtype and tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(_bits(got), _ref_bits(ref.tensor(name)))
        np.testing.assert_array_equal(_bits(got), _bits(want))
        assert port.span(name) == ref.span(name)
    ref.close()


def test_spans_coalesce_like_the_reference(st_file, tensors):
    port = native_store.NativeSafetensors(st_file)
    ref = ref_store.NativeSafetensors(st_file)
    names = list(tensors)
    for subset in (names, names[:3], names[3:6], names[::2], [names[-1], names[0]]):
        assert port._coalesced(subset) == ref._coalesced(subset)
    ref.close()


def test_prefetch_and_release_round_trip(st_file, tensors):
    st = native_store.NativeSafetensors(st_file)
    names = list(tensors)
    st.prefetch(names, sync=True)
    st.prefetch(names)  # the background touch may still run while we release
    st.release(names)  # the pages fault back in from the file
    for name, want in tensors.items():
        np.testing.assert_array_equal(_bits(st.tensor(name)), _bits(want))
    view = st.tensor(names[0])
    del st  # a live view keeps the file mapped
    np.testing.assert_array_equal(view.numpy(), tensors[names[0]].numpy())


CLOSE_WHILE_TOUCHED = """
import os, sys, time
from dnet_tpu_torch.utils.native_store import NativeSafetensors
path = sys.argv[1]
for i in range(40):
    fd = os.open(path, os.O_RDONLY)
    os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)  # this file's pages only: the touch reads the disk
    os.close(fd)
    st = NativeSafetensors(path)
    st.prefetch(st.keys())
    time.sleep((i % 4) * 5e-4)
    st.close()
    time.sleep(2e-3)
print("ok")
"""


def test_close_while_the_background_touch_reads(tmp_path):
    """A store closed right after prefetch() of a large span: the worker's
    touch holds the mapping, so the unmap waits for it (the process would
    take SIGSEGV otherwise).  In a child process, so a crash fails only
    this test."""
    path = tmp_path / "big.safetensors"
    save_safetensors(path, {"w": torch.ones(32 << 20, dtype=torch.uint8)})
    proc = subprocess.run([sys.executable, "-c", CLOSE_WHILE_TOUCHED, str(path)], capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", (proc.returncode, proc.stderr[-2000:])


def test_checkpoint_reads_through_the_store(tmp_path, tensors):
    save_checkpoint(tmp_path, {"num_hidden_layers": 2}, tensors)
    ck = Checkpoint(tmp_path)
    raw = ck.load_layer_raw(1)
    views = ck.load_layer_raw(1, view=True)
    for suffix in ("q", "q4", "idx"):
        want = tensors[f"model.layers.1.{suffix}"]
        assert torch.equal(raw[suffix], want) and torch.equal(views[suffix], want)
    ck.prefetch_layer(0, sync=True)
    ck.release_layer(0)
    assert torch.equal(ck.load_tensor("model.layers.0.a.weight"), tensors["model.layers.0.a.weight"])


def test_bad_path_raises(tmp_path):
    with pytest.raises(OSError, match="hs_open failed"):
        native_store.NativeSafetensors(tmp_path / "missing.safetensors")
    with pytest.raises(OSError, match="hs_open failed"):
        ref_store.NativeSafetensors(tmp_path / "missing.safetensors")
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(b"\xff" * 16)
    with pytest.raises(ValueError, match="corrupt safetensors header"):
        native_store.NativeSafetensors(bad)
    with pytest.raises(ValueError, match="corrupt safetensors header"):
        ref_store.NativeSafetensors(bad)


def test_library_builds_into_the_build_dir():
    path = native_store.ensure_built()
    assert path.parent == native_store.BUILD_DIR and path.name.startswith("hoststore-") and path.is_file()
