"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device and skips without one.  The file imports neither jax
nor dnet_tpu, so it runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Shapes are Llama-3.2-1B's (H=32, KVH=8, D=64).  Tolerances: f32 1e-4 (sums
in another order); bf16 2e-2 against the plain version computed in f32
from the same bf16 inputs (the kernel rounds its output to bf16, ~4e-3 at
|x| ~ 1, and sums in another order).
"""

import pytest
import torch

from dnet_tpu_torch.ops.flash_attention import flash_prefill, flash_prefill_plain
from dnet_tpu_torch.ops.flash_decode import flash_decode_attend, flash_decode_plain

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, dtype, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,pos,S,sinks", [(100, 37, 512, False), (64, 0, 64, True), (17, 200, 300, False)])
def test_prefill_kernel_matches_plain(gen, dtype, T, pos, S, sinks):
    q = _randn(gen, dtype, 1, T, 32, 64)
    k, v = _randn(gen, dtype, 1, S, 8, 64), _randn(gen, dtype, 1, S, 8, 64)
    sk = torch.randn(32, generator=gen, device="cuda") if sinks else None
    before = flash_prefill.launches
    out = flash_prefill(q, k, v, pos, sinks=sk)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    want = flash_prefill_plain(q.float(), k.float(), v.float(), pos, sinks=sk)
    assert (out.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 63, 64, 1024, 4095])
def test_decode_kernel_matches_plain(gen, dtype, pos):
    q = _randn(gen, dtype, 1, 1, 32, 64)
    k, v = _randn(gen, dtype, 1, 4096, 8, 64), _randn(gen, dtype, 1, 4096, 8, 64)
    before = flash_decode_attend.launches
    out = flash_decode_attend(q, k, v, pos)
    torch.cuda.synchronize()
    assert flash_decode_attend.launches == before + 1
    want = flash_decode_plain(q.float(), k.float(), v.float(), pos)
    assert (out.float() - want).abs().max().item() <= TOL[dtype]


def test_cuda_tensor_never_takes_the_plain_version(gen):
    """A dtype the kernel does not take raises on the card instead of
    computing through the plain version."""
    q = _randn(gen, torch.float16, 1, 16, 32, 64)
    k = _randn(gen, torch.float16, 1, 64, 8, 64)
    with pytest.raises(ValueError):
        flash_prefill(q, k, k, 0)
    with pytest.raises(ValueError):
        flash_decode_attend(q[:, :1], k, k, 3)
