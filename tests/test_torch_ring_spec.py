"""Ring speculation on port shards, against the reference's ring.

The head widens each granted continuation into a [tok, d_1..d_L] verify
block of prompt-lookup drafts and the tail emits 1..L+1 tokens a lap, the
counterpart of tests/subsystems/test_ring_two_shards.py's speculation
case: on a repetitive prompt the port's ring, the reference's ring and the
port's single process give the same greedy tokens, and both rings take
the same number of tail-to-head continuations, fewer than one a token.
Mixed rings (one shard of each package) give the same tokens; a sampled
or a logit-biased request widens no block; and a verify block reaching a
tail that cannot speculate fails with the reference's text.
"""

import asyncio

import numpy as np
import pytest

from dnet_tpu_torch.core.types import DecodingParams
from tests.torch_ring_harness import MAX_SEQ, _local_streams, _run_ring

pytestmark = [pytest.mark.ring, pytest.mark.shard]

REPETITIVE = [[7, 3, 11, 7, 3, 11, 7, 3]]  # drafts land
N = 12
SPEC = ({"spec_lookahead": 4}, {"spec_lookahead": 4})


@pytest.fixture(scope="module")
def local_repetitive(tiny_llama_dir):
    return _local_streams(tiny_llama_dir, prompts=REPETITIVE, steps=N)


@pytest.fixture(scope="module")
def port_ring(tiny_llama_dir):
    streams, net, rts = asyncio.run(_run_ring(tiny_llama_dir, prompts=REPETITIVE, steps=N, shard_opts=SPEC))
    return streams, net, [dict(rt.compute.spec_stats) for rt in rts]


def test_speculating_ring_matches_reference_ring_and_local(tiny_llama_dir, local_repetitive, port_ring):
    """Port ring = reference ring = port local, token for token, in f32;
    the same continuation count on both rings, under n - 1; the head widened
    blocks and the tail verified them, emitting every token past the
    prompt frame's."""
    port, net, (head, tail) = port_ring
    ref, ref_net, _ = asyncio.run(_run_ring(tiny_llama_dir, kinds=("ref", "ref"), api_kind="ref",
                                            prompts=REPETITIVE, steps=N, shard_opts=SPEC))
    assert port == ref == local_repetitive
    conts = [c for c in net.continuations if c[0] == "s1"]
    assert len(conts) == len([c for c in ref_net.continuations if c[0] == "s1"])
    assert 0 < len(conts) < N - 1, len(conts)
    assert head["widened"] == tail["blocks"] > 0
    assert tail["emitted"] == N - 1  # step 0 came from the prompt frame


@pytest.mark.parametrize("kinds", [("ref", "port"), ("port", "ref")], ids=["ref_head", "port_head"])
def test_mixed_speculating_rings_match(tiny_llama_dir, local_repetitive, kinds):
    """A reference head widening for a port tail, and the reverse: the drafts
    and the committed tokens cross the wire between the packages."""
    streams, net, _ = asyncio.run(_run_ring(tiny_llama_dir, kinds=kinds, api_kind=kinds[1], prompts=REPETITIVE,
                                            steps=N, shard_opts=SPEC))
    assert streams == local_repetitive
    assert 0 < len([c for c in net.continuations if c[0] == "s1"]) < N - 1


@pytest.mark.parametrize("case", ["sampled", "logit_bias"])
def test_ineligible_requests_widen_no_block(tiny_llama_dir, case):
    """A seeded sampled request and a greedy request with a logit bias never
    speculate: no block is widened or verified, and the stream equals the
    port's single process."""
    dec = {"sampled": DecodingParams(temperature=0.8, top_p=0.95, seed=1234),
           "logit_bias": DecodingParams(temperature=0.0, logit_bias={11: 2.0})}[case]
    streams, _, rts = asyncio.run(_run_ring(tiny_llama_dir, prompts=REPETITIVE, steps=N, shard_opts=SPEC,
                                            decoding=dec))
    assert [rt.compute.spec_stats["widened"] for rt in rts] == [0, 0]
    assert rts[1].compute.spec_stats["blocks"] == 0
    assert streams == _local_streams(tiny_llama_dir, dec, prompts=REPETITIVE, steps=N)


def test_verify_block_at_a_tail_that_cannot_speculate(tiny_llama_dir):
    """A tail loaded without speculation refuses a verify block with the
    reference's text, before it decodes the payload."""
    from dnet_tpu.core.types import ActivationMessage as RefMessage
    from dnet_tpu.shard.compute import ShardCompute as RefCompute
    from dnet_tpu_torch.core.types import ActivationMessage
    from dnet_tpu_torch.shard.compute import ShardCompute

    hidden = np.zeros((1, 5, 64), dtype=np.float32)
    errors = []
    for compute, message in ((ShardCompute(tiny_llama_dir, [2, 3], max_seq=MAX_SEQ, param_dtype="float32",
                                           device="cpu"), ActivationMessage),
                             (RefCompute(tiny_llama_dir, [2, 3], max_seq=MAX_SEQ, param_dtype="float32"),
                              RefMessage)):
        msg = message(nonce="v", layer_id=1, seq=3, dtype="float32", shape=hidden.shape, data=hidden.tobytes(),
                      pos=0, drafts=[1, 2, 3, 4], auto_steps=4)
        with pytest.raises(ValueError) as exc:
            compute.process(msg)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith("verify block arrived but this shard cannot speculate")
