"""The port's sampler against dnet_tpu's on the same logits.

Greedy tokens must be equal and logprobs agree in f32 (2e-5: both are a
log-softmax of the same f32 row).  Sampled tokens cannot match bit for bit
(the reference draws its Gumbel noise from jax.random, the port from a
torch.Generator), so the filters are compared directly: the set of tokens
each sampler may still draw after logit bias, repetition penalty, top-k,
top-p and min-p.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu.core import sampler as ref
from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core import sampler
from dnet_tpu_torch.core.types import DecodingParams

pytestmark = pytest.mark.core

V = 300


def _logits(rng, B=3):
    return rng.normal(scale=3.0, size=(B, V)).astype(np.float32)


def test_greedy_tokens_and_logprobs_match(rng):
    logits = _logits(rng)
    knobs = dict(temperature=0.0, logprobs=True, top_logprobs=5)
    want = ref.sample(
        jnp.asarray(logits), ref.SampleParams.from_decoding(RefDecoding(**knobs)),
        jax.random.key(0), plan=ref.SamplePlan.from_decoding(RefDecoding(**knobs)),
    )
    d = DecodingParams(**knobs)
    got = sampler.sample(
        torch.from_numpy(logits), sampler.SampleParams.from_decoding(d),
        plan=sampler.SamplePlan.from_decoding(d),
    )
    np.testing.assert_array_equal(got.token.numpy(), np.asarray(want.token))
    np.testing.assert_array_equal(got.top_tokens.numpy(), np.asarray(want.top_tokens))
    np.testing.assert_allclose(got.logprob.numpy(), np.asarray(want.logprob), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        got.top_logprobs.numpy(), np.asarray(want.top_logprobs), atol=2e-5, rtol=2e-5
    )


def _ref_keep_mask(monkeypatch, logits, d: RefDecoding, counts):
    """The reference's candidate set, read through its own `sample`: with
    Gumbel noise 1e30 on token t alone, row t draws t iff t survived the
    filters (a dropped token's -inf stays -inf)."""
    monkeypatch.setattr(
        jax.random, "gumbel",
        lambda key, shape, dtype=jnp.float32: jnp.eye(shape[0], shape[1], dtype=dtype) * 1e30,
    )
    rows = jnp.asarray(np.broadcast_to(logits, (V, V)))
    res = ref.sample(
        rows, ref.SampleParams.from_decoding(d), jax.random.key(0),
        token_counts=jnp.asarray(np.broadcast_to(counts, (V, V))),
        plan=ref.SamplePlan.from_decoding(d),
    )
    return np.asarray(res.token) == np.arange(V)


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.8, top_k=7),
    dict(temperature=1.0, top_p=0.6),
    dict(temperature=1.3, min_p=0.05),
    dict(temperature=0.7, top_k=40, top_p=0.9, min_p=0.02, repetition_penalty=1.4),
    dict(temperature=1.0, top_p=0.3, logit_bias={3: 100.0, 17: -100.0, 250: 5.0}),
    dict(temperature=1.0, top_k=2, min_tokens_to_keep=5),
])
def test_filtered_candidates_match(rng, monkeypatch, knobs):
    logits = _logits(rng, B=1)[0]
    counts = np.zeros((V,), np.int32)
    counts[rng.choice(V, size=30, replace=False)] = 1
    want = _ref_keep_mask(monkeypatch, logits, RefDecoding(**knobs), counts)

    d = DecodingParams(**knobs)
    sp = sampler.SampleParams.from_decoding(d)
    plan = sampler.SamplePlan.from_decoding(d)
    adjusted = sampler.adjust_logits(
        torch.from_numpy(logits)[None], sp, torch.from_numpy(counts)[None], plan
    )
    masked = sampler.filter_logits(adjusted.float() / d.temperature, sp)
    got = torch.isfinite(masked[0]).numpy()
    assert 0 < got.sum() < V
    np.testing.assert_array_equal(got, want)


def test_one_seed_one_stream(rng):
    logits = torch.from_numpy(_logits(rng, B=2))
    d = DecodingParams(temperature=1.0, top_p=0.95)
    sp, plan = sampler.SampleParams.from_decoding(d), sampler.SamplePlan.from_decoding(d)

    def stream(seed):
        g = torch.Generator().manual_seed(seed)
        return [sampler.sample(logits, sp, g, plan=plan).token.tolist() for _ in range(20)]

    assert stream(7) == stream(7)
    assert stream(7) != stream(8)


def test_repetition_penalty_matches(rng):
    logits = _logits(rng)
    counts = (rng.random((3, V)) < 0.2).astype(np.int32)
    want = ref.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(counts), jnp.float32(1.3))
    got = sampler.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(counts), 1.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
