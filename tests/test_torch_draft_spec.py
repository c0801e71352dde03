"""Draft-model speculation in the port against dnet_tpu's (mirroring
tests/test_draft_spec.py): a second, same-vocab checkpoint drafts each
verify block by its own greedy decode steps.

Every emitted token is an argmax of the logits plain decode computes, so
the stream equals plain decode (and the reference's draft stream) for any
draft; a self-draft (draft == target) accepts every draft, L+1 tokens a
block.  A prefix-cache hit restores the target's KV only, and the draft
re-reads the prompt.  A draft with another vocabulary, or without a
lookahead, is refused at construction."""

import pytest

from dnet_tpu.core.types import DecodingParams as RefDecoding
from dnet_tpu_torch.core.types import DecodingParams

pytestmark = pytest.mark.core

MAX_SEQ = 128
GREEDY = DecodingParams(temperature=0.0)


@pytest.fixture(scope="module")
def small_draft_dir(tmp_path_factory):
    """The same vocabulary, a smaller and differently seeded model."""
    from tests.fakes.checkpoints import make_tiny_llama

    d = tmp_path_factory.mktemp("draft_small")
    make_tiny_llama(d, config={"num_hidden_layers": 2}, seed=7)
    return d


def _port(d, **kw):
    from dnet_tpu_torch.core.engine import LocalEngine

    return LocalEngine(d, max_seq=MAX_SEQ, param_dtype="float32", device="cpu", **kw)


def _ref(d, **kw):
    from dnet_tpu.core.engine import LocalEngine

    return LocalEngine(d, max_seq=MAX_SEQ, param_dtype="float32", **kw)


def _stream(eng, ids, n, dec=GREEDY):
    return [r.token_id for r in eng.generate(ids, dec, max_tokens=n)]


def test_draft_stream_matches_plain_and_reference(tiny_llama_dir, small_draft_dir):
    """Any draft keeps the stream greedy-exact: the port's equals its plain
    stream and the reference's draft stream."""
    ids = [256, 72, 101, 108, 108, 111]
    eng = _port(tiny_llama_dir, spec_lookahead=4, draft_dir=small_draft_dir)
    assert eng.draft is not None and eng.draft.config.num_hidden_layers == 2
    got = _stream(eng, ids, 10)
    assert got == _stream(_port(tiny_llama_dir), ids, 10)
    ref = _ref(tiny_llama_dir, spec_lookahead=4, draft_dir=small_draft_dir)
    assert got == _stream(ref, ids, 10, RefDecoding(temperature=0.0))
    assert eng.stats()["spec_draft"] is True and eng.spec_blocks > 0


def test_self_draft_accepts_everything(tiny_llama_dir):
    """draft == target: the first block emits L+1 tokens, as the
    reference's, and the stream stays the plain one."""
    ids = [256, 72, 101, 108]
    eng = _port(tiny_llama_dir, spec_lookahead=4, draft_dir=tiny_llama_dir)
    res = eng.prefill_and_sample("s", ids, GREEDY)
    out = eng.decode_spec("s", int(res.token[0]), GREEDY, 16)
    assert len(out) == 5
    ref = _ref(tiny_llama_dir, spec_lookahead=4, draft_dir=tiny_llama_dir)
    rdec = RefDecoding(temperature=0.0)
    rres = ref.prefill_and_sample("s", ids, rdec)
    assert [int(r.token[0]) for r in out] == [int(r.token[0]) for r in ref.decode_spec("s", int(rres.token[0]),
                                                                                        rdec, 16)]
    eng.end_session("s")
    assert _stream(eng, ids, 10) == _stream(_port(tiny_llama_dir), ids, 10)


def test_draft_with_prefix_cache_hit(tiny_llama_dir, small_draft_dir):
    """A hit seeds only the target's KV; the draft re-reads the whole prompt
    and the follow-up stream stays exact."""
    base = [256, 72, 101, 108, 108, 111, 7, 3, 11, 7, 3, 11, 256, 84, 104, 101]
    eng = _port(tiny_llama_dir, spec_lookahead=4, draft_dir=small_draft_dir, prefix_cache_size=2)
    first = _stream(eng, base, 4)
    grown = base + first[:1] + [256, 110]
    got = _stream(eng, grown, 6)
    assert eng.prefix_cache.stats["hits"] >= 1
    assert got == _stream(_port(tiny_llama_dir), grown, 6)


def test_draft_vocab_mismatch_rejected(tiny_llama_dir, tmp_path):
    from tests.fakes.checkpoints import make_tiny_llama

    make_tiny_llama(tmp_path, config={"vocab_size": 300})
    with pytest.raises(ValueError, match="vocab"):
        _port(tiny_llama_dir, spec_lookahead=4, draft_dir=tmp_path)


def test_draft_without_spec_rejected(tiny_llama_dir, small_draft_dir):
    with pytest.raises(ValueError, match="spec_lookahead"):
        _port(tiny_llama_dir, draft_dir=small_draft_dir)


def test_rotating_draft_rejected(tiny_llama_dir, tmp_path):
    """A gpt_oss draft's ring caches cannot rewind after a partial
    acceptance."""
    from tests.fakes.checkpoints import make_tiny_gpt_oss, make_tiny_llama

    make_tiny_gpt_oss(tmp_path / "oss")
    vocab = _port(tmp_path / "oss").config.vocab_size
    make_tiny_llama(tmp_path / "target", config={"vocab_size": vocab})
    with pytest.raises(ValueError, match="rotating"):
        _port(tmp_path / "target", spec_lookahead=4, draft_dir=tmp_path / "oss")
