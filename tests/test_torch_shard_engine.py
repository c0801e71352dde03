"""The port's engine in shard mode: layer ranges [0,1] and [2,3] of the
tiny Llama, chained through hidden states, against the port's full engine
(logits) and against dnet_tpu's shard-mode engines (hidden states), through
a prefill and 8 decode steps.  Tolerance 2e-3: f32 parameters, sums taken
in another order by each framework.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnet_tpu_torch.core.engine import LocalEngine, bucket_length

pytestmark = pytest.mark.core

MAX_SEQ = 64
PROMPT = [256, 72, 101, 108, 108, 111, 32, 119, 111, 114, 108, 100]
TOL = 2e-3


def _port(model_dir, layers=None):
    return LocalEngine(model_dir, max_seq=MAX_SEQ, param_dtype="float32", device="cpu",
                       layers=layers, shard_mode=layers is not None)


def _tokens(ids, pos):
    T = len(ids)
    Tpad = 1 if T == 1 else min(bucket_length(T), MAX_SEQ - pos)
    out = np.zeros((1, Tpad), np.int64)
    out[0, :T] = ids
    return out, T


def test_chained_shards_give_the_full_engines_logits(tiny_llama_dir):
    full, head, tail = _port(tiny_llama_dir), _port(tiny_llama_dir, [0, 1]), _port(tiny_llama_dir, [2, 3])
    for e in (full, head, tail):
        e.new_session("n", seed=0)
    ids, pos = list(PROMPT), 0
    for step in range(9):
        toks, T = _tokens(ids, pos)
        want = full._forward(torch.from_numpy(toks), full.sessions["n"].kv, pos, T - 1)
        x = head.embed_window(head.sessions["n"], torch.from_numpy(toks), pos)
        x = tail.run_layers(tail.sessions["n"], x, pos)
        m = tail.model
        got = m.lm_project(tail.edge_params, m.normalize(tail.edge_params, x[:, T - 1 : T]))[:, 0]
        assert (got - want).abs().max().item() <= TOL, step
        nxt = int(want.argmax(-1)[0])
        assert int(got.argmax(-1)[0]) == nxt
        pos += T
        ids = [nxt]


def test_shard_hidden_states_match_the_reference_shards(tiny_llama_dir):
    from dnet_tpu.core.engine import LocalEngine as RefEngine

    ref = [RefEngine(tiny_llama_dir, layers=ls, max_seq=MAX_SEQ, param_dtype="float32", shard_mode=True)
           for ls in ([0, 1], [2, 3])]
    port = [_port(tiny_llama_dir, ls) for ls in ([0, 1], [2, 3])]
    ref_sess = [e.new_session("n", seed=0) for e in ref]
    port_sess = [e.new_session("n", seed=0) for e in port]
    rng = np.random.default_rng(0)
    ids, pos = list(PROMPT), 0
    for step in range(9):  # the prompt, then 8 decode steps
        toks, T = _tokens(ids, pos)
        xr, ref_sess[0].kv = ref[0]._embed_window(
            ref[0].window_params, ref[0].edge_params, jnp.asarray(toks, jnp.int32), ref_sess[0].kv,
            jnp.int32(pos), jnp.int32(T))
        xp = port[0].embed_window(port_sess[0], torch.from_numpy(toks), pos)
        assert np.abs(np.asarray(xr)[:, :T] - xp[:, :T].numpy()).max() <= TOL, ("head", step)
        # the tail takes the head's real rows, padded again as a shard pads them
        h = np.zeros_like(np.asarray(xr))
        h[:, :T] = np.asarray(xr)[:, :T]
        yr, ref_sess[1].kv = ref[1]._hidden(ref[1].window_params, jnp.asarray(h), ref_sess[1].kv,
                                            jnp.int32(pos), jnp.int32(T))
        yp = port[1].run_layers(port_sess[1], torch.from_numpy(h), pos)
        assert np.abs(np.asarray(yr)[:, :T] - yp[:, :T].numpy()).max() <= TOL, ("tail", step)
        pos += T
        ids = [int(rng.integers(0, 256))]


@pytest.mark.parametrize("tied", [False, True])
def test_shards_load_only_their_edges(tmp_path, tied):
    from tests.fakes.checkpoints import make_tiny_llama

    make_tiny_llama(tmp_path, {"tie_word_embeddings": tied})
    head, mid, tail = (_port(tmp_path, ls) for ls in ([0], [1, 2], [3]))
    assert set(head.edge_params) == {"embed"}
    assert set(mid.edge_params) == set()
    assert set(tail.edge_params) == ({"final_norm", "embed"} if tied else {"final_norm", "lm_head"})
    assert (head.model.is_first, head.model.is_last, tail.model.is_first, tail.model.is_last) == \
        (True, False, False, True)
    assert len(mid.window_params) == 2 and mid.model.layers == [1, 2]
    assert set(_port(tmp_path).edge_params) == ({"embed", "final_norm"} if tied else
                                                {"embed", "final_norm", "lm_head"})


def test_tail_samples_as_the_single_process_engine(tiny_llama_dir):
    """hidden_tail's sample, penalty counts and seeded draws are the
    single-process step's: a seeded sampled prompt gives the same token."""
    from dnet_tpu_torch.core.types import DecodingParams

    dec = DecodingParams(temperature=0.9, top_k=20, repetition_penalty=1.2, seed=11)
    full = _port(tiny_llama_dir)
    want = int(full.prefill_and_sample("n", PROMPT, dec).token[0])
    head, tail = _port(tiny_llama_dir, [0, 1]), _port(tiny_llama_dir, [2, 3])
    toks, T = _tokens(PROMPT, 0)
    x = head.embed_window(head.new_session("n", seed=11), torch.from_numpy(toks), 0)
    sess = tail.new_session("n", seed=11)
    got = int(tail.hidden_tail(sess, x, 0, T - 1, dec).token[0])
    assert got == want
    assert int(sess.counts.sum()) == 1
