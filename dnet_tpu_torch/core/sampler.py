"""Token sampling on the device: temperature / top-k / top-p / min-p, logit
bias, repetition penalty and logprobs.

Counterpart of dnet_tpu/core/sampler.py with the same filter order and
semantics.  The reference keeps every knob traced under jit; here the
knobs are host scalars and `SamplePlan` skips the machinery a request does
not use.  A batched step samples its lanes one by one (`sample_lanes`),
each with its own knobs, counts and generator.  The Gumbel noise comes from a `torch.Generator`, so a sampled
stream is reproducible from its seed inside the port but cannot match the
reference's `jax.random` stream bit for bit.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from dnet_tpu_torch.core.types import DecodingParams

MAX_TOP_LOGPROBS = 20  # static width of the top-logprob outputs (OpenAI API max)
MAX_LOGIT_BIAS = 300  # the OpenAI API's cap on logit_bias entries


def encode_logit_bias(bias) -> tuple:
    """dict {token_id: bias} -> fixed-width (ids [MAX], vals [MAX]) numpy
    arrays, id -1 padding.  None = no bias."""
    ids = np.full((MAX_LOGIT_BIAS,), -1, dtype=np.int64)
    vals = np.zeros((MAX_LOGIT_BIAS,), dtype=np.float32)
    if bias:
        if len(bias) > MAX_LOGIT_BIAS:
            raise ValueError(
                f"logit_bias supports at most {MAX_LOGIT_BIAS} entries; got {len(bias)}"
            )
        for i, (t, b) in enumerate(sorted(bias.items())):
            ids[i] = int(t)
            vals[i] = float(b)
    return ids, vals


class SampleParams(NamedTuple):
    """Sampling knobs: host scalars, plus the logit-bias table on the device
    (None when the request has no bias)."""

    temperature: float
    top_p: float
    top_k: int  # 0 disables
    min_p: float
    repetition_penalty: float  # 1.0 disables
    min_tokens_to_keep: int
    bias_ids: Optional[torch.Tensor]  # [MAX_LOGIT_BIAS] int64, -1 = unused
    bias_vals: Optional[torch.Tensor]  # [MAX_LOGIT_BIAS] f32

    @classmethod
    def from_decoding(cls, d: DecodingParams, device=None) -> "SampleParams":
        ids = vals = None
        if d.logit_bias:
            ids_np, vals_np = encode_logit_bias(d.logit_bias)
            ids = torch.from_numpy(ids_np).to(device)
            vals = torch.from_numpy(vals_np).to(device)
        return cls(
            temperature=float(d.temperature),
            top_p=float(d.top_p),
            top_k=int(d.top_k),
            min_p=float(d.min_p),
            repetition_penalty=float(d.repetition_penalty),
            min_tokens_to_keep=int(d.min_tokens_to_keep),
            bias_ids=ids,
            bias_vals=vals,
        )


class SamplePlan(NamedTuple):
    """Which sampling machinery a request uses, derived from its params."""

    greedy: bool  # temperature <= 0: token = argmax
    filters: bool  # any of top_p < 1 / top_k > 0 / min_p > 0 active
    logprobs: bool  # request wants logprob + top-logprob outputs
    penalty: bool  # repetition_penalty != 1
    bias: bool = False  # logit_bias present: added before everything

    @classmethod
    def from_decoding(cls, d: DecodingParams) -> "SamplePlan":
        return cls(
            greedy=d.temperature <= 0.0,
            filters=(d.top_p < 1.0) or (d.top_k > 0) or (d.min_p > 0.0),
            logprobs=bool(d.logprobs),
            penalty=d.repetition_penalty != 1.0,
            bias=bool(d.logit_bias),
        )


FULL_PLAN = SamplePlan(greedy=False, filters=True, logprobs=True, penalty=True, bias=True)


class SampleResult(NamedTuple):
    token: torch.Tensor  # [B] int32
    logprob: torch.Tensor  # [B] f32, log-softmax of the biased/penalized logits at token
    top_tokens: torch.Tensor  # [B, MAX_TOP_LOGPROBS] int32
    top_logprobs: torch.Tensor  # [B, MAX_TOP_LOGPROBS] f32


def pack_chunk_results(results: List[SampleResult], with_logprobs: bool) -> torch.Tensor:
    """Stack a decode chunk's per-step results into ONE f32 tensor [K, B, W]
    (token ids are exact in f32 for V < 2**24), so reading the chunk is a
    single device-to-host copy."""
    rows = []
    for r in results:
        cols = [r.token[:, None].float()]
        if with_logprobs:
            cols += [r.logprob[:, None], r.top_tokens.float(), r.top_logprobs]
        rows.append(torch.cat(cols, dim=-1))
    return torch.stack(rows)


def adjust_logits(
    logits: torch.Tensor,
    params: SampleParams,
    token_counts: Optional[torch.Tensor],
    plan: SamplePlan,
) -> torch.Tensor:
    """Logit bias, then repetition penalty: what greedy argmax, the filters
    and the reported logprobs all see."""
    if plan.bias and params.bias_ids is not None:
        # padded (-1) and out-of-vocab ids add zero instead of landing on a
        # real vocab row
        V = logits.shape[-1]
        in_vocab = (params.bias_ids >= 0) & (params.bias_ids < V)
        vals = torch.where(in_vocab, params.bias_vals, 0.0)
        ids = params.bias_ids.clamp(0, V - 1)
        logits = logits.float().index_add(1, ids, vals[None].expand(logits.shape[0], -1))
    if plan.penalty and token_counts is not None:
        logits = apply_repetition_penalty(logits, token_counts, params.repetition_penalty)
    return logits


def filter_logits(scaled: torch.Tensor, params: SampleParams) -> torch.Tensor:
    """Temperature-scaled logits with top-k, top-p and min-p applied
    (dropped tokens -inf), from one descending sort."""
    V = scaled.shape[-1]
    vals, idx = torch.sort(scaled, dim=-1, stable=True)  # ascending, as jnp.sort
    sorted_logits = vals.flip(-1)
    desc_idx = idx.flip(-1)
    ranks = torch.empty_like(desc_idx)
    ranks.scatter_(-1, desc_idx, torch.arange(V, device=scaled.device).expand_as(desc_idx))

    k = params.top_k if params.top_k > 0 else V
    keep_topk = ranks < k

    # smallest prefix of the sorted distribution with cumsum >= top_p
    # (rank 0 always kept)
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cumprobs = torch.cumsum(sorted_probs, dim=-1)
    prefix_keep_sorted = (cumprobs - sorted_probs) < params.top_p
    keep_topp = torch.gather(prefix_keep_sorted, -1, ranks)

    probs = torch.softmax(scaled, dim=-1)
    pmax = probs.amax(dim=-1, keepdim=True)
    keep_minp = probs >= params.min_p * pmax

    keep = keep_topk & keep_topp & keep_minp
    keep = keep | (ranks < max(params.min_tokens_to_keep, 1))
    return torch.where(keep, scaled, float("-inf"))


def sample(
    logits: torch.Tensor,
    params: SampleParams,
    generator: Optional[torch.Generator] = None,
    token_counts: Optional[torch.Tensor] = None,
    plan: Optional[SamplePlan] = None,
) -> SampleResult:
    """logits [B, V] -> sampled tokens with logprobs.

    Filter order as the reference: logit bias, repetition penalty over seen
    tokens, temperature, top-k, top-p, min-p, then a Gumbel-max draw from
    `generator`.  temperature <= 0 is greedy argmax.  Outputs a plan leaves
    off come back as zeros (shapes are the same for every plan).
    """
    if plan is None:
        plan = FULL_PLAN
    logits = adjust_logits(logits, params, token_counts, plan)
    B, V = logits.shape
    dev = logits.device

    if plan.greedy or params.temperature <= 0.0:
        token = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        scaled = logits.float() / max(params.temperature, 1e-6)
        masked = filter_logits(scaled, params) if plan.filters else scaled
        # Gumbel(0, 1) = -log(Exp(1))
        noise = -torch.empty_like(masked).exponential_(generator=generator).log()
        token = torch.argmax(masked + noise, dim=-1).to(torch.int32)

    if plan.logprobs:
        raw = torch.log_softmax(logits.float(), dim=-1)
        logprob = torch.gather(raw, -1, token[:, None].long())[:, 0]
        n_top = min(MAX_TOP_LOGPROBS, V)
        top_lp, top_ids = torch.topk(raw, n_top, dim=-1)
        if n_top < MAX_TOP_LOGPROBS:  # tiny-vocab tests: pad to the fixed width
            pad = MAX_TOP_LOGPROBS - n_top
            top_lp = torch.nn.functional.pad(top_lp, (0, pad), value=float("-inf"))
            top_ids = torch.nn.functional.pad(top_ids, (0, pad))
        top_ids = top_ids.to(torch.int32)
    else:
        logprob = torch.zeros((B,), dtype=torch.float32, device=dev)
        top_ids = torch.zeros((B, MAX_TOP_LOGPROBS), dtype=torch.int32, device=dev)
        top_lp = torch.zeros((B, MAX_TOP_LOGPROBS), dtype=torch.float32, device=dev)
    return SampleResult(token, logprob, top_ids, top_lp)


class LaneSampling(NamedTuple):
    """One active lane of a batched step: its slot, knobs and generator."""

    slot: int
    params: SampleParams
    plan: SamplePlan
    generator: Optional[torch.Generator]


def sample_lanes(
    logits: torch.Tensor, lanes: List[LaneSampling], counts: torch.Tensor
) -> List[SampleResult]:
    """Per-lane sampling for a batch: logits [slots, V]; counts [slots, V]
    int32, updated in place for the listed lanes.

    Each lane samples its own 1-row slice with its own params and generator,
    exactly as LocalEngine samples one sequence, so a lane's tokens depend
    only on its logits and its seed.  Lanes not listed (inactive) advance
    neither their counts nor their random stream: a seeded request's tokens
    do not depend on other traffic.  Returns one B=1 result per lane."""
    out = []
    for lane in lanes:
        row = slice(lane.slot, lane.slot + 1)
        res = sample(logits[row], lane.params, lane.generator, token_counts=counts[row], plan=lane.plan)
        counts[row].scatter_add_(1, res.token[:, None].long(), torch.ones_like(counts[row][:, :1]))
        out.append(res)
    return out


def apply_repetition_penalty(
    logits: torch.Tensor, token_counts: torch.Tensor, penalty: float
) -> torch.Tensor:
    """CTRL-style repetition penalty from a per-vocab count buffer.

    token_counts: [B, V] int32 counts of generated tokens; penalty 1.0 =
    disabled."""
    seen = token_counts > 0
    lf = logits.float()
    penalized = torch.where(lf > 0, lf / penalty, lf * penalty)
    return torch.where(seen, penalized, lf).to(logits.dtype)
