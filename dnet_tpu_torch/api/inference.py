"""The decode driver: chat request -> token loop -> SSE chunks.

Counterpart of dnet_tpu/api/inference.py: template + encode, a nonce per
request, the per-token send / await / detokenize loop, EOS, stop-sequence
and length stops, logprobs, usage, and non-streaming aggregation, with the
same chunk sequence the reference emits.  Admission is a plain bound on
concurrent requests plus the reference's deadline checks: a request that
arrives past its deadline is shed at the gate (429), one whose deadline
passes between decode steps ends with DeadlineExceededError (504), and in
ring mode the deadline rides every frame.  A step's capacity and deadline
errors come back typed (`classify_result_error`).  Resume, the bounded
queue, SLO tracking and the flight recorder are not part of the port yet.
"""

from __future__ import annotations

import asyncio
import time
from typing import AsyncIterator, Optional

from dnet_tpu_torch.admission.controller import Deadline, DeadlineGate, request_deadline
from dnet_tpu_torch.api.schemas import (
    ChatChoice,
    ChatChoiceDelta,
    ChatCompletionChunk,
    ChatCompletionRequest,
    ChatCompletionResponse,
    ChatMessage,
    ChatStreamChoice,
    ChoiceLogprobs,
    CompletionChoice,
    CompletionLogprobs,
    CompletionResponse,
    LogprobEntry,
    RequestMetrics,
    TopLogprob,
    Usage,
    new_request_id,
)
from dnet_tpu_torch.api.strategies import ApiAdapterBase
from dnet_tpu_torch.config import admission_settings
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.utils.logger import get_logger
from dnet_tpu_torch.utils.tokenizer import Detokenizer

log = get_logger()


class InferenceError(Exception):
    pass


class PromptTooLongError(InferenceError):
    """Maps to HTTP 400 (client error) rather than 500."""


class BackpressureError(InferenceError):
    """A capacity limit refused the work (paged-KV pool exhausted, batch
    slots full): maps to HTTP 429, never 500 -- the client should back off
    and retry, nothing is broken."""


class DeadlineExceededError(InferenceError):
    """The request's end-to-end deadline expired mid-flight: maps to HTTP
    504.  Raised by the decode loop between steps, or classified from a
    shard's `deadline exceeded` error."""


class EngineCapabilityError(InferenceError):
    """The engine cannot serve the requested configuration (raised at load,
    e.g. by core/batch.py for what the port does not serve yet): maps to
    HTTP 422, an operator/config error."""


# capacity-exhaustion signatures that cross the compute boundary as error
# strings (TokenResult.error); the one place turning them back into typed
# backpressure
_BACKPRESSURE_MARKERS = (
    "paged KV pool exhausted",  # kv/paged.py KVPoolExhausted
    "no free batch slots",  # core/batch.py slot-pool overflow
)


def classify_result_error(error: str) -> InferenceError:
    """Map a step's error string to the typed exception the HTTP layer turns
    into a status code (429 backpressure, 504 deadline, 500 otherwise)."""
    if "deadline exceeded" in error:
        return DeadlineExceededError(error)
    if any(marker in error for marker in _BACKPRESSURE_MARKERS):
        return BackpressureError(error)
    return InferenceError(error)


def completion_logprobs(entries: list, offset0: int = 0) -> CompletionLogprobs:
    """Chat-style LogprobEntry list -> the OpenAI text_completion logprobs
    shape ({tokens, token_logprobs, top_logprobs, text_offset})."""
    out = CompletionLogprobs()
    offset = offset0
    for e in entries:
        out.tokens.append(e.token)
        out.token_logprobs.append(e.logprob)
        out.top_logprobs.append({t.token: t.logprob for t in e.top_logprobs})
        out.text_offset.append(offset)
        offset += len(e.token)
    return out


def _holdback_len(text: str, stop_seqs: list[str]) -> int:
    """Length of the longest suffix of `text` that is a proper prefix of any
    stop sequence (held back: the next token may complete a stop)."""
    hold = 0
    for s in stop_seqs:
        for k in range(min(len(s) - 1, len(text)), 0, -1):
            if text.endswith(s[:k]):
                hold = max(hold, k)
                break
    return hold


class InferenceManager:
    def __init__(
        self,
        adapter: ApiAdapterBase,
        request_timeout_s: float = 300.0,
        max_concurrent: int = 8,
    ) -> None:
        self.adapter = adapter
        self.tokenizer = None  # set by the model manager on load
        self.model_id = None
        self.request_timeout_s = request_timeout_s
        self.max_concurrent = max_concurrent
        self._slots = asyncio.Semaphore(max_concurrent)
        self.active = 0  # admitted requests in flight
        self.gate = DeadlineGate()

    @property
    def ready(self) -> bool:
        return self.tokenizer is not None and self.model_id is not None

    def _decoding(self, req: ChatCompletionRequest) -> DecodingParams:
        return DecodingParams(
            temperature=req.temperature,
            top_p=req.top_p,
            top_k=req.top_k,
            min_p=req.min_p,
            repetition_penalty=req.repetition_penalty,
            min_tokens_to_keep=req.min_tokens_to_keep,
            logprobs=req.logprobs_enabled,
            top_logprobs=req.top_logprobs,
            seed=req.seed,
            logit_bias=req.logit_bias_ids(),
            stop_token_ids=tuple(self.tokenizer.eos_token_ids),
        )

    def _logprob_entry(self, result, text: str) -> LogprobEntry:
        top = [
            TopLogprob(
                token=self.tokenizer.decode([tid]),
                logprob=lp,
                bytes=list(self.tokenizer.decode([tid]).encode("utf-8")),
            )
            for tid, lp in (result.top_logprobs or [])
        ]
        return LogprobEntry(
            token=text,
            logprob=result.logprob or 0.0,
            bytes=list(text.encode("utf-8")),
            top_logprobs=top,
        )

    @staticmethod
    def _deadline_for(req) -> Optional[Deadline]:
        return request_deadline(getattr(req, "deadline_s", None), admission_settings().request_deadline_s)

    async def generate_stream(self, req) -> AsyncIterator[ChatCompletionChunk]:
        """Per-token chunks; the final chunk carries finish_reason/usage.
        A request already past its deadline raises AdmissionRejected on the
        consumer's first `anext` (429 + Retry-After upstream)."""
        if not self.ready:
            raise InferenceError("no model loaded")
        deadline = self._deadline_for(req)
        self.gate.check(deadline)
        async with self._slots:
            self.active += 1
            t_admit = time.monotonic()
            try:
                async for chunk in self._run(req, deadline):
                    yield chunk
            finally:
                self.active -= 1
                self.gate.observe_service(time.monotonic() - t_admit)

    async def _await_step(self, nonce: str, step: int, deadline: Optional[Deadline]):
        """The step's token, awaited no longer than the deadline leaves: a
        deadline passing between or during steps raises
        DeadlineExceededError."""
        if deadline is None:
            return await self.adapter.await_token(nonce, step, self.request_timeout_s)
        timeout = min(self.request_timeout_s, max(deadline.remaining(), 0.001))
        try:
            return await self.adapter.await_token(nonce, step, timeout)
        except asyncio.TimeoutError as exc:
            if deadline.expired:
                raise DeadlineExceededError(f"request deadline expired awaiting step {step}") from exc
            raise

    async def _run(self, req, deadline: Optional[Deadline] = None) -> AsyncIterator[ChatCompletionChunk]:
        rid = new_request_id()
        nonce = rid
        t_start = time.perf_counter()
        t_first = None
        generated = 0
        finish_reason = "length"
        tok = self.tokenizer
        prompt_ids = tok.encode(req.render_prompt(tok))
        decoding = self._decoding(req)
        stop_seqs = req.stop_sequences()
        eos = tok.eos_token_ids
        detok = Detokenizer(tok)
        max_new = req.completion_tokens_limit

        capacity = self.adapter.max_seq()
        if capacity is not None:
            if len(prompt_ids) >= capacity:
                raise PromptTooLongError(
                    f"prompt is {len(prompt_ids)} tokens but the serving context is {capacity}"
                )
            max_new = min(max_new, capacity - len(prompt_ids))

        pending = ""  # emitted-text buffer held back for stop-seq match
        held_entries: list = []  # logprob entries for held-back tokens
        emitted_ahead = 0  # emitted chars owned by the oldest held entry
        first_chunk = True  # first streamed delta carries role=assistant
        stopped_by_seq = False

        await self.adapter.reset_cache(nonce)
        if deadline is not None:
            # in ring mode every frame carries it: shards drop expired ones
            self.adapter.set_deadline(nonce, deadline.t_deadline)
        try:
            send_ids = list(prompt_ids)
            for step in range(max_new):
                if deadline is not None and deadline.expired:
                    # every further token is work nobody is waiting for
                    raise DeadlineExceededError(f"request deadline expired after {generated} token(s)")
                await self.adapter.send_tokens(nonce, send_ids, decoding, step, budget=max_new - step)
                result = await self._await_step(nonce, step, deadline)
                if result.error:
                    raise classify_result_error(result.error)
                if t_first is None:
                    t_first = time.perf_counter()
                generated += 1

                if result.token_id in eos:
                    finish_reason = "stop"
                    break

                delta = detok.add(result.token_id)
                send_ids = [result.token_id]
                if req.logprobs_enabled:
                    held_entries.append(self._logprob_entry(result, delta))

                # stop sequences: never emit text at or beyond a match, and
                # hold back any suffix that could still become one
                stopped = False
                if stop_seqs:
                    pending += delta
                    delta = ""
                    for s in stop_seqs:
                        idx = pending.find(s)
                        if idx != -1:
                            pending = pending[:idx]
                            stopped = True
                            break
                    if stopped:
                        delta, pending = pending, ""
                    else:
                        hold = _holdback_len(pending, stop_seqs)
                        emit_upto = len(pending) - hold
                        delta, pending = pending[:emit_upto], pending[emit_upto:]

                if delta or stopped:
                    logprobs = None
                    if req.logprobs_enabled and held_entries:
                        # flush only entries whose token text is fully
                        # emitted; one straddling the holdback stays held
                        budget = emitted_ahead + len(delta)
                        kept = []
                        while held_entries and len(held_entries[0].token) <= budget:
                            budget -= len(held_entries[0].token)
                            kept.append(held_entries.pop(0))
                        if stopped:
                            held_entries = []
                            emitted_ahead = 0
                        else:
                            emitted_ahead = budget
                        if kept:
                            logprobs = ChoiceLogprobs(content=kept)
                    yield ChatCompletionChunk(
                        id=rid,
                        model=req.model,
                        choices=[
                            ChatStreamChoice(
                                delta=ChatChoiceDelta(
                                    role=("assistant" if first_chunk else None),
                                    content=delta,
                                ),
                                logprobs=logprobs,
                            )
                        ],
                    )
                    first_chunk = False
                if stopped:
                    finish_reason = "stop"
                    stopped_by_seq = True
                    break

            # on EOS/length the held-back text is real content: flush it;
            # only a stop-sequence match discards its own matched text
            tail = pending + detok.flush() if not stopped_by_seq else ""
            if tail or (held_entries and not stopped_by_seq):
                logprobs = (
                    ChoiceLogprobs(content=held_entries)
                    if req.logprobs_enabled and held_entries and not stopped_by_seq
                    else None
                )
                yield ChatCompletionChunk(
                    id=rid,
                    model=req.model,
                    choices=[
                        ChatStreamChoice(
                            delta=ChatChoiceDelta(
                                role=("assistant" if first_chunk else None), content=tail
                            ),
                            logprobs=logprobs,
                        )
                    ],
                )
                first_chunk = False

            t_end = time.perf_counter()
            usage = Usage(
                prompt_tokens=len(prompt_ids),
                completion_tokens=generated,
                total_tokens=len(prompt_ids) + generated,
            )
            metrics = None
            if req.profile:
                metrics = RequestMetrics.from_times(
                    (t_end - t_start) * 1000,
                    ((t_first or t_end) - t_start) * 1000,
                    generated,
                )
            yield ChatCompletionChunk(
                id=rid,
                model=req.model,
                choices=[
                    ChatStreamChoice(
                        # a stream with no content delta still owes the client
                        # the initial role chunk
                        delta=ChatChoiceDelta(role=("assistant" if first_chunk else None)),
                        finish_reason=finish_reason,
                    )
                ],
                usage=usage,
                metrics=metrics,
            )
        finally:
            # a finished or abandoned request (client disconnect closes this
            # generator) frees its KV at once
            await self.adapter.reset_cache(nonce)

    async def _collect(self, req):
        """Drain the decode stream into (rid, text, logprob entries,
        finish_reason, usage, metrics)."""
        parts: list[str] = []
        logprob_entries: list[LogprobEntry] = []
        usage = Usage()
        metrics = None
        finish_reason = "stop"
        rid = new_request_id()
        async for chunk in self.generate_stream(req):
            rid = chunk.id
            for choice in chunk.choices:
                if choice.delta.content:
                    parts.append(choice.delta.content)
                if choice.logprobs:
                    logprob_entries.extend(choice.logprobs.content)
                if choice.finish_reason:
                    finish_reason = choice.finish_reason
            if chunk.usage:
                usage = chunk.usage
            if chunk.metrics:
                metrics = chunk.metrics
        return rid, "".join(parts), logprob_entries, finish_reason, usage, metrics

    async def generate(self, req: ChatCompletionRequest) -> ChatCompletionResponse:
        """Non-streaming chat: aggregate the stream."""
        rid, text, logprob_entries, finish_reason, usage, metrics = await self._collect(req)
        return ChatCompletionResponse(
            id=rid,
            model=req.model,
            choices=[
                ChatChoice(
                    message=ChatMessage(role="assistant", content=text),
                    logprobs=ChoiceLogprobs(content=logprob_entries) if req.logprobs_enabled else None,
                    finish_reason=finish_reason,
                )
            ],
            usage=usage,
            metrics=metrics,
        )

    async def generate_completion(self, req) -> CompletionResponse:
        """Legacy /v1/completions (non-streaming)."""
        rid, text, logprob_entries, finish_reason, usage, metrics = await self._collect(req)
        offset0 = 0
        if req.echo:
            text = req.prompt_text() + text
            offset0 = len(req.prompt_text())
        return CompletionResponse(
            id=rid.replace("chatcmpl", "cmpl"),
            model=req.model,
            choices=[
                CompletionChoice(
                    text=text,
                    logprobs=completion_logprobs(logprob_entries, offset0)
                    if req.logprobs_enabled
                    else None,
                    finish_reason=finish_reason,
                )
            ],
            usage=usage,
            metrics=metrics,
        )
