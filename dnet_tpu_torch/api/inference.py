"""The decode driver: chat request -> token loop -> SSE chunks.

Counterpart of dnet_tpu/api/inference.py: template + encode, a nonce per
request, the per-token send / await / detokenize loop, EOS, stop-sequence
and length stops, logprobs, usage, and non-streaming aggregation, with the
same chunk sequence the reference emits.  Requests pass the reference's
`AdmissionController` (admission/controller.py): a bounded wait queue that
sheds with 429 + Retry-After, deadline-aware shedding, and drain (503).
One whose deadline passes between decode steps ends with
DeadlineExceededError (504), and in ring mode the deadline rides every
frame.  A step's capacity and deadline errors come back typed
(`classify_result_error`).  Each request is recorded as the reference
records it: the flight recorder's spans (admission wait, ttft, each
decode step, the closing request span), the request / token / error
counters and the TTFT histogram, the SLO windows, the critical-path
ledger (in `metrics.critical_path` when the request asks to profile) and
one `request_complete` wide event.  /v1/embeddings passes the same
admission.  In ring mode the failure monitor (api/failure.py) fails a
request fast when a shard goes down (ServiceDegradedError, 503), and
behind DNET_RESILIENCE_RESUME=1 every decode step goes through a
`ResumableDecode` (resilience/checkpoint.py): a failed step waits for the
ring to recover, replays prompt + generated under `rid#rN`, and takes the
replay's token as its own, on the same client stream.
"""

from __future__ import annotations

import asyncio
import base64
import time
from typing import AsyncIterator, Optional

import numpy as np

from dnet_tpu_torch.admission.controller import (
    AdmissionController,
    AdmissionRejected,
    Deadline,
    deadline_expired,
    request_deadline,
)
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
    EmbeddingData,
    EmbeddingsResponse,
    EmbeddingsUsage,
    LogprobEntry,
    RequestMetrics,
    TopLogprob,
    Usage,
    new_request_id,
)
from dnet_tpu_torch.api.strategies import ApiAdapterBase
from dnet_tpu_torch.config import admission_settings, kv_settings, sched_settings, wire_settings
from dnet_tpu_torch.core.types import DecodingParams
from dnet_tpu_torch.obs import critical_path, get_recorder, get_slo_tracker, metric
from dnet_tpu_torch.obs.events import bind, log_event
from dnet_tpu_torch.resilience.checkpoint import ResumableDecode
from dnet_tpu_torch.resilience.policy import is_retryable
from dnet_tpu_torch.utils.logger import get_logger
from dnet_tpu_torch.utils.tokenizer import Detokenizer

log = get_logger()

_TTFT_MS = metric("dnet_ttft_ms")
_REQUESTS = metric("dnet_requests_total")
_REQUEST_ERRORS = metric("dnet_request_errors_total")
_TOKENS_TOTAL = metric("dnet_tokens_generated_total")
_CANCELS = metric("dnet_cancel_propagated_total")


class InferenceError(Exception):
    pass


class PromptTooLongError(InferenceError):
    """Maps to HTTP 400 (client error) rather than 500."""


class ServiceDegradedError(InferenceError):
    """The ring has shards down: maps to HTTP 503 at once, instead of a
    request waiting out its token timeout."""


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
    "no free lanes",  # shard/lanes.py lane-pool overflow
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


def _event_status(exc: BaseException) -> int:
    """HTTP status a failed request's `request_complete` event carries: the
    mapping api/http.py `_map_inference_errors` applies."""
    if isinstance(exc, AdmissionRejected):
        return 503 if exc.reason == "draining" else 429
    if isinstance(exc, BackpressureError):
        return 429
    if isinstance(exc, DeadlineExceededError):
        return 504
    if isinstance(exc, PromptTooLongError):
        return 400
    if isinstance(exc, EngineCapabilityError):
        return 422
    if isinstance(exc, ServiceDegradedError):
        return 503
    return 500


def _resolved_modes() -> dict:
    """The serving-mode knobs beside a request's outcome: wire codec, KV
    layout, TP degree (1: not ported) and whether the scheduler served."""
    kv = kv_settings()
    return {
        "codec": wire_settings().codec,
        "kv": "ragged" if kv.ragged else ("paged" if kv.paged else "dense"),
        "tp": 1,
        "sched": sched_settings().sched,
    }


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
        self.failure_monitor = None  # RingFailureMonitor in ring mode
        adm = admission_settings()
        # the front door: bounded queue, shedding, Retry-After, drain
        self.admission = AdmissionController(
            max_concurrent, queue_depth=adm.admit_queue_depth, queue_timeout_s=adm.admit_queue_timeout_s
        )

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
        Admission happens on the consumer's first `anext`: a shed request
        raises AdmissionRejected (429 / 503 + Retry-After upstream) before
        any chunk."""
        if not self.ready:
            raise InferenceError("no model loaded")
        deadline = self._deadline_for(req)
        t_admit = time.perf_counter()
        try:
            async with self.admission.slot(deadline):
                # queued-at-the-gate time: _run backdates it onto the
                # timeline as the admission_wait segment
                admit_wait_ms = (time.perf_counter() - t_admit) * 1000.0
                async for chunk in self._run(req, deadline, admit_wait_ms):
                    yield chunk
        except AdmissionRejected as rej:
            # shed before a rid existed: still one finished request
            log_event(
                "request_complete",
                status=_event_status(rej),
                finish_reason="shed",
                shed=True,
                shed_reason=rej.reason,
                tokens=0,
                total_ms=round((time.perf_counter() - t_admit) * 1000.0, 3),
            )
            raise

    async def _run(
        self, req, deadline: Optional[Deadline] = None, admit_wait_ms: float = 0.0
    ) -> AsyncIterator[ChatCompletionChunk]:
        rid = new_request_id()
        nonce = rid
        # every log record and wide event of this request carries the rid;
        # entered by hand so the finally below always exits it
        ctx = bind(rid=rid, node="api")
        ctx.__enter__()
        t_start = time.perf_counter()
        t_first = None
        generated = 0
        finish_reason = "length"
        recorder = get_recorder()
        slo = get_slo_tracker()
        completed = False  # one request_complete a request
        resume = None  # built once the adapter holds a session for the nonce
        prompt_ids: list = []
        try:
            self._check_degraded()
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

            recorder.begin(rid)
            if admit_wait_ms > 0.0:
                # the wait happened before this timeline's origin: a
                # negative start keeps [0, e2e] the admitted window while
                # the ledger still carries the queued time
                recorder.span(rid, "admission_wait", admit_wait_ms, t_ms=-admit_wait_ms, force=True)
            _REQUESTS.inc()
            pending = ""  # emitted-text buffer held back for stop-seq match
            held_entries: list = []  # logprob entries for held-back tokens
            emitted_ahead = 0  # emitted chars owned by the oldest held entry
            first_chunk = True  # first streamed delta carries role=assistant
            stopped_by_seq = False

            await self.adapter.reset_cache(nonce)
            if deadline is not None:
                # in ring mode every frame carries it: shards drop expired ones
                self.adapter.set_deadline(nonce, deadline.t_deadline)
            # owns the wire nonce and the step mapping, so that a failed
            # step can be replayed on a recovered ring; the adapter is a
            # getter because auto-recovery installs a new one
            resume = ResumableDecode(
                lambda: self.adapter, rid, prompt_ids, monitor=self.failure_monitor,
                timeout_s=self.request_timeout_s,
            )
            send_ids = list(prompt_ids)
            for step in range(max_new):
                if deadline is not None:
                    if deadline.expired:
                        # every further token is work nobody is waiting for
                        deadline_expired("api_step")
                        raise DeadlineExceededError(f"request deadline expired after {generated} token(s)")
                    # the token await is bounded by what the deadline leaves
                    resume.timeout_s = min(self.request_timeout_s, max(deadline.remaining(), 0.001))
                t_step = time.perf_counter()
                try:
                    # per step: the monitor's fail_pending only reaches the
                    # futures pending when the shard went down
                    self._check_degraded()
                    await resume.send(send_ids, decoding, step, budget=max_new - step)
                    result = await resume.await_token(step)
                    if result.error:
                        raise classify_result_error(result.error)
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    if deadline is not None and deadline.expired and isinstance(exc, asyncio.TimeoutError):
                        deadline_expired("api_step")
                        raise DeadlineExceededError(f"request deadline expired awaiting step {step}") from exc
                    if isinstance(exc, (DeadlineExceededError, BackpressureError)):
                        # shed work is not replayed
                        raise
                    if not (isinstance(exc, (InferenceError, asyncio.TimeoutError)) or is_retryable(exc)):
                        raise
                    # None: resume off or exhausted, the failure surfaces
                    result = await resume.try_resume(exc, decoding, step, budget=max_new - step)
                    if result is None:
                        raise
                # one span a token: send -> token resolved
                step_ms = (time.perf_counter() - t_step) * 1000
                recorder.span(rid, "decode_step", step_ms, step=step)
                if step > 0:
                    # step 0 is the prefill: TTFT owns it
                    slo.record_decode(step_ms)
                if t_first is None:
                    t_first = time.perf_counter()
                    ttft_ms = (t_first - t_start) * 1000
                    _TTFT_MS.observe(ttft_ms)
                    slo.record_ttft(ttft_ms)
                    recorder.span(rid, "ttft", ttft_ms, t_ms=0.0, force=True)
                generated += 1
                _TOKENS_TOTAL.inc()

                if result.token_id in eos:
                    finish_reason = "stop"
                    break

                delta = detok.add(result.token_id)
                send_ids = [result.token_id]
                # a later resume replays prompt + the accepted tokens
                resume.record(result.token_id)
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
            # the request span closes the timeline; RequestMetrics is a view
            # over the recorded spans
            recorder.span(
                rid, "request", (t_end - t_start) * 1000, t_ms=0.0,
                tokens=generated, prompt_tokens=len(prompt_ids),
                finish_reason=finish_reason, force=True,
            )
            # the segment ledger feeds dnet_request_segment_ms for every
            # request, and rides the final chunk when the client profiles
            ledger = critical_path.decompose(recorder.timeline(rid))
            critical_path.observe(ledger)
            log_event(
                "request_complete",
                status=200,
                finish_reason=finish_reason,
                shed=False,
                tokens=generated,
                prompt_tokens=len(prompt_ids),
                total_ms=round((t_end - t_start) * 1000.0, 3),
                modes=_resolved_modes(),
                critical_path=ledger,
            )
            completed = True
            metrics = None
            if req.profile:
                metrics = RequestMetrics.from_timeline(recorder.timeline(rid))
                metrics.critical_path = ledger
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
            slo.record_request(ok=True)
        except (GeneratorExit, asyncio.CancelledError):
            # the client went away (an SSE disconnect closes this generator)
            _CANCELS.inc()
            if not completed:
                # 499: the client-closed-request convention
                log_event(
                    "request_complete",
                    status=499,
                    finish_reason="cancelled",
                    shed=False,
                    tokens=generated,
                    prompt_tokens=len(prompt_ids),
                    total_ms=round((time.perf_counter() - t_start) * 1000.0, 3),
                    modes=_resolved_modes(),
                )
                completed = True
            raise
        except Exception as exc:
            # shed work (429 capacity, 504 deadline) is not failed work: it
            # burns neither the availability SLO nor the error counter
            shed = isinstance(exc, (BackpressureError, DeadlineExceededError))
            if not shed:
                _REQUEST_ERRORS.inc()
                slo.record_request(ok=False)
            if not completed:
                log_event(
                    "request_complete",
                    status=_event_status(exc),
                    finish_reason="shed" if shed else "error",
                    shed=shed,
                    shed_reason=(
                        "deadline" if isinstance(exc, DeadlineExceededError)
                        else "backpressure" if shed else ""
                    ),
                    error=str(exc)[:200],
                    tokens=generated,
                    prompt_tokens=len(prompt_ids),
                    total_ms=round((time.perf_counter() - t_start) * 1000.0, 3),
                    modes=_resolved_modes(),
                )
                completed = True
            raise
        finally:
            # a finished or abandoned request frees its KV at once; a reset
            # that fails (the ring just died) is logged, never raised over
            # the request's own outcome
            try:
                if resume is not None:
                    await resume.cleanup()
            finally:
                ctx.__exit__(None, None, None)

    def _check_degraded(self) -> None:
        monitor = self.failure_monitor
        if monitor is not None and monitor.degraded:
            raise ServiceDegradedError(f"ring degraded: shard(s) {monitor.down_shards()} down")

    async def embeddings(self, req) -> EmbeddingsResponse:
        """/v1/embeddings: mean-pooled final hidden states, one vector an
        input.  Takes a string, a list of strings, a token list or a batch
        of token lists, and the base64 encoding.  Embeddings use the same
        compute as decode, so they pass the same admission."""
        async with self.admission.slot(self._deadline_for(req)):
            return await self._embeddings(req)

    async def _embeddings(self, req) -> EmbeddingsResponse:
        raw = req.input
        if isinstance(raw, str):
            batches = [self.tokenizer.encode(raw)]
        elif raw and isinstance(raw[0], str):
            batches = [self.tokenizer.encode(s) for s in raw]
        elif raw and isinstance(raw[0], list):
            batches = [list(ids) for ids in raw]
        else:
            batches = [list(raw)]
        if any(not b for b in batches):
            raise ValueError("embeddings input contains an empty entry")
        vecs = await self.adapter.embed(batches)
        if req.encoding_format == "base64":
            vecs = [base64.b64encode(np.asarray(v, dtype=np.float32).tobytes()).decode("ascii") for v in vecs]
        data = [EmbeddingData(index=i, embedding=v) for i, v in enumerate(vecs)]
        n_tok = sum(len(b) for b in batches)
        return EmbeddingsResponse(
            data=data,
            model=self.model_id or req.model,
            usage=EmbeddingsUsage(prompt_tokens=n_tok, total_tokens=n_tok),
        )

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
