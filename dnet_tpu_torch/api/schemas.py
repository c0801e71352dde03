"""OpenAI-compatible request/response schemas (pydantic v2).

Counterpart of dnet_tpu/api/schemas.py, trimmed to the routes this slice
serves.  Field names, defaults and order are the reference's, so the same
request produces the same response bytes.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Literal, Optional, Union

from pydantic import BaseModel, Field, field_validator

from dnet_tpu_torch.core.sampler import MAX_LOGIT_BIAS


class ChatMessage(BaseModel):
    role: Literal["system", "user", "assistant", "tool"]
    content: Union[str, List[Dict[str, Any]], None] = None

    def text(self) -> str:
        if isinstance(self.content, str):
            return self.content
        if self.content is None:
            return ""
        return "".join(
            part.get("text", "")
            for part in self.content
            if isinstance(part, dict) and part.get("type") == "text"
        )


class SamplingRequest(BaseModel):
    """Shared decode-request surface: sampling knobs + stop handling."""

    model: str
    temperature: float = Field(default=1.0, ge=0.0, le=2.0)
    top_p: float = Field(default=1.0, gt=0.0, le=1.0)
    top_k: int = Field(default=0, ge=0)
    min_p: float = Field(default=0.0, ge=0.0, le=1.0)
    repetition_penalty: float = Field(default=1.0, gt=0.0)
    min_tokens_to_keep: int = Field(default=1, ge=1)
    max_tokens: Optional[int] = Field(default=None, ge=1)
    max_completion_tokens: Optional[int] = Field(default=None, ge=1)
    stream: bool = False
    stop: Optional[Union[str, List[str]]] = None
    seed: Optional[int] = None
    n: int = Field(default=1, ge=1, le=1)  # >1 unsupported
    user: Optional[str] = None
    profile: bool = False  # dnet extension: include perf metrics in the final chunk
    # dnet extension: end-to-end deadline for THIS request (seconds from
    # arrival), overriding DNET_REQUEST_DEADLINE_S: 429 when it arrives
    # expired, 504 when it passes between decode steps, and shards drop
    # expired frames (api/http.py, api/inference.py)
    deadline_s: Optional[float] = Field(default=None, gt=0.0)
    # OpenAI logit_bias: token id (stringified) -> additive bias in [-100, 100]
    logit_bias: Optional[Dict[str, float]] = None

    @field_validator("logit_bias")
    @classmethod
    def _check_logit_bias(cls, v):
        if not v:
            return v
        if len(v) > MAX_LOGIT_BIAS:
            raise ValueError(f"logit_bias supports at most {MAX_LOGIT_BIAS} entries")
        for tid, b in v.items():
            # ascii-decimal only: token ids are never negative
            if not str(tid).isdecimal():
                raise ValueError(f"logit_bias key {tid!r} is not a token id")
            if not -100.0 <= b <= 100.0:
                raise ValueError("logit_bias values must be in [-100, 100]")
        return v

    def logit_bias_ids(self) -> Optional[Dict[int, float]]:
        """Int-keyed form for DecodingParams (OpenAI sends string keys)."""
        if not self.logit_bias:
            return None
        return {int(t): float(b) for t, b in self.logit_bias.items()}

    _default_max_tokens: int = 256

    @property
    def completion_tokens_limit(self) -> int:
        return self.max_completion_tokens or self.max_tokens or self._default_max_tokens

    def stop_sequences(self) -> List[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)

    def render_prompt(self, tokenizer) -> str:
        raise NotImplementedError

    @property
    def logprobs_enabled(self) -> bool:
        return bool(getattr(self, "logprobs", False))


class ChatCompletionRequest(SamplingRequest):
    messages: List[ChatMessage]
    logprobs: bool = False
    top_logprobs: int = Field(default=0, ge=0, le=20)

    @field_validator("messages")
    @classmethod
    def _non_empty(cls, v):
        if not v:
            raise ValueError("messages must be non-empty")
        return v

    def render_prompt(self, tokenizer) -> str:
        return tokenizer.apply_chat_template(
            [m.model_dump() for m in self.messages], add_generation_prompt=True
        )


class CompletionRequest(SamplingRequest):
    """Legacy /v1/completions: a raw text prompt, no chat template."""

    prompt: Union[str, List[str]]
    # null disables; 0 = chosen-token logprobs only; k > 0 adds alternatives
    logprobs: Optional[int] = Field(default=None, ge=0, le=20)
    echo: bool = False

    _default_max_tokens: int = 16

    @field_validator("prompt")
    @classmethod
    def _single_prompt(cls, v):
        if isinstance(v, list):
            if len(v) != 1:
                raise ValueError("batch prompts unsupported; send one prompt")
            if not isinstance(v[0], str):
                raise ValueError("prompt must be a string")
        return v

    def prompt_text(self) -> str:
        return self.prompt[0] if isinstance(self.prompt, list) else self.prompt

    def render_prompt(self, tokenizer) -> str:
        return self.prompt_text()

    @property
    def top_logprobs(self) -> int:
        return self.logprobs or 0

    @property
    def logprobs_enabled(self) -> bool:
        return self.logprobs is not None


class CompletionLogprobs(BaseModel):
    """OpenAI text_completion logprobs shape (not the chat shape)."""

    tokens: List[str] = Field(default_factory=list)
    token_logprobs: List[Optional[float]] = Field(default_factory=list)
    top_logprobs: List[Dict[str, float]] = Field(default_factory=list)
    text_offset: List[int] = Field(default_factory=list)


class CompletionChoice(BaseModel):
    index: int = 0
    text: str = ""
    logprobs: Optional[CompletionLogprobs] = None
    finish_reason: Optional[str] = None


class Usage(BaseModel):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


class RequestMetrics(BaseModel):
    """dnet extension returned when profile=true."""

    total_ms: float = 0.0
    ttfb_ms: float = 0.0
    token_gen_ms: float = 0.0
    tokens_generated: int = 0
    tps_overall: float = 0.0
    tps_decoding: float = 0.0

    @classmethod
    def from_times(cls, total_ms: float, ttfb_ms: float, tokens: int) -> "RequestMetrics":
        gen_ms = max(total_ms - ttfb_ms, 1e-9)
        return cls(
            total_ms=total_ms,
            ttfb_ms=ttfb_ms,
            token_gen_ms=gen_ms,
            tokens_generated=tokens,
            tps_overall=tokens / max(total_ms / 1000, 1e-9),
            tps_decoding=max(tokens - 1, 0) / (gen_ms / 1000),
        )


class CompletionResponse(BaseModel):
    id: str
    object: str = "text_completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[CompletionChoice] = Field(default_factory=list)
    usage: Optional[Usage] = None
    metrics: Optional[RequestMetrics] = None


class TopLogprob(BaseModel):
    token: str
    logprob: float
    bytes: Optional[List[int]] = None


class LogprobEntry(BaseModel):
    token: str
    logprob: float
    bytes: Optional[List[int]] = None
    top_logprobs: List[TopLogprob] = Field(default_factory=list)


class ChoiceLogprobs(BaseModel):
    content: List[LogprobEntry] = Field(default_factory=list)


class ChatChoiceDelta(BaseModel):
    role: Optional[str] = None
    content: Optional[str] = None


class ChatStreamChoice(BaseModel):
    index: int = 0
    delta: ChatChoiceDelta = Field(default_factory=ChatChoiceDelta)
    logprobs: Optional[ChoiceLogprobs] = None
    finish_reason: Optional[str] = None


class ChatCompletionChunk(BaseModel):
    id: str
    object: Literal["chat.completion.chunk"] = "chat.completion.chunk"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[ChatStreamChoice] = Field(default_factory=list)
    usage: Optional[Usage] = None
    metrics: Optional[RequestMetrics] = None


class ChatChoice(BaseModel):
    index: int = 0
    message: ChatMessage
    logprobs: Optional[ChoiceLogprobs] = None
    finish_reason: str = "stop"


class ChatCompletionResponse(BaseModel):
    id: str
    object: Literal["chat.completion"] = "chat.completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[ChatChoice] = Field(default_factory=list)
    usage: Usage = Field(default_factory=Usage)
    metrics: Optional[RequestMetrics] = None


class ModelInfo(BaseModel):
    id: str
    object: Literal["model"] = "model"
    created: int = Field(default_factory=lambda: int(time.time()))
    owned_by: str = "dnet-tpu"


class ModelList(BaseModel):
    object: Literal["list"] = "list"
    data: List[ModelInfo] = Field(default_factory=list)


class LoadModelRequest(BaseModel):
    model: str
    max_seq_len: Optional[int] = None
    # ring mode: reuse the shards' weights and bump only the epoch (the
    # reference's delta reload).  A single process answers 400, a ring 422:
    # the delta path is not ported.
    delta: bool = False


class LoadModelResponse(BaseModel):
    status: str = "ok"
    model: str = ""
    message: str = ""
    load_time_s: float = 0.0


class ManualAssignment(BaseModel):
    instance: str
    layers: List[int]
    window_size: int = 0
    residency_size: int = 0
    mesh_tp: int = 0
    mesh_sp: int = 0


class PrepareTopologyManualRequest(BaseModel):
    model: str
    assignments: List[ManualAssignment]
    kv_bits: int = 0


class HealthResponse(BaseModel):
    status: str = "ok"
    role: str = "api"
    model: Optional[str] = None


def new_request_id() -> str:
    return f"chatcmpl-{uuid.uuid4().hex[:24]}"
