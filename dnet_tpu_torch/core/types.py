"""Per-request types shared by the API node and the engine.

Counterpart of dnet_tpu/core/types.py (`DecodingParams`, `TokenResult`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class DecodingParams:
    """Per-request sampling knobs."""

    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    # top-p/min-p/top-k may never filter below this many candidates
    min_tokens_to_keep: int = 1
    logprobs: bool = False
    top_logprobs: int = 0
    seed: Optional[int] = None
    # OpenAI logit_bias {token_id: additive bias in [-100, 100]}
    logit_bias: Optional[Dict[int, float]] = None
    # EOS ids the request stops on (sampling itself ignores them)
    stop_token_ids: tuple = ()


@dataclass
class TokenResult:
    """One sampled token handed back to the decode driver."""

    nonce: str
    token_id: int
    logprob: Optional[float] = None
    top_logprobs: Optional[List[tuple]] = None  # [(token_id, logprob), ...]
    step: int = 0
    error: str = ""
