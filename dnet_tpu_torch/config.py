"""Settings the port reads from the environment, under the reference's names.

Counterpart of dnet_tpu/config.py, trimmed to what the batched serving path
reads: `KVSettings` (DNET_KV_PAGED, DNET_KV_RAGGED, DNET_KV_BLOCK_TOKENS,
DNET_KV_POOL_BLOCKS), `ApiSettings` (DNET_API_BATCH_SLOTS,
DNET_API_PREFIX_CACHE) and the scheduler switch DNET_SCHED, which the port
reads only to refuse it.  Values come from the process environment on every
call (no .env file, no cache), so a flip is seen at the next engine load.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional, Type, TypeVar

T = TypeVar("T")

_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off"}


def _parse_bool(raw: str) -> bool:
    low = raw.strip().lower()
    if low in _TRUTHY:
        return True
    if low in _FALSY:
        return False
    raise ValueError(f"not a boolean: {raw!r}")


def _from_env(cls: Type[T], prefix: str) -> T:
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = f"{prefix}{f.name.upper()}"
        raw = os.environ.get(key)
        if raw is None or not raw.strip():
            continue
        try:
            kwargs[f.name] = _parse_bool(raw) if f.type in (bool, "bool") else int(raw)
        except ValueError as exc:
            raise ValueError(f"bad value for {key}: {exc}") from exc
    return cls(**kwargs)


@dataclass
class KVSettings:
    """Paged KV: block-granular allocation with per-sequence page tables over
    a shared pool (`paged`), decoded in place by the ragged kernel
    (`ragged`)."""

    paged: bool = False
    # tokens per KV block (the allocation granule); must divide max_seq
    block_tokens: int = 16
    # total pool capacity in blocks; 0 = the engine's dense equivalent
    # (slots x max_seq / block_tokens)
    pool_blocks: int = 0
    ragged: bool = False


@dataclass
class ApiSettings:
    # >1 = continuous batching over that many slots (core/batch.py)
    batch_slots: int = 1
    # >0 = a prefix cache of that many entries (not ported: refused at load)
    prefix_cache: int = 0


@dataclass
class SchedSettings:
    # the iteration-level scheduler (not ported: refused at load)
    sched: bool = False


def kv_settings() -> KVSettings:
    return _from_env(KVSettings, "DNET_KV_")


def api_settings() -> ApiSettings:
    return _from_env(ApiSettings, "DNET_API_")


def sched_enabled() -> bool:
    return _from_env(SchedSettings, "DNET_").sched


def batch_slots_default(cli_value: Optional[int] = None) -> int:
    """--batch-slots when given, else DNET_API_BATCH_SLOTS (default 1)."""
    return int(cli_value) if cli_value else api_settings().batch_slots
