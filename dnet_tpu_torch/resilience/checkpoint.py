"""The resumable-request state machine behind DNET_RESILIENCE_RESUME.

Counterpart of dnet_tpu/resilience/checkpoint.py.  `InferenceManager._run`
drives every decode step through a `ResumableDecode`: the controller owns
the wire nonce, the step mapping, and the request checkpoint (prompt ids +
every token generated so far — the detokenizer / stop-sequence holdback /
logprob buffers live on in the decode loop's generator frame and need no
restore).  When a step fails because a shard died, the controller — inside
the configured budget —

1. waits for the failure monitor to report the ring healthy again
   (``DNET_RESILIENCE_RESUME_DEADLINE_S`` per attempt; auto-recovery
   re-solves the topology underneath while we wait),
2. resets the dead nonce's per-shard state (best effort — the ring that
   just died may not ACK),
3. replays a prefill of ``prompt + generated`` under a FRESH wire nonce
   (``rid#rN``) through `send_tokens(step=0)`: one prefill pass over the
   whole replay (the prefill kernel on each shard, or the local engine's
   prefill), which rebuilds the KV cache of every token so far, and
4. hands the replay's sampled token back to the decode loop as the failed
   step's result: the client stream continues with the same rid, correct
   finish_reason, and usage that counts each token exactly once.

The resume cap is ``DNET_RESILIENCE_MAX_RESUMES`` per request; with resume
disabled `try_resume` returns None immediately and behavior is identical
to the fast-fail path.  A fault-free request pays one list append a token
and no device work.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from dnet_tpu_torch.obs import get_recorder, metric
from dnet_tpu_torch.obs.events import log_event
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()

_RESUMED = metric("dnet_request_resumed_total")
_REPLAY_TOKENS = metric("dnet_resume_replay_tokens_total")


@dataclass
class RequestCheckpoint:
    """Everything a replay prefill needs: the prompt and the accepted
    tokens, plus resume bookkeeping."""

    rid: str
    prompt_ids: List[int]
    generated_ids: List[int] = field(default_factory=list)
    resumes: int = 0
    segment: int = 0   # resume generation; names the wire nonce
    step_base: int = 0  # decode step that maps to the current nonce's step 0

    def record(self, token_id: int) -> None:
        self.generated_ids.append(int(token_id))

    def replay_ids(self) -> List[int]:
        return list(self.prompt_ids) + list(self.generated_ids)

    def next_nonce(self) -> str:
        self.segment += 1
        return f"{self.rid}#r{self.segment}"


class ResumableDecode:
    """Per-request send/await facade with transparent resume.

    `get_adapter` is a callable, not a reference: auto-recovery replaces
    `InferenceManager.adapter` with one wired to the re-solved topology,
    and the replay must go to the NEW adapter.
    """

    POLL_S = 0.1  # recovery-wait poll cadence

    def __init__(
        self,
        get_adapter: Callable[[], object],
        rid: str,
        prompt_ids: List[int],
        *,
        monitor=None,
        timeout_s: float = 300.0,
        settings=None,
    ) -> None:
        if settings is None:
            from dnet_tpu_torch.config import resilience_settings

            settings = resilience_settings()
        self.enabled = bool(settings.resume)
        self.deadline_s = float(settings.resume_deadline_s)
        self.max_resumes = max(int(settings.max_resumes), 0)
        self._get_adapter = get_adapter
        self.monitor = monitor
        self.timeout_s = timeout_s
        self.ckpt = RequestCheckpoint(rid=rid, prompt_ids=list(prompt_ids))
        self.nonce = rid

    @property
    def adapter(self):
        return self._get_adapter()

    # ---- the decode loop's per-step surface -----------------------------------
    async def send(self, send_ids, decoding, step: int, budget=None) -> None:
        await self.adapter.send_tokens(
            self.nonce, list(send_ids), decoding,
            step - self.ckpt.step_base, budget=budget,
        )

    async def await_token(self, step: int):
        return await self.adapter.await_token(
            self.nonce, step - self.ckpt.step_base, self.timeout_s
        )

    def record(self, token_id: int) -> None:
        self.ckpt.record(token_id)

    # ---- resume ----------------------------------------------------------
    async def try_resume(self, exc, decoding, step: int, budget=None):
        """Attempt to produce step's token by replaying on a recovered
        ring.  Returns the TokenResult, or None when resume is disabled /
        exhausted / the ring never recovered (caller re-raises `exc`)."""
        if not self.enabled:
            return None
        while self.ckpt.resumes < self.max_resumes:
            self.ckpt.resumes += 1
            log.warning(
                "request %s: decode step %d failed (%s); resume attempt "
                "%d/%d", self.ckpt.rid, step, exc, self.ckpt.resumes,
                self.max_resumes,
            )
            if not await self._wait_recovered():
                log.error(
                    "request %s: ring still degraded after %.1fs; giving up",
                    self.ckpt.rid, self.deadline_s,
                )
                return None
            # best-effort reset of the dead segment: the shards that died
            # may be gone, and the replay uses a fresh nonce regardless
            try:
                await self.adapter.reset_cache(self.nonce)
            except Exception as reset_exc:
                log.warning(
                    "reset of dead nonce %s failed (ignored): %s",
                    self.nonce, reset_exc,
                )
            self.nonce = self.ckpt.next_nonce()
            self.ckpt.step_base = step
            ids = self.ckpt.replay_ids()
            try:
                await self.adapter.send_tokens(
                    self.nonce, ids, decoding, 0, budget=budget
                )
                result = await self.adapter.await_token(
                    self.nonce, 0, self.timeout_s
                )
            except asyncio.CancelledError:
                raise
            except Exception as replay_exc:
                log.warning(
                    "request %s: resume replay failed: %s",
                    self.ckpt.rid, replay_exc,
                )
                continue
            if result.error:
                log.warning(
                    "request %s: resume replay errored: %s",
                    self.ckpt.rid, result.error,
                )
                continue
            _RESUMED.inc()
            _REPLAY_TOKENS.inc(len(ids))
            log_event(
                "resumed", rid=self.ckpt.rid, step=step,
                replay_tokens=len(ids), nonce=self.nonce,
            )
            get_recorder().span(
                self.ckpt.rid, "request_resumed", 0.0, step=step,
                replay_tokens=len(ids), force=True,
            )
            log.info(
                "request %s resumed at step %d (replayed %d tokens as %s)",
                self.ckpt.rid, step, len(ids), self.nonce,
            )
            return result
        return None

    async def _wait_recovered(self) -> bool:
        """Block (bounded) until the failure monitor stops reporting the
        ring degraded.  No monitor => nothing to wait on."""
        if self.monitor is None:
            return True
        deadline = time.monotonic() + self.deadline_s
        while self.monitor.degraded:
            if time.monotonic() >= deadline:
                return False
            await asyncio.sleep(self.POLL_S)
        return True

    async def cleanup(self) -> None:
        """Drop the current nonce's per-shard state, swallowing transport
        errors: the cleanup path runs in the decode loop's `finally`, where a
        raise would mask the original error and crash the SSE generator."""
        try:
            await self.adapter.reset_cache(self.nonce)
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            log.warning(
                "reset_cache for %s failed on cleanup (ignored): %s",
                self.nonce, exc,
            )
