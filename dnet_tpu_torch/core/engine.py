"""Single-process inference engine: prefill + token-by-token decode on one
device with a preallocated KV cache and per-nonce sessions.

Counterpart of dnet_tpu/core/engine.py `LocalEngine` on its default path:
resident weights, dense KV, no speculative decoding, prefix cache, weight
offload or draft model.  PyTorch runs eagerly, so where the reference jits
one program per step, each step here is a sequence of launches on the
current CUDA stream; the fused `lax.scan` decode chunk becomes a Python
loop that feeds each sampled token back on the device, so a chunk needs one
device-to-host read.  Prompts are padded to power-of-two buckets as in the
reference, and never past `max_seq - pos` (the KV write must fit).

In shard mode (`layers=`, `shard_mode=True`) the engine holds one ring
shard's layer range and serves hidden states in and out: `embed_window`
on the head, `run_layers` in the middle, `hidden_tail` / `sample_hidden`
on the tail (shard/compute.py drives them).
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from dnet_tpu_torch.core.sampler import (
    MAX_TOP_LOGPROBS,
    SamplePlan,
    SampleParams,
    SampleResult,
    pack_chunk_results,
    sample,
)
from dnet_tpu_torch.core.types import DecodingParams, TokenResult
from dnet_tpu_torch.models import ModelConfig, get_ring_model_cls
from dnet_tpu_torch.utils.checkpoint import Checkpoint
from dnet_tpu_torch.utils.device import resolve_device
from dnet_tpu_torch.utils.logger import get_logger

log = get_logger()


def bucket_length(n: int, min_bucket: int = 16) -> int:
    b = min_bucket
    while b < n:
        b *= 2
    return b


@dataclass
class Session:
    """Per-nonce decode state."""

    nonce: str = ""
    kv: dict = None  # stacked [L, B, S, KVH, Hd] cache
    pos: int = 0
    generator: torch.Generator = None  # Gumbel noise for sampled requests
    counts: torch.Tensor = None  # [B, V] int32 generated-token counts (repetition penalty)
    last_used: float = field(default_factory=time.time)
    # chunked decode: last sampled token ON DEVICE (chains the next chunk
    # without a host round trip) + dispatched-but-unread chunk queue
    last_token: torch.Tensor = None  # [B, 1] int64
    pending: deque = field(default_factory=deque)


class LocalEngine:
    """One process, one device: the full hot path over resident weights."""

    # chunk widths tried largest-first
    DECODE_CHUNK_BUCKETS = (32, 16, 8, 4, 2)
    batch = 1  # sequences per session
    KV_TTL_S = 600.0  # idle sessions older than this are swept

    def __init__(
        self,
        model_dir: Union[str, Path],
        max_seq: int = 2048,
        param_dtype: str = "bfloat16",
        device: Optional[Union[str, torch.device]] = None,
        layers: Optional[Sequence[int]] = None,
        shard_mode: bool = False,
    ):
        """layers=None is the whole model; a sub-range with shard_mode=True
        makes this engine a ring shard's compute core: it loads only the
        edge weights the range needs (the embedding on the head, the final
        norm and LM head on the tail, the embedding on the tail too when
        it is tied) and serves hidden states in and out."""
        self.device = resolve_device(device)
        self.ckpt = Checkpoint(model_dir)
        self.config = ModelConfig.from_hf(self.ckpt.config)
        self._setup(max_seq, param_dtype, layers)
        t0 = time.perf_counter()
        m = self.model
        self.window_params = [
            self._cast(m.map_layer(self.ckpt.load_layer_raw(a))) for a in m.layers
        ]
        names = None  # every edge tensor
        if shard_mode:
            names = []
            if m.is_first or (m.is_last and self.config.tie_word_embeddings):
                names.append("model.embed_tokens.weight")
            if m.is_last:
                names += ["model.norm.weight", "lm_head.weight"]
        edge = m.map_edge(self.ckpt.load_edge_raw(names))
        self.edge_params = {k: self._cast(v) for k, v in edge.items()}
        log.info(
            "[PROFILE] loaded %d layers (%s) in %.2fs",
            len(m.layers), self.config.model_type, time.perf_counter() - t0,
        )
        self._build_kernels()

    @classmethod
    def from_params(
        cls,
        config: ModelConfig,
        window_params: List[dict],
        edge_params: dict,
        *,
        max_seq: int = 2048,
        param_dtype: str = "bfloat16",
        device: Optional[Union[str, torch.device]] = None,
    ) -> "LocalEngine":
        """An engine around already-materialised parameters (no checkpoint
        on disk): the serving loop is identical, only weight provenance
        differs."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.ckpt = None
        self.config = config
        self._setup(max_seq, param_dtype)
        self.window_params = [self._cast(p) for p in window_params]
        self.edge_params = {k: self._cast(v) for k, v in edge_params.items()}
        self._build_kernels()
        return self

    def _setup(self, max_seq: int, param_dtype: str, layers: Optional[Sequence[int]] = None) -> None:
        self.model = get_ring_model_cls(self.config.model_type)(
            self.config, range(self.config.num_hidden_layers) if layers is None else layers, self.device
        )
        self.max_seq = max_seq
        self.param_dtype_name = param_dtype  # the KV cache's dtype too
        self.param_dtype = getattr(torch, param_dtype)
        self.sessions: Dict[str, Session] = {}

    def _cast(self, params: dict) -> dict:
        return {
            k: v.to(device=self.device, dtype=self.param_dtype if v.is_floating_point() else v.dtype)
            for k, v in params.items()
        }

    def _build_kernels(self) -> None:
        """Build the attention kernels now, not on the first request."""
        if self.device.type == "cuda":
            from dnet_tpu_torch.kernels.build import build_all

            t0 = time.perf_counter()
            build_all()
            log.info("[PROFILE] kernels ready in %.2fs", time.perf_counter() - t0)

    # ---- forward ------------------------------------------------------
    def _forward(self, tokens: torch.Tensor, kv: dict, pos: int, last_idx: int) -> torch.Tensor:
        """Embed + every layer + final norm + LM head at `last_idx`:
        logits [B, V] in the param dtype.  Writes kv in place."""
        m = self.model
        x = m.embed(self.edge_params, tokens)
        x, _ = m.apply_window(self.window_params, x, kv, pos)
        x_last = m.normalize(self.edge_params, x[:, last_idx : last_idx + 1])
        return m.lm_project(self.edge_params, x_last)[:, 0]

    # ---- shard paths (a ring shard's hidden states in and out) ---------
    def run_layers(self, sess: Session, x: torch.Tensor, pos: int) -> torch.Tensor:
        """This engine's layers over hidden x [B, T, D] starting at `pos`;
        writes the session's KV in place."""
        x, _ = self.model.apply_window(self.window_params, x, sess.kv, pos)
        return x

    def embed_window(self, sess: Session, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """Head shard: embed tokens [B, T] and run this engine's layers."""
        return self.run_layers(sess, self.model.embed(self.edge_params, tokens), pos)

    def sample_hidden(
        self, sess: Session, x: torch.Tensor, last_idx: int, decoding: DecodingParams
    ) -> SampleResult:
        """Tail shard: final norm + LM head at `last_idx`, then the sample
        exactly as the single-process step draws it."""
        m = self.model
        x_last = m.normalize(self.edge_params, x[:, last_idx : last_idx + 1])
        logits = m.lm_project(self.edge_params, x_last)[:, 0]
        return self._sample_with_counts(
            sess, logits,
            SampleParams.from_decoding(decoding, self.device), SamplePlan.from_decoding(decoding),
        )

    def hidden_tail(
        self, sess: Session, x: torch.Tensor, pos: int, last_idx: int, decoding: DecodingParams
    ) -> SampleResult:
        """Tail shard: this engine's layers, then sample at `last_idx`."""
        return self.sample_hidden(sess, self.run_layers(sess, x, pos), last_idx, decoding)

    def close(self) -> None:
        """Drop sessions and parameters (a shard reloading frees the old
        engine's device memory first)."""
        self.sessions.clear()
        self.window_params = []
        self.edge_params = {}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- sessions -----------------------------------------------------
    def new_session(self, nonce: str, seed: Optional[int] = None) -> Session:
        if seed is None:
            # fresh entropy per unseeded request: two users must not share a stream
            seed = int.from_bytes(os.urandom(4), "little")
        sess = Session(
            nonce=nonce,
            kv=self.model.init_kv(len(self.model.layers), self.batch, self.max_seq, self.param_dtype_name),
            generator=torch.Generator(device=self.device).manual_seed(int(seed)),
            counts=torch.zeros(
                (self.batch, self.config.vocab_size), dtype=torch.int32, device=self.device
            ),
        )
        self.sessions[nonce] = sess
        return sess

    def end_session(self, nonce: str) -> None:
        self.sessions.pop(nonce, None)

    def sweep_sessions(self) -> int:
        now = time.time()
        dead = [n for n, s in self.sessions.items() if now - s.last_used > self.KV_TTL_S]
        for n in dead:
            self.sessions.pop(n)
        return len(dead)

    # ---- inference ----------------------------------------------------
    def prefill(self, nonce: str, prompt_ids: Sequence[int], seed: Optional[int] = None) -> torch.Tensor:
        """Run the prompt; returns logits [B, V] at the last real position.
        Reusing a live session continues at its pos (chunked prefill)."""
        ids = list(prompt_ids)
        if not ids:
            raise ValueError("empty prompt")
        sess = self.sessions.get(nonce)
        start = 0 if sess is None else sess.pos
        if start + len(ids) > self.max_seq:
            raise ValueError(f"prompt length {start + len(ids)} exceeds max_seq {self.max_seq}")
        t_pf = time.perf_counter()
        if sess is None:
            sess = self.new_session(nonce, seed)
        T = len(ids)
        # the PADDED width must fit too: the KV write may not run past max_seq
        Tpad = min(bucket_length(T), self.max_seq - sess.pos)
        tokens = np.zeros((self.batch, Tpad), dtype=np.int64)
        tokens[:, :T] = np.asarray(ids, dtype=np.int64)
        logits = self._forward(torch.from_numpy(tokens).to(self.device), sess.kv, sess.pos, T - 1)
        # repetition penalty counts GENERATED tokens only (prompt tokens are
        # not seeded), as in the reference
        sess.pos += T
        sess.last_used = time.time()
        log.info("[PROFILE] prefill %d tokens: %.2fms dispatch", T, (time.perf_counter() - t_pf) * 1000)
        return logits

    def _sample_with_counts(
        self, sess: Session, logits: torch.Tensor, sp: SampleParams, plan: SamplePlan
    ) -> SampleResult:
        """THE place owning the sample/counts invariants: every path updates
        the penalty counts the same way."""
        res = sample(logits, sp, sess.generator, token_counts=sess.counts, plan=plan)
        sess.counts.scatter_add_(
            1, res.token[:, None].long(), torch.ones_like(sess.counts[:, :1])
        )
        return res

    def prefill_and_sample(
        self, nonce: str, prompt_ids: Sequence[int], decoding: DecodingParams
    ) -> SampleResult:
        """Prefill the prompt and sample the first token."""
        logits = self.prefill(nonce, prompt_ids, decoding.seed)
        return self._sample_with_counts(
            self.sessions[nonce], logits,
            SampleParams.from_decoding(decoding, self.device), SamplePlan.from_decoding(decoding),
        )

    def decode_step(self, nonce: str, token_id: int, decoding: DecodingParams) -> SampleResult:
        sess = self.sessions[nonce]
        if sess.pos >= self.max_seq:
            raise ValueError(f"sequence length {sess.pos} reached max_seq {self.max_seq}")
        token = torch.full((self.batch, 1), int(token_id), dtype=torch.int64, device=self.device)
        logits = self._forward(token, sess.kv, sess.pos, 0)
        res = self._sample_with_counts(
            sess, logits,
            SampleParams.from_decoding(decoding, self.device), SamplePlan.from_decoding(decoding),
        )
        sess.pos += 1
        sess.last_used = time.time()
        return res

    def decode_chunk_dispatch(
        self,
        nonce: str,
        token_id: Optional[int],
        decoding: DecodingParams,
        max_steps: int,
    ) -> int:
        """Enqueue a chunk of up to `max_steps` decode steps on the device.

        token_id None chains from the device-resident last token of the
        previous chunk, so the host never reads a token to keep the device
        busy.  Returns the dispatched width (0 = not chunkable; the caller
        falls back to decode_step).  decode_chunk_read reads chunks in
        dispatch order."""
        sess = self.sessions[nonce]
        if sess.pos >= self.max_seq:
            # not an error here: the caller may be speculating past a chunk
            # that exactly filled the sequence; decode_step raises for real
            return 0
        budget = min(max_steps, self.max_seq - sess.pos)
        K = next((b for b in self.DECODE_CHUNK_BUCKETS if b <= budget), 1)
        if K == 1:
            return 0
        if token_id is None:
            if sess.last_token is None:
                raise RuntimeError("no device-resident token to chain from")
            token = sess.last_token
        else:
            token = torch.full((self.batch, 1), int(token_id), dtype=torch.int64, device=self.device)
        sp = SampleParams.from_decoding(decoding, self.device)
        plan = SamplePlan.from_decoding(decoding)
        results = []
        for i in range(K):
            logits = self._forward(token, sess.kv, sess.pos + i, 0)
            res = self._sample_with_counts(sess, logits, sp, plan)
            token = res.token[:, None].long()
            results.append(res)
        sess.pending.append((K, pack_chunk_results(results, plan.logprobs), plan))
        sess.last_token = token
        sess.pos += K
        sess.last_used = time.time()
        return K

    def pending_chunks(self, nonce: str) -> int:
        """Dispatched-but-unread chunk count (0 for unknown sessions)."""
        sess = self.sessions.get(nonce)
        return len(sess.pending) if sess is not None else 0

    def pending_width(self, nonce: str) -> int:
        """Total tokens in flight across dispatched-but-unread chunks."""
        sess = self.sessions.get(nonce)
        return sum(k for k, _, _ in sess.pending) if sess is not None else 0

    def decode_chunk_read(self, nonce: str) -> List[SampleResult]:
        """Read the oldest dispatched chunk: ONE device-to-host copy of the
        packed [K, B, W] block, split on the host."""
        sess = self.sessions[nonce]
        K, packed, plan = sess.pending.popleft()
        arr = packed.cpu().numpy()  # waits for the chunk's launches
        toks = arr[..., 0].astype(np.int32)  # [K, B]
        if plan.logprobs:
            M = MAX_TOP_LOGPROBS
            lps = arr[..., 1]
            tt = arr[..., 2 : 2 + M].astype(np.int32)
            tlp = arr[..., 2 + M : 2 + 2 * M]
        else:
            B = arr.shape[1]
            lps = np.zeros((K, B), np.float32)
            tt = np.zeros((K, B, MAX_TOP_LOGPROBS), np.int32)
            tlp = np.zeros((K, B, MAX_TOP_LOGPROBS), np.float32)
        return [SampleResult(toks[i], lps[i], tt[i], tlp[i]) for i in range(K)]

    def decode_chunk(
        self, nonce: str, token_id: int, decoding: DecodingParams, max_steps: int
    ) -> List[SampleResult]:
        """Up to `max_steps` decode steps (dispatch + read in one call); one
        host-side SampleResult per generated token.  The caller owns EOS /
        stop checks and discards any overshoot with the session."""
        if self.decode_chunk_dispatch(nonce, token_id, decoding, max_steps) == 0:
            return [self.decode_step(nonce, token_id, decoding)]
        return self.decode_chunk_read(nonce)

    def generate(
        self,
        prompt_ids: Sequence[int],
        decoding: Optional[DecodingParams] = None,
        max_tokens: int = 256,
        eos_token_ids: Optional[set] = None,
        nonce: str = "local",
    ):
        """Autoregressive generation, yielding per-token TokenResults."""
        decoding = decoding or DecodingParams()
        eos = eos_token_ids or set()
        self.end_session(nonce)
        res = self.prefill_and_sample(nonce, prompt_ids, decoding)
        sess = self.sessions[nonce]
        token = int(res.token[0])
        yield self.token_result(nonce, res, step=0, decoding=decoding)
        step = 1
        while step < max_tokens and token not in eos and sess.pos < self.max_seq:
            res = self.decode_step(nonce, token, decoding)
            token = int(res.token[0])
            yield self.token_result(nonce, res, step=step, decoding=decoding)
            step += 1
        self.end_session(nonce)

    @staticmethod
    def token_result(nonce: str, res: SampleResult, step: int, decoding: DecodingParams) -> TokenResult:
        top = None
        if decoding.logprobs and decoding.top_logprobs > 0:
            n = min(decoding.top_logprobs, res.top_tokens.shape[-1])
            top = list(
                zip(
                    _host(res.top_tokens)[0, :n].tolist(),
                    _host(res.top_logprobs)[0, :n].tolist(),
                )
            )
        return TokenResult(
            nonce=nonce,
            token_id=int(res.token[0]),
            logprob=float(res.logprob[0]) if decoding.logprobs else None,
            top_logprobs=top,
            step=step,
        )


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
