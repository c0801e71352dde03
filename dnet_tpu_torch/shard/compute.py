"""Shard compute core: one ActivationMessage in, one out.

Counterpart of dnet_tpu/shard/compute.py `ShardCompute` over a
`LocalEngine` in shard mode: embed + window on the head, window on a middle
shard, window + head + sample on the tail.  Incoming frames are padded to
the engine's power-of-two prefill buckets.  Hidden hops leave through one
encode seam, `_encode_activation`: the lossless cast to the wire dtype, or
the qsparse8/sparse_v1 codec, whose column norms, gather and (on the
receiving shard) dequant + scatter run in the CUDA kernels of
compression/ops.py.  The chaos points `wire_encode` and `wire_decode` sit
at the encode and decode seams, as at the reference's.

Under the overlapped wire pipeline (DNET_WIRE_PIPELINE=1, transport/
wire_pipeline.py) a decode-step hop (at most `lanes` rows) is only launched
here and finalized on the adapter's tx thread, through a ring of `depth`
encode slots and page-locked staging buffers warmed at load; a prompt
frame encodes synchronously.  The adapter predecodes a queued hidden frame
at ingress (`will_predecode`, `predecode`) while the compute queue is
shallower than `depth`.

Batched lanes (`lanes` > 1, DNET_API_RING_LANES): the shard keeps a lane
pool (shard/lanes.py) and serves a coalesced frame's members with one
batched step; a tail answers with one final a member, a faulted member
failing alone.

Ring speculation (`spec_lookahead` L, DNET_API_SPEC_LOOKAHEAD): the head
widens a granted continuation into a [tok, d_1..d_L] verify block of
prompt-lookup drafts, and the tail runs it as one (L+1)-row forward and
emits the agreeing prefix plus the first correction, 1..L+1 tokens a lap
(`extra_finals`), handing the accepted tokens back to the head's history
(`committed`).  The ring prefix cache (`prefix_cache`,
DNET_API_PREFIX_CACHE): the API keys each prompt frame; a shard stores
its window's KV after the prompt under `prefix_store` and seeds a new
session from the snapshot under `prefix_hit`, or fails the frame with a
parseable `prefix-miss:<key>` error.  A non-contiguous range is a k-round
schedule: each contiguous run is one visit of the activation a token
(`_process_round`, core/engine.py `apply_round`), and only the round
ending at the model's last layer samples.  Both features need one round
and resident weights, speculation a cache that can rewind; otherwise the
shard serves without them, as the reference's does.

This slice serves every family the port registers (gpt_oss's range in its
paired layout, or the flat one where its kinds do not pair; deepseek_v2's
range as its dense and moe segments); the shard's KV cache takes the
topology's kv_bits (bf16, int8 or packed int4, as core/kvcache.py
`resolve_kv_bits` maps it).  The topology's `window_size` /
`residency_size` give the shard's weight plan (core/weights.py): under
offload or sliding_fit its layers stream from host memory (the repack
cache under `repack_dir`), the head shard running embed + the streamed
layers and the tail the streamed layers + norm + head + sample, as the
reference's streaming branch does.  Every option that would ask for more
is refused at load (`ShardCapabilityError`), before a weight is read,
rather than quietly served as something else: a mesh-backed shard,
tensor parallelism, lanes on a k-round range, and a k-round range of
resident layers that are not one flat stack (gpt_oss's paired layout,
deepseek_v2's segments, a mixed qwen3_moe), which the reference refuses
on the first frame instead.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from dnet_tpu_torch.compression import (
    EncodeStaging,
    compress_tensor,
    decompress_tensor_device,
    is_compressed_dtype,
    launch_encode,
)
from dnet_tpu_torch.config import tp_settings, transport_settings, wire_settings
from dnet_tpu_torch.core.engine import LocalEngine, bucket_length, round_refusal
from dnet_tpu_torch.core.kvcache import resolve_kv_bits
from dnet_tpu_torch.core.spec import ngram_draft_np
from dnet_tpu_torch.core.types import ActivationMessage, DecodingParams
from dnet_tpu_torch.core.weights import plan_policy
from dnet_tpu_torch.models import MODEL_TYPES
from dnet_tpu_torch.resilience import chaos
from dnet_tpu_torch.transport.wire_pipeline import (
    EncodeRing,
    PendingWirePayload,
    observe_decode,
    observe_encode,
    overlap,
    wire_pipeline_enabled,
)
from dnet_tpu_torch.utils.logger import get_logger
from dnet_tpu_torch.utils.serialization import bytes_to_device, tensor_to_bytes

log = get_logger()


def _rows(shape) -> int:
    """Rows of a [..., D] hidden frame (1 for a decode step's hop)."""
    return int(np.prod(shape[:-1])) if len(shape) > 1 else 1


class ShardCapabilityError(ValueError):
    """A load option this shard does not serve."""


def refuse_model(
    model_dir: Union[str, Path],
    layers: Optional[Sequence[int]] = None,
    *,
    lanes: int = 0,
    window_size: int = 0,
    residency_size: int = 0,
    **_other,
) -> None:
    """Raise ShardCapabilityError for a checkpoint whose family this shard
    does not serve; for a k-round (non-contiguous) range whose resident
    layers are not one flat stack (gpt_oss's paired layout, deepseek_v2's
    segments, a mixed qwen3_moe: the reference's apply_round refuses them
    on the first frame, this shard at load); or (lanes > 1) a range batched
    lanes cannot serve: a k-round range, a streamed plan (window_size /
    residency_size short of the range) or a model without the lane hook
    (`supports_kv_commit` false: gpt_oss's flat layout).  Read from its
    config.json before any weight."""
    cfg_path = Path(model_dir) / "config.json"
    if not cfg_path.is_file():
        raise FileNotFoundError(f"no config.json in {model_dir}")
    raw = json.loads(cfg_path.read_text())
    model_type = raw.get("model_type")
    if model_type not in MODEL_TYPES:  # a shard serves every registered family
        raise ShardCapabilityError(
            f"this shard does not serve model_type {model_type!r} (ring shards serve {MODEL_TYPES})"
        )
    if layers is None:
        return
    ls = sorted(int(a) for a in layers)
    k_round = len(contiguous_runs(ls)) > 1
    streamed = plan_policy(len(ls), window_size, residency_size).name != "fit"
    if lanes > 1 and k_round:
        raise ShardCapabilityError(
            f"this shard does not serve lanes={lanes} (DNET_API_RING_LANES) on k-round layers {ls}: batched lanes "
            "need a single-round (contiguous) assignment; k-round schedules serve batch=1"
        )
    if lanes > 1 and streamed:
        raise ShardCapabilityError(
            f"this shard does not serve lanes={lanes} (DNET_API_RING_LANES) on a streamed plan "
            f"(window_size={window_size}, residency_size={residency_size}): batched lanes need resident weights"
        )
    if lanes <= 1 and not k_round:
        return
    from dnet_tpu_torch.models import ModelConfig, get_ring_model_cls

    model = get_ring_model_cls(model_type)(ModelConfig.from_hf(raw), ls, "cpu")
    why = round_refusal(model, streamed) if k_round else None
    if why is not None:
        raise ShardCapabilityError(
            f"this shard does not serve k-round layers {ls} ({len(contiguous_runs(ls))} rounds) with resident "
            f"weights for {model_type}: multi-round rings need a flat layer stack, not {why}"
        )
    if lanes > 1 and not model.supports_kv_commit:
        raise ShardCapabilityError(
            f"this shard does not serve lanes={lanes} (DNET_API_RING_LANES) for {model_type} layers "
            f"{ls}: no gated KV writes (gpt_oss's flat layout)"
        )


def contiguous_runs(layers: Sequence[int]) -> list:
    """A sorted layer list as its contiguous runs: a k-round assignment's
    rounds, each one visit of the activation a token."""
    runs: list = []
    for a in layers:
        if runs and a == runs[-1][-1] + 1:
            runs[-1].append(a)
        else:
            runs.append([a])
    return runs


def refuse_unsupported(
    layers: Sequence[int],
    *,
    kv_bits: int = 0,
    weight_quant_bits: int = 0,
    mesh_tp: int = 0,
    mesh_sp: int = 0,
    tp_degree: int = 0,
    **_other,
) -> None:
    """Raise ShardCapabilityError for the first load option outside this
    slice, naming the setting it comes from: a mesh-backed shard
    (DNET_SHARD_MESH_TP / _SP), tensor parallelism (DNET_TP: a tp_degree of
    0 takes this shard's own, as the reference's shard resolves it when
    the mesh is one device), a kv_bits that is none of 0/16/8/4 and a
    weight_quant_bits that is none of 0/8/4.  Other keyword arguments are
    ignored, so a caller can pass its whole load body."""
    if tp_degree == 0 and max(mesh_tp, 1) * max(mesh_sp, 1) == 1:
        tp_degree = tp_settings().tp
    if not list(layers):
        raise ShardCapabilityError("empty layer list")
    refused = [
        (mesh_tp not in (0, 1), f"mesh_tp={mesh_tp} (DNET_SHARD_MESH_TP): mesh-backed shards are not ported"),
        (mesh_sp not in (0, 1), f"mesh_sp={mesh_sp} (DNET_SHARD_MESH_SP): mesh-backed shards are not ported"),
        (tp_degree > 1, f"tp_degree={tp_degree} (DNET_TP): tensor parallelism is not ported"),
        (kv_bits not in (0, 4, 8, 16), f"kv_bits={kv_bits} (supported: 0/4/8/16)"),
        (weight_quant_bits not in (0, 4, 8), f"weight_quant_bits={weight_quant_bits} (supported: 0/4/8)"),
    ]
    for cond, why in refused:
        if cond:
            raise ShardCapabilityError(f"this shard does not serve {why}")


class ShardCompute:
    """Owns the engine for this shard's layer range."""

    def __init__(
        self,
        model_dir: Union[str, Path],
        layers: Sequence[int],
        max_seq: int = 4096,
        param_dtype: str = "bfloat16",
        wire_dtype: str = "bfloat16",
        kv_ttl_s: float = 600.0,
        window_size: int = 0,
        residency_size: int = 0,
        repack_dir: Optional[str] = None,
        kv_bits: int = 0,
        compress_frac: Optional[float] = None,
        weight_quant_bits: int = 0,
        mesh_tp: int = 0,
        mesh_sp: int = 0,
        tp_degree: int = 0,
        spec_lookahead: int = 0,
        lanes: int = 0,
        prefix_cache: int = 0,
        wire_codec: str = "",
        wire_pipeline: Optional[bool] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        w = wire_settings()
        refuse_unsupported(
            layers, kv_bits=kv_bits,
            weight_quant_bits=weight_quant_bits, mesh_tp=mesh_tp, mesh_sp=mesh_sp,
            tp_degree=tp_degree,
        )
        refuse_model(model_dir, layers, lanes=lanes, window_size=window_size, residency_size=residency_size)
        # the API resolves "auto" per hop in its load fan-out; a shard loaded
        # without a codec keeps the lossless default
        if not wire_codec:
            wire_codec = "lossless" if w.codec == "auto" else w.codec
        if wire_codec not in ("lossless", "qsparse8"):
            raise ValueError(f"unknown wire codec {wire_codec!r} (lossless | qsparse8)")
        kv_dtype, kv_quant_bits = resolve_kv_bits(kv_bits)
        # weight_quant_bits 8 / 4: this range's layers and, on the tail, the
        # LM projection quantized at the bits' default group, as the
        # reference's shard does (its load body carries no group)
        self.engine = LocalEngine(
            model_dir, max_seq=max_seq, param_dtype=param_dtype, device=device,
            layers=layers, shard_mode=True, kv_dtype=kv_dtype, kv_quant_bits=kv_quant_bits,
            weight_quant_bits=weight_quant_bits, window_size=window_size, residency_size=residency_size,
            repack_dir=repack_dir,
        )
        self.engine.KV_TTL_S = kv_ttl_s
        self.layers = list(self.engine.model.layers)
        self.is_first = self.engine.model.is_first
        self.is_last = self.engine.model.is_last
        # the k-round schedule: a non-contiguous range is its rounds, each
        # contiguous run one visit of the activation a token
        self.rounds = contiguous_runs(self.layers)
        streams = self.engine.plan.streams_weights
        # ring speculation: the head widens a granted continuation into a
        # [tok, d_1..d_L] verify block (prompt lookup over the host-side
        # history `_hist`), the tail verifies it and emits 1..L+1 tokens a
        # lap.  One round, resident weights and a cache that can rewind.
        self.spec_lookahead = int(spec_lookahead)
        self._spec_ok = (self.spec_lookahead > 0 and len(self.rounds) == 1 and not streams
                         and self.engine.model.kv_rewindable(self.engine.max_seq))
        self._hist: dict = {}  # head: nonce -> int64 [max_seq] input history
        # verify blocks widened (head) and verified (tail), and the tokens
        # the tail emitted from them, for /health
        self.spec_stats = {"widened": 0, "blocks": 0, "emitted": 0}
        # the ring prefix cache: this window's KV snapshots under the keys
        # the API sends in the prompt frames (one round, resident weights)
        self.prefix_snaps = None
        if prefix_cache > 0 and len(self.rounds) == 1 and not streams:
            from dnet_tpu_torch.core.prefix_cache import SnapshotStore

            self.prefix_snaps = SnapshotStore(prefix_cache)
        self.wire_dtype = wire_dtype
        self.wire_codec = wire_codec
        # column-sparsify hidden hops (DNET_TRANSPORT_COMPRESS*): an explicit
        # argument wins, the environment is the deployment default
        t = transport_settings()
        if compress_frac is None:
            compress_frac = t.compress_pct if t.compress else 0.0
        self.compress_frac = compress_frac
        self.compress_quant_bits = t.compress_quant_bits
        self._wire_pct = w.qsparse_pct
        self._wire_gs = w.group_size
        # hop accounting, read by /health: hidden frames encoded (sent) and
        # decoded (received), their payload bytes, the last decode-step
        # hop's bytes, and the host time of the encode and the decode on
        # the compute thread (under the pipeline: the launch, and a decode
        # not done at ingress), summed apart for decode-step hops (at most
        # `lanes` rows) and prompt frames; under the pipeline also the
        # frames decoded at ingress and their time there, and the encodes
        # run to warm the codec at load (their kernel launches included in
        # /health's counts).  Updated from the compute thread and, at
        # ingress, the event loop.
        self.wire_stats = {
            "frames_encoded": 0, "bytes_encoded": 0, "frames_decoded": 0,
            "bytes_decoded": 0, "decode_hop_bytes": 0, "hop_encode_ms": 0.0,
            "prompt_encode_ms": 0.0, "hop_decode_ms": 0.0, "prompt_decode_ms": 0.0,
            "frames_predecoded": 0, "predecode_ms": 0.0, "warm_encodes": 0,
        }
        self._stats_lock = threading.Lock()
        # the overlapped wire pipeline: `depth` encodes in flight at most,
        # each encode-ring slot with its own page-locked buffers; ingress
        # decodes ahead while the compute queue is shallower than `depth`
        self.wire_pipeline = wire_pipeline_enabled() if wire_pipeline is None else bool(wire_pipeline)
        self._encode_ring = EncodeRing(w.depth) if self.wire_pipeline else None
        self._staging = EncodeStaging(w.depth) if self.wire_pipeline else None
        self._rx_depth = max(int(w.depth), 1)
        # batched lanes: a pool of `lanes` rows serves coalesced frames
        self.lane_pool = None
        if lanes > 1:
            from dnet_tpu_torch.shard.lanes import LanePool

            self.lane_pool = LanePool(self.engine, lanes)
        # the pipelined encode takes decode-step hops: one row, a lane
        # frame's members, or a verify block's 1 + L rows; a prompt frame
        # encodes synchronously
        self._wire_jit_rows = max(int(lanes), 1 + self.spec_lookahead if self._spec_ok else 1, 1)
        if self.wire_pipeline:
            self._warm_wire()

    def _book(self, **deltas) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self.wire_stats[k] += v

    def _warm_wire(self) -> None:
        """Run the pipelined encode once for each row count it takes (and
        the decode of its payload), at load: the codec's kernels run and
        the staging buffers are allocated before the first frame, not on
        the serving path."""
        frac, qbits = self._wire_params()
        eng = self.engine
        t0 = time.perf_counter()
        for rows in range(1, self._wire_jit_rows + 1):
            x = torch.zeros((rows, 1, eng.config.hidden_size), dtype=eng.param_dtype, device=eng.device)
            # slot 0's buffers: no encode is in flight at load
            enc = launch_encode(x, frac, wire_dtype=self.wire_dtype, quant_bits=qbits, group_size=self._wire_gs,
                                staging=self._staging, slot=0)
            payload = enc.finalize()
            if is_compressed_dtype(enc.dtype):
                decompress_tensor_device(payload, enc.dtype, enc.shape, eng.device)
        self._book(warm_encodes=self._wire_jit_rows)
        log.info("wire encode warmed for %d frame shapes (codec=%s) in %.2fs", self._wire_jit_rows,
                 self.wire_codec if (frac or qbits) else "lossless", time.perf_counter() - t0)

    @property
    def max_layer(self) -> int:
        return max(self.layers)

    def wants(self, layer_id: int) -> bool:
        """Is the layer after `layer_id` ours?  (layer_id -1 = raw tokens.)"""
        return (layer_id + 1) in self.engine.model.abs_to_local

    def reset(self, nonce: str = "") -> None:
        """Drop one nonce's session (and draft history, and lane), or with
        no nonce every session and every prefix snapshot."""
        if nonce:
            self.engine.end_session(nonce)
            self._hist.pop(nonce, None)
            if self.lane_pool is not None:
                self.lane_pool.release(nonce)
        else:
            self.engine.sessions.clear()
            self._hist.clear()
            if self.lane_pool is not None:
                self.lane_pool.reset()
            if self.prefix_snaps is not None:
                self.prefix_snaps.clear()

    # ---- ingress decode ------------------------------------------------
    def _payload_to_device(self, msg: ActivationMessage) -> torch.Tensor:
        """Hidden payload -> a tensor on the engine's device: the one the
        pipeline decoded at ingress, or decoded here (the compute thread's
        chaos point first)."""
        if msg.device_data is not None:
            return msg.device_data
        chaos.inject("wire_decode")
        return self._decode_to_device(msg, hidden=False)

    def _decode_to_device(self, msg: ActivationMessage, hidden: bool) -> torch.Tensor:
        """The one receive body: the payload's buffers uploaded through
        page-locked memory; a compressed frame uploads only its compact
        buffers and is rebuilt by the dequant + scatter kernel.  `hidden`:
        run at ingress, overlapped with the step the compute thread is
        launching."""
        eng = self.engine
        t0 = time.perf_counter()
        if is_compressed_dtype(msg.dtype):
            out = decompress_tensor_device(msg.data, msg.dtype, msg.shape, eng.device)
        else:
            out = bytes_to_device(msg.data, msg.dtype, msg.shape, eng.device)
        ms = (time.perf_counter() - t0) * 1e3
        observe_decode(ms, hidden=hidden)
        hop = _rows(msg.shape) <= self._wire_jit_rows
        self._book(frames_decoded=1, bytes_decoded=len(msg.data),
                   **({"frames_predecoded": 1, "predecode_ms": ms} if hidden
                      else {"hop_decode_ms" if hop else "prompt_decode_ms": ms}))
        return out

    def will_predecode(self, msg: ActivationMessage, backlog: int) -> bool:
        """Decode this frame at ingress?  Only under the pipeline, for a
        hidden payload, and while the compute queue holds fewer than
        `depth` frames: each decoded frame holds a whole activation on the
        card, so a backlog keeps its compact bytes until the compute thread
        reaches it."""
        return (self.wire_pipeline and not msg.is_tokens and not msg.is_final and bool(msg.data)
                and msg.device_data is None and backlog < self._rx_depth)

    def predecode(self, msg: ActivationMessage) -> None:
        """The pipeline's receive half (event loop, after will_predecode and
        the caller's `wire_decode` chaos point): queue the frame's upload
        and dequant + scatter on the card now, behind the step being
        launched, before the frame joins the compute queue."""
        msg.device_data = self._decode_to_device(msg, hidden=True)

    def _padded_len(self, msg: ActivationMessage, T: int, pos: int) -> int:
        """A prompt frame's rows padded to the power-of-two bucket (never
        past max_seq); a decode step and a verify block (as the single
        process runs its L + 1 rows) unpadded."""
        eng = self.engine
        if pos + T > eng.max_seq:
            raise ValueError(f"sequence {pos + T} exceeds max_seq {eng.max_seq}")
        return T if T == 1 or msg.drafts else min(bucket_length(T), eng.max_seq - pos)

    def _decode_payload(self, msg: ActivationMessage, pos: int):
        """Incoming hidden frame -> (padded [B, Tpad, D] in the param
        dtype, real length T)."""
        hidden = self._payload_to_device(msg)
        T = hidden.shape[1]
        Tpad = self._padded_len(msg, T, pos)
        if Tpad != T:
            hidden = F.pad(hidden, (0, 0, 0, Tpad - T))
        return hidden.to(self.engine.param_dtype), T

    def _embed_tokens(self, msg: ActivationMessage, pos: int):
        eng = self.engine
        ids = msg.tokens()
        T = ids.shape[-1]
        Tpad = self._padded_len(msg, T, pos)
        tokens = np.zeros((eng.batch, Tpad), dtype=np.int64)
        tokens[:, :T] = ids.reshape(1, -1)
        return torch.from_numpy(tokens).to(eng.device), T

    # ---- compute -------------------------------------------------------
    def process(self, msg: ActivationMessage) -> ActivationMessage:
        """Run this shard's window (or the round the frame enters); returns
        the outgoing message (a hidden hop or the final sampled token).
        The reference's order: lanes, then the session (seeded from a
        prefix snapshot on a hit), the head's widen, the tail's verify, the
        round path, the single-round path."""
        if msg.lanes:
            return self._process_lane_frame(msg)
        eng = self.engine
        nonce, pos = msg.nonce, msg.pos
        sess = eng.sessions.get(nonce)
        if sess is None:
            if msg.prefix_hit:
                # a prompt frame continuing a cached prefix: pos is the
                # prefix length, the payload the suffix only
                sess = self._seed_prefix_session(msg)
            elif pos > 0:
                # a mid-stream frame with no session is stale (a grant still
                # circulating after a reset, or a swept request): recreating
                # the session would compute garbage
                raise ValueError(f"no session for {nonce!r} at pos {pos} (reset or expired); dropping frame")
            else:
                sess = eng.new_session(nonce, msg.decoding.seed)
        if msg.is_tokens and self.is_first and self._spec_ok:
            msg = self._spec_widen(msg)
        if msg.drafts and self.is_last:
            if not self._spec_ok:
                raise ValueError("verify block arrived but this shard cannot speculate "
                                 "(k rounds, streaming weights, or a rotating cache)")
            return self._spec_verify(msg, sess)
        if len(self.rounds) > 1:
            return self._process_round(msg, sess)
        if msg.is_tokens:
            if not self.is_first:
                raise ValueError("token frame arrived at a non-first shard")
            tokens, T = self._embed_tokens(msg, pos)
            x = eng.embed_window(sess, tokens, pos, t_real=T)
        else:
            x, T = self._decode_payload(msg, pos)
            x = eng.run_layers(sess, x, pos, t_real=T)
        sess.pos = pos + T
        sess.last_used = time.time()
        if msg.prefix_store and self.prefix_snaps is not None:
            self.prefix_snaps.put(msg.prefix_store, sess.pos, sess.kv)
        return self._emit(msg, sess, x, T, self.is_last, self.max_layer)

    def _process_round(self, msg: ActivationMessage, sess) -> ActivationMessage:
        """The k-round path: only the round that starts at the frame's next
        layer, the next round's first window prefetched while the rest of
        the ring computes.  Only the round that ends at the model's last
        layer samples; every other round hands its hidden state on."""
        eng = self.engine
        pos = msg.pos
        target = 0 if msg.is_tokens else msg.layer_id + 1
        ridx = next((i for i, r in enumerate(self.rounds) if r[0] == target), None)
        if ridx is None:
            raise ValueError(f"no round of {self.rounds} starts at layer {target}")
        run = self.rounds[ridx]
        if msg.is_tokens:
            tokens, T = self._embed_tokens(msg, pos)
            x = eng.model.embed(eng.edge_params, tokens)
        else:
            x, T = self._decode_payload(msg, pos)
        x = eng.apply_round(sess, x, pos, run, t_real=T, prefetch_next=self.rounds[(ridx + 1) % len(self.rounds)])
        sess.pos = pos + T
        sess.last_used = time.time()
        return self._emit(msg, sess, x, T, run[-1] == eng.config.num_hidden_layers - 1, run[-1])

    def _emit(self, msg: ActivationMessage, sess, x: torch.Tensor, T: int, is_tail: bool,
              out_layer: int) -> ActivationMessage:
        """The tail samples at the last real row; any other shard (or round)
        encodes the real rows as a hidden hop, which carries the decode
        grant, the drafts and the prefix keys on toward the tail (every
        shard snapshots or seeds its own window)."""
        if is_tail:
            res = self.engine.sample_hidden(sess, x, T - 1, msg.decoding)
            return self._final_message(msg, res, sess)
        payload, dtype, shape = self._encode_activation(x[:, :T])
        return ActivationMessage(
            nonce=msg.nonce,
            layer_id=out_layer,
            seq=msg.seq,
            dtype=dtype,
            shape=shape,
            data=payload,
            pos=msg.pos,
            callback_url=msg.callback_url,
            decoding=msg.decoding,
            auto_steps=msg.auto_steps,
            drafts=list(msg.drafts),
            prefix_store=msg.prefix_store,
            prefix_hit=msg.prefix_hit,
        )

    # ---- the ring prefix cache ------------------------------------------
    def _seed_prefix_session(self, msg: ActivationMessage):
        """The nonce's session from this shard's snapshot under the frame's
        key.  A snapshot that is missing or covers another length fails
        with a parseable `prefix-miss:<key>` error: the API clears its index
        and re-sends the whole prompt (a shard never half-serves a
        prefix)."""
        if self.prefix_snaps is None:
            raise ValueError(f"prefix-miss:{msg.prefix_hit}: prefix caching disabled on "
                             "this shard (streaming, k-round, or capacity 0)")
        hit = self.prefix_snaps.get(msg.prefix_hit)
        if hit is None:
            raise ValueError(f"prefix-miss:{msg.prefix_hit}: no snapshot on this shard")
        n, kv = hit
        if n != msg.pos:
            raise ValueError(f"prefix-miss:{msg.prefix_hit}: snapshot covers {n} tokens "
                             f"but the frame resumes at pos {msg.pos}")
        return self.engine.new_session(msg.nonce, msg.decoding.seed, kv=kv, pos=n)

    # ---- ring speculation -----------------------------------------------
    def _spec_widen(self, msg: ActivationMessage) -> ActivationMessage:
        """Head: record the frame's tokens (and the previous block's
        accepted ones, `committed`) in the nonce's history; an eligible
        granted continuation (one greedy token mid-stream, no logprobs,
        penalty or bias, room for the block) becomes a [tok, d_1..d_L]
        verify block of prompt-lookup drafts."""
        ids = msg.tokens().reshape(-1)
        pos = msg.pos
        hist = self._hist.get(msg.nonce)
        if hist is None or pos == 0:
            hist = self._hist[msg.nonce] = np.zeros(self.engine.max_seq, dtype=np.int64)
        k = len(msg.committed)
        if k:  # input positions pos - k + 1 .. pos
            hist[pos - k + 1 : pos + 1] = msg.committed
        end = min(pos + len(ids), len(hist))
        hist[pos:end] = ids[: end - pos]
        dec = msg.decoding
        L = self.spec_lookahead
        if not (msg.auto_steps > 0 and len(ids) == 1 and pos > 0 and dec.temperature == 0.0 and not dec.logprobs
                and dec.repetition_penalty == 1.0 and not dec.logit_bias and pos + L + 1 <= self.engine.max_seq):
            return msg
        drafts = ngram_draft_np(hist, pos + 1, L)
        hist[pos + 1 : pos + 1 + L] = drafts  # speculative: commits overwrite
        block = np.concatenate([ids, drafts]).astype(np.int32)[None, :]
        msg.data = block.tobytes()
        msg.shape = block.shape
        msg.drafts = [int(d) for d in drafts]
        self.spec_stats["widened"] += 1
        return msg

    def _spec_verify(self, msg: ActivationMessage, sess) -> ActivationMessage:
        """Tail: the verify block through this window (the prefill kernel at
        pos > 0), the argmax at every real row, and the agreeing prefix
        plus the first correction emitted, clamped to the grant and cut
        after a stop token.  The accepted tokens go back to the head in the
        continuation (`committed`) for its history."""
        eng = self.engine
        m = eng.model
        pos = msg.pos
        if msg.is_tokens:  # a one-shard ring verifies its own widened block
            tokens, T = self._embed_tokens(msg, pos)
            x = m.embed(eng.edge_params, tokens)
        else:
            x, T = self._decode_payload(msg, pos)
        x = eng.run_layers(sess, x, pos, t_real=T)
        logits = m.lm_project(eng.edge_params, m.normalize(eng.edge_params, x[:, :T]))  # [1, T, V]
        preds = logits.argmax(dim=-1)[0].cpu().numpy().astype(np.int64)
        drafts = np.asarray(msg.drafts, dtype=np.int64)
        agree = preds[: len(drafts)] == drafts
        n_accept = int(np.argmin(np.concatenate([agree, [False]]).astype(np.int32)))
        # the frame's own token (step seq) is free: the frame that injected
        # it granted it; only the extras spend the running grant
        toks = [int(t) for t in preds[: min(n_accept + 1, msg.auto_steps + 1)]]
        stops = tuple(msg.decoding.stop_token_ids or ())
        for i, t in enumerate(toks):  # past a stop token nothing counts
            if t in stops:
                toks = toks[: i + 1]
                break
        emitted = len(toks)
        sess.pos = pos + emitted
        sess.last_used = time.time()
        self.spec_stats["blocks"] += 1
        self.spec_stats["emitted"] += emitted
        out = ActivationMessage(
            nonce=msg.nonce, layer_id=self.max_layer, seq=msg.seq, dtype="token", shape=(1,), pos=pos,
            callback_url=msg.callback_url, decoding=msg.decoding, is_final=True, token_id=toks[0],
            extra_finals=[(msg.seq + i, toks[i]) for i in range(1, emitted)],
        )
        # the extras, then the next continuation's own token, come out of
        # this grant
        remaining = msg.auto_steps - (emitted - 1) - 1
        if remaining >= 0 and toks[-1] not in stops and sess.pos < eng.max_seq:
            out.cont = (toks[-1], sess.pos, remaining, msg.seq + emitted)
            out.committed = toks  # input positions pos + 1 .. pos + emitted
        return out

    # ---- wire encode (the single egress seam) --------------------------
    def _wire_params(self) -> tuple:
        """(drop_frac, quant_bits) of the hop codec: qsparse8 is int8 group
        quant over the kept columns (the column drop from the transport
        compression settings when configured, else the wire default);
        lossless is the plain wire-dtype cast, or sparse_v1 when transport
        compression is on."""
        if self.wire_codec == "qsparse8":
            frac = self.compress_frac if self.compress_frac > 0 else self._wire_pct
            return frac, 8
        if self.compress_frac > 0:
            return self.compress_frac, self.compress_quant_bits
        return 0.0, 0

    def _encode_activation(self, x: torch.Tensor):
        """Every outgoing hidden payload serializes here: (payload, dtype
        tag, shape).  Under the pipeline a decode-step hop (at most `lanes`
        rows) is launched into an encode-ring slot and its payload is a
        PendingWirePayload the tx stage finalizes; a full ring past its
        wait finalizes here.  Otherwise the codec runs to its bytes here, on
        x's device; only its output leaves it."""
        frac, qbits = self._wire_params()
        rows = _rows(x.shape)
        if self.wire_pipeline and rows <= self._wire_jit_rows:
            t_acq = time.perf_counter()
            slot = self._encode_ring.acquire()
            acquired = slot is not None
            t0 = time.perf_counter()
            enc = launch_encode(x, frac, wire_dtype=self.wire_dtype, quant_bits=qbits, group_size=self._wire_gs,
                                staging=self._staging if acquired else None, slot=slot or 0)
            pending = PendingWirePayload(enc, ring=self._encode_ring if acquired else None, slot=slot or 0)
            # serial: the launch; a blocked acquire is backpressure (stall)
            launch_ms = (time.perf_counter() - t0) * 1e3
            overlap.add(serial_ms=launch_ms, stall_ms=(t0 - t_acq) * 1e3)
            nbytes = sum(t.numel() * t.element_size() for t in enc.host)
            self._book(hop_encode_ms=launch_ms, frames_encoded=1, bytes_encoded=nbytes)
            with self._stats_lock:
                self.wire_stats["decode_hop_bytes"] = nbytes
            if not acquired:
                return pending.finalize_sync(), enc.dtype, enc.shape
            return pending, enc.dtype, enc.shape
        if x.is_cuda:
            # the layers' launches finish first, so the time below is the
            # codec's alone (its read-back would wait for them anyway)
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        chaos.inject("wire_encode")
        if frac > 0 or qbits:
            payload, dtype, shape = compress_tensor(
                x, frac, wire_dtype=self.wire_dtype, quant_bits=qbits, group_size=self._wire_gs,
            )
        else:
            payload, dtype, shape = tensor_to_bytes(x, wire_dtype=self.wire_dtype)
        ms = (time.perf_counter() - t0) * 1e3
        observe_encode(ms, hidden=False)
        hop = rows <= self._wire_jit_rows
        self._book(frames_encoded=1, bytes_encoded=len(payload), **{"hop_encode_ms" if hop else "prompt_encode_ms": ms})
        if hop:
            with self._stats_lock:
                self.wire_stats["decode_hop_bytes"] = len(payload)
        return payload, dtype, shape

    # ---- batched lanes -------------------------------------------------
    def _process_lane_frame(self, msg: ActivationMessage) -> ActivationMessage:
        """One coalesced decode step for every member (shard/lanes.py);
        members prefilled on this shard's B=1 sessions are adopted into
        lanes on their first frame."""
        pool = self.lane_pool
        if pool is None:
            raise ValueError("batch frame arrived but lanes are not enabled on this shard")
        n = len(msg.lanes)
        if msg.is_tokens:
            if not self.is_first:
                raise ValueError("token batch frame arrived at a non-first shard")
            out = pool.step_entry(msg, msg.tokens().reshape(n, 1), self.is_last)
        else:
            hidden = self._payload_to_device(msg)
            if hidden.shape[0] != n or hidden.shape[1] != 1:
                raise ValueError(f"batch frame payload {tuple(hidden.shape)} does not match {n} single-token lanes")
            out = pool.step_hidden(msg, hidden, self.is_last)
        if self.is_last:
            return self._lane_finals_message(msg, out)
        return self._emit_lanes(msg, out)

    def _emit_lanes(self, msg: ActivationMessage, x: torch.Tensor) -> ActivationMessage:
        """A batch frame's hidden hop: the members' rows stacked [n, 1, D]."""
        payload, dtype, shape = self._encode_activation(x)
        return ActivationMessage(nonce=msg.nonce, layer_id=self.max_layer, seq=msg.seq, dtype=dtype, shape=shape,
                                 data=payload, pos=msg.pos, callback_url=msg.callback_url, decoding=msg.decoding,
                                 lanes=list(msg.lanes))

    def _lane_finals_message(self, msg: ActivationMessage, results) -> ActivationMessage:
        """A batch frame's tail: one TokenResult-shaped dict a member, which
        the adapter fans out as one token callback each; a faulted member's
        carries its error."""
        finals = []
        for lane, res in zip(msg.lanes, results):
            if res is None:
                finals.append({"nonce": lane["nonce"], "step": int(lane["seq"]), "token_id": -1,
                               "error": lane.get("error") or "lane failed"})
                continue
            tr = LocalEngine.token_result(lane["nonce"], res, step=int(lane["seq"]),
                                          decoding=DecodingParams(**(lane.get("decoding") or {})))
            finals.append({"nonce": tr.nonce, "step": tr.step, "token_id": tr.token_id, "logprob": tr.logprob,
                           "top_ids": [t for t, _ in (tr.top_logprobs or [])],
                           "top_logprobs": [lp for _, lp in (tr.top_logprobs or [])]})
        return ActivationMessage(nonce=msg.nonce, layer_id=self.max_layer, seq=msg.seq, dtype="token",
                                 shape=(len(finals),), pos=msg.pos, callback_url=msg.callback_url,
                                 decoding=msg.decoding, is_final=True, lane_finals=finals)

    def _final_message(self, msg: ActivationMessage, res, sess) -> ActivationMessage:
        decoding = msg.decoding
        tr = LocalEngine.token_result(msg.nonce, res, step=msg.seq, decoding=decoding)
        out = ActivationMessage(
            nonce=msg.nonce,
            layer_id=self.max_layer,
            seq=msg.seq,
            dtype="token",
            shape=(1,),
            pos=msg.pos,
            callback_url=msg.callback_url,
            decoding=decoding,
            is_final=True,
            token_id=tr.token_id,
            logprob=tr.logprob,
            top_logprobs=tr.top_logprobs,
        )
        # decode grant: with budget left, a non-stop token and cache room,
        # the sampled token re-enters the ring at the head (the adapter
        # injects `cont`) while the API receives it in parallel
        stops = tuple(decoding.stop_token_ids or ())
        if msg.auto_steps > 0 and tr.token_id not in stops and sess.pos < self.engine.max_seq:
            out.cont = (tr.token_id, sess.pos, msg.auto_steps - 1, msg.seq + 1)
        return out

    def ring_stats(self) -> dict:
        """/health's view of the pipeline (the encode ring's depth, slots in
        flight and peak, and the overlap books) and of the lane pool
        (slots, lanes held), for those this shard runs."""
        out = {}
        if self.wire_pipeline:
            ring = self._encode_ring
            out["wire_pipeline"] = {"depth": ring.depth, "inflight": ring.inflight, "peak": ring.peak,
                                    "overlap": overlap.snapshot()}
        if self.lane_pool is not None:
            out["lanes"] = {"slots": self.lane_pool.slots, "active": len(self.lane_pool.slot_of)}
        return out

    def sweep_sessions(self) -> int:
        n = self.engine.sweep_sessions()
        if self.lane_pool is not None:
            n += self.lane_pool.sweep(self.engine.KV_TTL_S)
        # a draft history whose session died (TTL sweep, a failed reset)
        # would pin its max_seq array
        for nonce in [k for k in self._hist if k not in self.engine.sessions]:
            self._hist.pop(nonce, None)
        return n

    def health(self) -> dict:
        """/health's view of this shard's compute: its layers and rounds,
        the live sessions, the prefix snapshots' counters and, when it
        speculates, the verify blocks."""
        out = {"layers": list(self.layers), "rounds": [list(r) for r in self.rounds],
               "sessions": len(self.engine.sessions)}
        if self.prefix_snaps is not None:
            out["prefix_cache"] = dict(self.prefix_snaps.stats, entries=len(self.prefix_snaps))
        if self._spec_ok:
            out["spec"] = dict(self.spec_stats, lookahead=self.spec_lookahead)
        return out
