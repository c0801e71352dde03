"""Shard compute core: one ActivationMessage in, one out.

Counterpart of dnet_tpu/shard/compute.py `ShardCompute` over a
`LocalEngine` in shard mode: embed + window on the head, window on a middle
shard, window + head + sample on the tail.  Incoming frames are padded to
the engine's power-of-two prefill buckets.  Hidden hops leave through one
encode seam, `_encode_activation`: the lossless cast to the wire dtype, or
the qsparse8/sparse_v1 codec, whose column norms, gather and (on the
receiving shard) dequant + scatter run in the CUDA kernels of
compression/ops.py.

This slice serves llama-family checkpoints (gpt_oss's paired sliding/full
layers are not ported to shards), one contiguous layer range per shard, one
request per ring pass and a synchronous encode; the shard's KV cache takes
the topology's kv_bits (bf16, int8 or packed int4, as core/kvcache.py
`resolve_kv_bits` maps it).  The topology's `window_size` /
`residency_size` give the shard's weight plan (core/weights.py): under
offload or sliding_fit its layers stream from host memory (the repack
cache under `repack_dir`), the head shard running embed + the streamed
layers and the tail the streamed layers + norm + head + sample, as the
reference's streaming branch does.  Every option
that would ask for more is refused at load (`ShardCapabilityError`) rather
than quietly served as something else.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from dnet_tpu_torch.compression import (
    compress_tensor,
    decompress_tensor_device,
    is_compressed_dtype,
)
from dnet_tpu_torch.config import transport_settings, wire_settings
from dnet_tpu_torch.core.engine import LocalEngine, bucket_length
from dnet_tpu_torch.core.kvcache import resolve_kv_bits
from dnet_tpu_torch.core.types import ActivationMessage
from dnet_tpu_torch.utils.serialization import bytes_to_device, tensor_to_bytes


def _rows(shape) -> int:
    """Rows of a [..., D] hidden frame (1 for a decode step's hop)."""
    return int(np.prod(shape[:-1])) if len(shape) > 1 else 1


class ShardCapabilityError(ValueError):
    """A load option this shard does not serve."""


# the model families a shard serves (gpt_oss's paired halves and ring
# caches are not split over shards yet)
SHARD_MODEL_TYPES = ("llama",)


def refuse_model(model_dir: Union[str, Path]) -> None:
    """Raise ShardCapabilityError for a checkpoint whose family this shard
    does not serve; read from its config.json before any weight."""
    cfg_path = Path(model_dir) / "config.json"
    if not cfg_path.is_file():
        raise FileNotFoundError(f"no config.json in {model_dir}")
    model_type = json.loads(cfg_path.read_text()).get("model_type")
    if model_type not in SHARD_MODEL_TYPES:
        raise ShardCapabilityError(
            f"this shard does not serve model_type {model_type!r} (ring shards serve {SHARD_MODEL_TYPES})"
        )


def refuse_unsupported(
    layers: Sequence[int],
    *,
    kv_bits: int = 0,
    weight_quant_bits: int = 0,
    mesh_tp: int = 0,
    mesh_sp: int = 0,
    tp_degree: int = 0,
    spec_lookahead: int = 0,
    lanes: int = 0,
    prefix_cache: int = 0,
    wire_pipeline: Optional[bool] = None,
    **_other,
) -> None:
    """Raise ShardCapabilityError for the first load option outside this
    slice: batched lanes, ring speculation, the ring prefix cache, k-round
    (non-contiguous) schedules, mesh or tensor parallelism, a kv_bits that
    is none of 0/16/8/4, a weight_quant_bits that is none of 0/8/4, and the
    overlapped wire pipeline (None: DNET_WIRE_PIPELINE).  Other keyword
    arguments are ignored, so a caller can pass its whole load body."""
    if wire_pipeline is None:
        wire_pipeline = wire_settings().pipeline
    ls = sorted(int(a) for a in layers)
    if not ls:
        raise ShardCapabilityError("empty layer list")
    refused = [
        (lanes > 1, f"lanes={lanes}: batched ring lanes are not ported"),
        (spec_lookahead > 0, f"spec_lookahead={spec_lookahead}: ring speculation is not ported"),
        (prefix_cache > 0, f"prefix_cache={prefix_cache}: the ring prefix cache is not ported"),
        (ls != list(range(ls[0], ls[-1] + 1)),
         f"layers {ls} are not one contiguous range: k-round schedules are not ported"),
        (mesh_tp not in (0, 1) or mesh_sp not in (0, 1) or tp_degree > 1,
         f"mesh_tp={mesh_tp} mesh_sp={mesh_sp} tp_degree={tp_degree}: "
         "mesh and tensor parallelism are not ported"),
        (kv_bits not in (0, 4, 8, 16), f"kv_bits={kv_bits} (supported: 0/4/8/16)"),
        (weight_quant_bits not in (0, 4, 8), f"weight_quant_bits={weight_quant_bits} (supported: 0/4/8)"),
        (wire_pipeline, "DNET_WIRE_PIPELINE=1: the overlapped wire pipeline is not ported"),
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
            tp_degree=tp_degree, spec_lookahead=spec_lookahead, lanes=lanes,
            prefix_cache=prefix_cache, wire_pipeline=wire_pipeline,
        )
        refuse_model(model_dir)
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
        # decoded (received), their payload bytes, the last single-row
        # (decode step) hop's bytes, and the host time of the encode and
        # the decode, summed apart for single-row hops and prompt frames
        self.wire_stats = {
            "frames_encoded": 0, "bytes_encoded": 0, "frames_decoded": 0,
            "bytes_decoded": 0, "decode_hop_bytes": 0, "hop_encode_ms": 0.0,
            "prompt_encode_ms": 0.0, "hop_decode_ms": 0.0, "prompt_decode_ms": 0.0,
        }

    @property
    def max_layer(self) -> int:
        return max(self.layers)

    def wants(self, layer_id: int) -> bool:
        """Is the layer after `layer_id` ours?  (layer_id -1 = raw tokens.)"""
        return (layer_id + 1) in self.engine.model.abs_to_local

    def reset(self, nonce: str = "") -> None:
        if nonce:
            self.engine.end_session(nonce)
        else:
            self.engine.sessions.clear()

    # ---- ingress decode ------------------------------------------------
    def _payload_to_device(self, msg: ActivationMessage) -> torch.Tensor:
        """Hidden payload bytes -> a tensor on the engine's device.  A
        compressed frame uploads only its compact buffers and is rebuilt by
        the dequant + scatter kernel."""
        eng = self.engine
        t0 = time.perf_counter()
        if is_compressed_dtype(msg.dtype):
            out = decompress_tensor_device(msg.data, msg.dtype, msg.shape, eng.device)
        else:
            out = bytes_to_device(msg.data, msg.dtype, msg.shape, eng.device)
        s = self.wire_stats
        s["hop_decode_ms" if _rows(msg.shape) == 1 else "prompt_decode_ms"] += (time.perf_counter() - t0) * 1e3
        s["frames_decoded"] += 1
        s["bytes_decoded"] += len(msg.data)
        return out

    def _padded_len(self, T: int, pos: int) -> int:
        eng = self.engine
        if pos + T > eng.max_seq:
            raise ValueError(f"sequence {pos + T} exceeds max_seq {eng.max_seq}")
        return 1 if T == 1 else min(bucket_length(T), eng.max_seq - pos)

    def _decode_payload(self, msg: ActivationMessage, pos: int):
        """Incoming hidden frame -> (padded [B, Tpad, D] in the param
        dtype, real length T)."""
        hidden = self._payload_to_device(msg)
        T = hidden.shape[1]
        Tpad = self._padded_len(T, pos)
        if Tpad != T:
            hidden = F.pad(hidden, (0, 0, 0, Tpad - T))
        return hidden.to(self.engine.param_dtype), T

    def _embed_tokens(self, msg: ActivationMessage, pos: int):
        eng = self.engine
        ids = msg.tokens()
        T = ids.shape[-1]
        Tpad = self._padded_len(T, pos)
        tokens = np.zeros((eng.batch, Tpad), dtype=np.int64)
        tokens[:, :T] = ids.reshape(1, -1)
        return torch.from_numpy(tokens).to(eng.device), T

    # ---- compute -------------------------------------------------------
    def process(self, msg: ActivationMessage) -> ActivationMessage:
        """Run this shard's window; returns the outgoing message (a hidden
        hop or the final sampled token)."""
        if msg.lanes:
            raise ValueError("batch frame arrived but lanes are not enabled on this shard")
        if msg.drafts:
            raise ValueError("verify block arrived but this shard cannot speculate")
        if msg.prefix_hit:
            raise ValueError(f"prefix-miss:{msg.prefix_hit}: prefix caching disabled on this shard")
        eng = self.engine
        nonce, pos = msg.nonce, msg.pos
        sess = eng.sessions.get(nonce)
        if sess is None:
            if pos > 0:
                # a mid-stream frame with no session is stale (a grant still
                # circulating after a reset, or a swept request): recreating
                # the session would compute garbage
                raise ValueError(f"no session for {nonce!r} at pos {pos} (reset or expired); dropping frame")
            sess = eng.new_session(nonce, msg.decoding.seed)
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
        if self.is_last:
            res = eng.sample_hidden(sess, x, T - 1, msg.decoding)
            return self._final_message(msg, res, sess)
        payload, dtype, shape = self._encode_activation(x[:, :T])
        return ActivationMessage(
            nonce=nonce,
            layer_id=self.max_layer,
            seq=msg.seq,
            dtype=dtype,
            shape=shape,
            data=payload,
            pos=pos,
            callback_url=msg.callback_url,
            decoding=msg.decoding,
            # the decode grant must reach the tail: it rides every hop
            auto_steps=msg.auto_steps,
        )

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
        """Every outgoing hidden payload serializes here: (bytes, dtype tag,
        shape).  The codec runs on x's device; only its output leaves it."""
        frac, qbits = self._wire_params()
        if x.is_cuda:
            # the layers' launches finish first, so the time below is the
            # codec's alone (its read-back would wait for them anyway)
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        if frac > 0 or qbits:
            payload, dtype, shape = compress_tensor(
                x, frac, wire_dtype=self.wire_dtype, quant_bits=qbits, group_size=self._wire_gs,
            )
        else:
            payload, dtype, shape = tensor_to_bytes(x, wire_dtype=self.wire_dtype)
        s = self.wire_stats
        hop = _rows(shape) == 1
        s["hop_encode_ms" if hop else "prompt_encode_ms"] += (time.perf_counter() - t0) * 1e3
        s["frames_encoded"] += 1
        s["bytes_encoded"] += len(payload)
        if hop:
            s["decode_hop_bytes"] = len(payload)
        return payload, dtype, shape

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

    def sweep_sessions(self) -> int:
        return self.engine.sweep_sessions()
