"""Types shared by the API node, the shards and the engine.

Counterpart of dnet_tpu/core/types.py: `DecodingParams`, `TokenResult`,
the ring's `ActivationMessage`, and the topology types `DeviceInfo`,
`LayerAssignment` and `TopologyInfo`, under the reference's field names.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


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
    # topology epoch the emitting shard held (0 = unfenced)
    epoch: int = 0


@dataclass
class ActivationMessage:
    """In-memory activation envelope hopping shard to shard.

    dtype == "tokens" marks an int32 token-id payload entering layer 0;
    anything else is a hidden-state tensor (its dtype may carry the hop
    codec's tags).  The ring fields (decode grants, drafts, lanes, prefix
    keys, deadline, epoch) ride along as the reference defines them."""

    nonce: str
    layer_id: int  # last layer already applied; -1 = raw tokens
    seq: int  # per-nonce frame sequence number
    dtype: str
    shape: tuple
    data: Any = None  # bytes | np.ndarray | torch.Tensor
    pos: int = 0  # absolute position of the frame's first token
    callback_url: str = ""
    decoding: DecodingParams = field(default_factory=DecodingParams)
    is_final: bool = False
    token_id: Optional[int] = None
    logprob: Optional[float] = None
    top_logprobs: Optional[list] = None
    error: str = ""
    # decode grant: tokens the tail may feed back into the ring without an
    # API round trip; on a final message, the (token, pos, remaining_steps,
    # next_seq) continuation the adapter injects at the head
    auto_steps: int = 0
    cont: Optional[tuple] = None
    # ring speculation: `drafts` ride a verify block head -> tail,
    # `committed` (the block's accepted tokens) the continuation tail ->
    # head, and `extra_finals` [(seq, token_id), ...] are a verify block's
    # tokens after the first, one API callback each
    drafts: list = field(default_factory=list)
    committed: list = field(default_factory=list)
    extra_finals: Optional[list] = None
    # batched lanes: a coalesced decode frame's members, one {"nonce",
    # "seq", "pos", "decoding"} each, payload rows in the same order; the
    # tail answers with `lane_finals`, one TokenResult-shaped dict a member
    lanes: list = field(default_factory=list)
    lane_finals: Optional[list] = None
    prefix_store: str = ""
    prefix_hit: str = ""
    deadline: float = 0.0  # end-to-end request deadline (epoch s, 0 = none)
    epoch: int = 0
    # the wire pipeline's receive half: a hidden payload already uploaded
    # and decoded at ingress (process-local, never on the wire)
    device_data: Any = None

    @property
    def is_tokens(self) -> bool:
        return self.dtype == "tokens"

    def tokens(self) -> np.ndarray:
        if not self.is_tokens:
            raise ValueError("not a token message")
        if isinstance(self.data, (bytes, memoryview)):
            return np.frombuffer(self.data, dtype=np.int32).reshape(self.shape)
        return np.asarray(self.data, dtype=np.int32).reshape(self.shape)


@dataclass
class DeviceInfo:
    """A participating shard as discovery sees it."""

    instance: str  # unique shard instance name
    host: str  # reachable IP/hostname
    http_port: int
    grpc_port: int
    is_manager: bool = False
    slice_id: int = 0
    chip_count: int = 1
    chip_kind: str = ""
    hbm_bytes: int = 0
    host_ram_bytes: int = 0
    flops_bf16: float = 0.0
    hbm_bw: float = 0.0
    host_to_hbm_bw: float = 0.0
    t_comm: float = 0.0
    ici_bw: float = 0.0

    def ici_adjacent(self, other: "DeviceInfo") -> bool:
        """Same host and same slice: the solver may merge the two into one
        node's mesh slice."""
        return self.host == other.host and self.slice_id == other.slice_id


@dataclass
class LayerAssignment:
    """One shard's share of the ring: absolute layer ids (contiguous per
    round) and its next hop."""

    instance: str
    layers: List[int]
    rounds: List[List[int]] = field(default_factory=list)
    next_instance: str = ""
    window_size: int = 0
    residency_size: int = 0
    mesh_tp: int = 0
    mesh_sp: int = 0
    tp_degree: int = 0

    @property
    def min_layer(self) -> int:
        return min(self.layers) if self.layers else -1


@dataclass
class TopologyInfo:
    """The ring plan shared by the API and the shards."""

    model: str
    num_layers: int
    kv_bits: int
    devices: List[DeviceInfo]
    assignments: List[LayerAssignment]
    solution: dict = field(default_factory=dict)
    epoch: int = 0  # minted when the API installs the topology

    def assignment_for(self, instance: str) -> Optional[LayerAssignment]:
        return next((a for a in self.assignments if a.instance == instance), None)

    def head_instance(self) -> str:
        """Owner of layer 0 (the first hop of a token frame)."""
        for a in self.assignments:
            if 0 in a.layers:
                return a.instance
        raise ValueError("no assignment owns layer 0")
