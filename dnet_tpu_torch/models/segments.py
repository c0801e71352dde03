"""Two-segment window layout, for models whose layers come in two param
layouts: deepseek_v2 (a dense prefix below `first_k_dense_replace`, then
the MoE suffix).

Counterpart of dnet_tpu/models/segments.py on one device.  A window stacks
as {"dense": [...], "moe": [...]} (per-layer param dicts; either key may be
absent), and the layers run dense segment first, then moe segment, which
is the model's layer order whenever every dense layer precedes every MoE
layer, as the owning model guarantees.  The cache stays one flat stack:
rows [:Ld] belong to the dense segment, rows [Ld:] to the moe segment.

On a pipeline-parallel mesh the reference runs one segment per ring lap
(`phase`) over stacks padded to a multiple of pp (`pad_mesh_segments`);
the port places each lap's real layers as a stage run of their own
(parallel/ring.py `stage_layers`), whose window is one segment.  A streamed layer (`wrap_offload_layer`) is a window
of one segment holding one layer over its own one-layer cache.
Weight quantization needs nothing of the layout: the engine quantizes each
layer's params before `stack_layers` sorts them into segments.

The host class provides `layer(p, x, kvs, pos, lengths=, sp=, attend_fn=)`,
one layer over its cache slices (written in place, or through the batched
lanes' attend hook).  Under sequence parallelism (an
sp group, parallel/mesh.py) the cache is one flat stack per rank and a
layer gets every rank's rows.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from dnet_tpu_torch.core.kvcache import layer_slices

SEGMENTS = ("dense", "moe")


class TwoSegmentStackMixin:
    def wrap_offload_layer(self, mapped: dict, layer: int) -> Dict[str, List[dict]]:
        """One layer as a one-layer window of its segment."""
        return {"moe" if self.is_moe_layer(layer) else "dense": [mapped]}

    def _apply_segments(
        self, window_params: Dict[str, List[dict]], x: torch.Tensor, kv, pos: int,
        lengths=None, sp=None, attend_fn=None,
    ) -> torch.Tensor:
        """The dense segment's layers, then the moe segment's, each over its
        rows of the flat cache (of every rank's cache under `sp`), written in
        place; returns x."""
        row = 0
        for seg in SEGMENTS:
            for p in window_params.get(seg, ()):
                kvs = layer_slices(kv, row) if sp is None else [layer_slices(c, row) for c in kv]
                x, _ = self.layer(p, x, kvs, pos, lengths=lengths, sp=sp, attend_fn=attend_fn)
                row += 1
        return x
