"""The serving mesh: the --mesh spec, the devices of a pp x sp mesh's
ranks, and the reductions of the sequence-parallel cross-rank combine.

Counterpart of dnet_tpu/parallel/mesh.py for the pipeline (pp) and
sequence-parallel (sp) axes.  The reference runs one program over a JAX
`Mesh`; the port keeps its single controller: a mesh is a list of pp x sp
torch devices, stage-major (parallel/ring.py places pipeline stage r's
layers on its first), and within a stage an sp group is its R = sp
devices, one per rank, where rank r owns KV slots [r * S_local,
(r + 1) * S_local) on its own device (S_local = max_seq / R).  Everything
outside attention runs once, on rank 0's device (the reference replicates
it over sp; the result is the same).  Per layer, q goes to each rank's device, each rank computes
its attention partials there, and the partials come back to rank 0 for
the combine, where the reference's `lax.pmax` / `lax.psum` become a max
and sums over the gathered per-rank tensors (`SpGroup.pmax`,
`SpGroup.psum`).  A `torch.distributed` group can implement the same two
methods over one tensor per process (all_reduce with MAX / SUM) without
touching their callers (ops/ring_attention.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

AXES = ("pp", "tp", "dp", "sp")


def parse_mesh(spec: str) -> Optional[Dict[str, int]]:
    """'pp=4,tp=2' -> {"pp": 4, "tp": 2}; '' -> None.  pp=0 means infer
    (the reference fills pp with the devices left over)."""
    if not spec:
        return None
    out: Dict[str, int] = {}
    for part in spec.split(","):
        key, eq, val = part.partition("=")
        key = key.strip()
        if not eq or not val.strip():
            raise ValueError(f"--mesh expects axis=value pairs; got {part!r}")
        if key not in AXES:
            raise ValueError(f"unknown mesh axis {key!r} in --mesh (use pp/tp/dp/sp)")
        try:
            n = int(val)
        except ValueError:
            raise ValueError(f"--mesh {key}={val!r} is not an integer") from None
        if n < 0 or (n == 0 and key != "pp"):
            raise ValueError(f"--mesh {key}={n} must be positive (pp=0 = infer)")
        out[key] = n
    return out


def rank_devices(n: int, device: Optional[Union[str, torch.device]] = None) -> List[torch.device]:
    """The devices of a mesh's n = pp x sp ranks when the caller names
    none, stage-major (stage r's sp ranks are entries r * sp .. r * sp +
    sp - 1): on CUDA (the default) one card per rank, cuda:0 .. cuda:n-1,
    refusing a machine with fewer cards as the reference's build_mesh
    does; on the CPU (device 'cpu') every rank on the CPU.  Ranks are never
    co-located on one card here: a caller that wants that passes the list
    itself (a device may repeat there)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    if dev.type != "cuda":
        raise ValueError(f"mesh ranks run on CUDA or the CPU, not {dev}")
    have = device_count()
    if n > have:
        raise ValueError(f"mesh needs {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def device_count() -> int:
    """The cards a mesh may take when the caller names no devices (none
    without CUDA): pp = 0 ("infer") counts them."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


class SpGroup:
    """R sequence-parallel ranks driven by one controller: rank r's device
    holds KV slots [r * S_local, (r + 1) * S_local).  `home` (rank 0's
    device) holds the weights and gathers the partials."""

    def __init__(self, devices: Sequence[Union[str, torch.device]]):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("an sp group needs at least one device")
        self.size = len(self.devices)
        self.home = self.devices[0]

    def to_ranks(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x on every rank's device (no copy where it already lies there)."""
        return [x.to(d, non_blocking=True) for d in self.devices]

    def gather(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each rank's tensor on the home device."""
        return [p.to(self.home, non_blocking=True) for p in parts]

    def pmax(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Elementwise max over the ranks' tensors (the reference's
        lax.pmax), on the home device."""
        out = None
        for p in self.gather(parts):
            out = p if out is None else torch.maximum(out, p)
        return out

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum over the ranks' tensors (lax.psum), on the home device, in
        rank order."""
        out = None
        for p in self.gather(parts):
            out = p if out is None else out + p
        return out
