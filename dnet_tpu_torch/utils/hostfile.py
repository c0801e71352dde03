"""Static discovery from a hostfile.

Counterpart of dnet_tpu/utils/hostfile.py, with its two formats:

1. lines:  ``<instance> <host> <http_port> <grpc_port> [manager]``
2. JSON: ``[{"instance": ..., "host": ..., "http_port": ..., "grpc_port": ...,
   "is_manager": false, "slice_id": 0, "chip_count": 1}, ...]``
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Union

from dnet_tpu_torch.core.types import DeviceInfo


def load_hostfile(path: Union[str, Path]) -> List[DeviceInfo]:
    text = Path(path).read_text().strip()
    if not text:
        return []
    if text.startswith(("[", "{")):
        return _parse_json(text)
    return _parse_lines(text)


def _parse_json(text: str) -> List[DeviceInfo]:
    data = json.loads(text)
    if isinstance(data, dict):
        data = data.get("devices", [])
    return [
        DeviceInfo(
            instance=e["instance"],
            host=e["host"],
            http_port=int(e["http_port"]),
            grpc_port=int(e["grpc_port"]),
            is_manager=bool(e.get("is_manager", False)),
            slice_id=int(e.get("slice_id", 0)),
            chip_count=int(e.get("chip_count", 1)),
            chip_kind=e.get("chip_kind", ""),
        )
        for e in data
    ]


def _parse_lines(text: str) -> List[DeviceInfo]:
    devices = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 4:
            raise ValueError(f"bad hostfile line: {line!r}")
        devices.append(
            DeviceInfo(
                instance=parts[0],
                host=parts[1],
                http_port=int(parts[2]),
                grpc_port=int(parts[3]),
                is_manager=len(parts) > 4 and parts[4].lower() in {"manager", "true", "1"},
            )
        )
    return devices


class StaticDiscovery:
    """Hostfile-backed peer table."""

    def __init__(self, devices: List[DeviceInfo]):
        self._devices = {d.instance: d for d in devices}

    @classmethod
    def from_hostfile(cls, path: Union[str, Path]) -> "StaticDiscovery":
        return cls(load_hostfile(path))

    def peers(self) -> List[DeviceInfo]:
        return list(self._devices.values())
