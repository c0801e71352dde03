"""Where the port runs: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device`, defaulting to "cuda".  Raises when CUDA is asked for (or
    defaulted to) but absent: the port never falls back to the CPU on its
    own; pass device="cpu" (CLI: --device cpu) to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on a CUDA device by default "
            "(pass device='cpu', or --device cpu, to run on the CPU)"
        )
    return dev
