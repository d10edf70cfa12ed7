"""Device selection for the port's entry points.

The port runs on CUDA by default.  The CPU is used only when the caller
asks for it by name (the CPU tests do); a missing GPU is an error, never
a silent fallback.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; anything else as given.  Raises
    ``RuntimeError`` for a CUDA device when no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
