"""Device selection: CUDA unless the caller asks for the CPU.

A CUDA request on a machine without a card raises; nothing here falls
back to the CPU, so a run that names no device either ran on the card
or failed.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` is None (meaning ``cuda``), a string or a
    ``torch.device``. Raises RuntimeError for CUDA without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
