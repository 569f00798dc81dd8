"""Device selection for the port: explicit, and never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device to compute on.

    Raises RuntimeError when CUDA is asked for and this process has no usable
    CUDA device: a run meant for the card must not quietly run on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
