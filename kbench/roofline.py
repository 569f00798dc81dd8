"""The yardstick of the roofline shares: the card's published peak and the
least bytes a call has to move, counted from the call's own tensors.

NVIDIA's data sheet gives one H100 SXM 3.35 TB/s of HBM3 bandwidth at its
700 W power limit; a card set below that limit runs slower under load, so a
share is always printed with the card's power limit beside it.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12


def nbytes(*tensors) -> int:
    """Bytes of the tensors, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def share_pct(bytes_moved: int, device_s: float):
    """The share of the bandwidth bound: bytes / peak over the device
    seconds, in percent; None where nothing ran."""
    if device_s <= 0 or bytes_moved <= 0:
        return None
    return 100.0 * bytes_moved / HBM_BYTES_PER_S / device_s


def power_limit():
    """The first card's power limit as nvidia-smi reads it, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else None
