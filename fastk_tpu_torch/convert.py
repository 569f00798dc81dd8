"""State carried between the JAX package and the port.

FastK has no weights: what crosses is the code stream and the key words.
The JAX package holds key words as uint32 arrays; the port holds them as
int64 tensors with values in [0, 2^32) (see ops/kmers.py).
"""

from __future__ import annotations

import numpy as np
import torch


def words_from_numpy(words, device) -> tuple:
    """tuple of W uint32 arrays -> tuple of int64 tensors on `device`."""
    return tuple(torch.from_numpy(np.asarray(w).astype(np.int64)).to(device)
                 for w in words)


def words_to_numpy(words) -> tuple:
    """tuple of int64 word tensors -> tuple of uint32 numpy arrays."""
    out = []
    for w in words:
        a = w.cpu().numpy()
        if a.size and (a.min() < 0 or a.max() > 0xFFFFFFFF):
            raise ValueError("key word outside [0, 2^32)")
        out.append(a.astype(np.uint32))
    return tuple(out)


def codes_from_numpy(codes: np.ndarray, device) -> torch.Tensor:
    """uint8 code stream -> uint8 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8)
                            ).to(device)
