"""Canonical k-mer keys for every window position, in torch ops.

Port of ``fastk_tpu/ops/kmers.py``. A key is W = ceil(k/16) words of 16 bases,
2 bits a base, big-endian within and across words, the last word
left-aligned and zero-padded, so that word-tuple order is the byte order of
the ``.ktab`` packing. The canonical key is min(forward, reverse complement).

Torch on the CPU has no unsigned 32-bit shifts, so each 32-bit word is carried
as an int64 tensor holding a value in [0, 2^32). The 4-base groups are uint8,
where every shift stays in range. The host packing of words into .ktab
bytes (``words_to_packed``, ``packed_to_words``) is numpy, as in the JAX
module.
"""

from __future__ import annotations

import numpy as np
import torch


def nwords(k: int) -> int:
    return (k + 15) // 16


def pad_needed(k: int) -> int:
    """Sentinel codes the host pads beyond the last window position."""
    return k + 16


def _word(groups: torch.Tensor, parts, size: int) -> torch.Tensor:
    """int64 word ORed from 4-base groups: parts is ((offset, shift), ...)."""
    (off, shift), *rest = parts
    w = groups[off: off + size].to(torch.int64) << shift
    for off, shift in rest:
        w |= groups[off: off + size].to(torch.int64) << shift
    return w


def canonical_kmers(codes: torch.Tensor, k: int, size: int):
    """Canonical k-mer keys for every window start in [0, size).

    codes: uint8 [>= size + pad_needed(k)], 0..3 valid bases, >= 4 invalid.

    Returns (words, invalid): a tuple of W int64 [size] words in [0, 2^32),
    zero where the window is invalid, and a bool [size] that is True where
    the window holds a code >= 4.
    """
    if codes.dim() != 1 or codes.numel() < size + pad_needed(k):
        raise ValueError(f"codes must be 1-D with >= {size + pad_needed(k)} "
                         f"entries, got shape {tuple(codes.shape)}")
    c = codes.to(torch.uint8)
    W = nwords(k)
    L = k - 16 * (W - 1)  # bases in the last word, 1..16
    ng = size + k
    f2 = c[: ng + 3] & 3
    r2 = 3 - f2
    # A[p]: bases p..p+3, base p in the high bits; B[p]: the reverse
    # complement of the same four bases, base p+3 complemented in the high bits
    A = (f2[:ng] << 6) | (f2[1:ng + 1] << 4) | (f2[2:ng + 2] << 2) | f2[3:ng + 3]
    B = (r2[3:ng + 3] << 6) | (r2[2:ng + 2] << 4) | (r2[1:ng + 1] << 2) | r2[:ng]
    del f2, r2

    full = (24, 16, 8, 0)
    fwd = [_word(A, [(16 * w + 4 * j, full[j]) for j in range(4)], size)
           for w in range(W - 1)]
    rc = [_word(B, [(k - 16 * (w + 1) + 4 * j, 8 * j) for j in range(4)],
                size) for w in range(W - 1)]
    # the last word needs only the groups that hold its L bases (a group
    # past them would also reach beyond the end of the stream)
    ng_last = (L + 3) // 4
    f_last = _word(A, [(16 * (W - 1) + 4 * j, full[j])
                       for j in range(ng_last)], size)
    r_last = _word(B, [(4 * j, 8 * j) for j in range(ng_last)], size)
    if L < 16:
        f_last &= ((1 << (2 * L)) - 1) << (32 - 2 * L)
        r_last = (r_last & ((1 << (2 * L)) - 1)) << (32 - 2 * L)
    fwd.append(f_last)
    rc.append(r_last)
    del A, B

    # lexicographic forward vs reverse complement: the first differing word
    take_rc = torch.zeros(size, dtype=torch.int64, device=c.device)
    for f, r in zip(fwd, rc):
        take_rc = torch.where(take_rc != 0, take_rc, torch.sign(f - r))
    take_rc = take_rc > 0

    bad = (c[: size + k] >= 4).to(torch.int32)
    cb = torch.cat([bad.new_zeros(1), torch.cumsum(bad, 0, dtype=torch.int32)])
    invalid = (cb[k: size + k] - cb[:size]) > 0
    del bad, cb

    zero = torch.zeros((), dtype=torch.int64, device=c.device)
    words = tuple(torch.where(invalid, zero, torch.where(take_rc, r, f))
                  for f, r in zip(fwd, rc))
    return words, invalid


def words_to_packed(words: np.ndarray, k: int) -> np.ndarray:
    """Host: (n, W) uint32 canonical words -> (n, ceil(k/4)) uint8 .ktab
    bytes."""
    kb = (k + 3) // 4
    if words.shape[0] == 0:
        return np.zeros((0, kb), dtype=np.uint8)
    be = np.ascontiguousarray(words.astype(">u4"))
    return be.view(np.uint8).reshape(words.shape[0], -1)[:, :kb]


def packed_to_words(packed: np.ndarray, k: int) -> np.ndarray:
    """Host: (n, ceil(k/4)) uint8 .ktab bytes -> (n, W) uint32 words."""
    n = packed.shape[0]
    W = nwords(k)
    buf = np.zeros((n, 4 * W), dtype=np.uint8)
    buf[:, : packed.shape[1]] = packed
    return buf.view(">u4").astype(np.uint32).reshape(n, W)
