"""Sorted-table operations on the device: the operands of a merge of counted
key rows, and the union-merge of counted key sets.

Port of ``fastk_tpu/ops/tables.py``. Keys are host (n, W) uint32 word rows
(ops/kmers.py packing); on the device they become W int64 word tensors.
``sort_counted`` is not ported: no caller of the port needs it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from fastk_tpu.ops.tables import _merge_np
from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.count import ONES, merge_unique_blocks

DEVICE_MIN_ROWS = 1 << 20  # below this, numpy beats the transfers


def _upload_u32(a: np.ndarray, device) -> torch.Tensor:
    """Host uint32 [n] -> device int64 [n]: sent as int32 bits, widened on
    the device."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                         .view(np.int32)).to(device)
    return t.to(torch.int64) & ONES


def pad_counted(words: np.ndarray, counts: np.ndarray, device):
    """Device operands for merge_unique_blocks from host (n, W) uint32 words
    and counts: (tuple of W int64 [cap], int32 [cap]).

    The port of JAX's ``pad_counted_pow2``, with its empty-slot convention
    (all-ones words, count 0) but without its power-of-two capacity: torch
    compiles nothing per shape, so a pow2 pad would only add up to 2x the
    merge's sort work and memory. cap is n, or 1 for n = 0 (one empty slot,
    so that a merge of nothing still has a record). The merged outputs do
    not depend on the padding."""
    n = len(counts)
    pad = 1 if n == 0 else 0
    wt = tuple(
        torch.cat([_upload_u32(words[:, j], device),
                   torch.full((pad,), ONES, dtype=torch.int64,
                              device=device)])
        for j in range(words.shape[1]))
    ct = torch.cat([
        torch.from_numpy(np.asarray(counts).astype(np.int32)).to(device),
        torch.zeros(pad, dtype=torch.int32, device=device)])
    return wt, ct


def merge_counted(words_list: Sequence[np.ndarray],
                  counts_list: Sequence[np.ndarray], device="cuda"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Union-merge keyed count sets, summing the counts of equal keys.
    Returns the sorted unique (words uint32 (m, W), counts int64).

    From DEVICE_MIN_ROWS rows on, one merge_unique_blocks on `device`; below
    it the JAX package's numpy merge (lexsort and reduceat). Counts enter
    the merge clipped to int32, as in JAX."""
    dev = resolve_device(device)
    total = sum(len(c) for c in counts_list)
    if total < DEVICE_MIN_ROWS:
        return _merge_np(words_list, counts_list)
    counts = np.concatenate(
        [np.minimum(c, 0x7FFFFFFF).astype(np.int32) for c in counts_list])
    merged = merge_unique_blocks(
        *pad_counted(np.concatenate(list(words_list)), counts, dev))
    n = int(merged["nuniq"])
    words = np.stack([w[:n].cpu().numpy().astype(np.uint32)
                      for w in merged["seg_words"]], axis=1)
    return words, merged["seg_counts"][:n].cpu().numpy().astype(np.int64)
