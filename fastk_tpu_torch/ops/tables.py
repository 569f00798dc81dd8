"""Sorted-table operations on the device: the operands of a merge of counted
key rows, the union-merge of counted key sets, and the sort of counted rows.

Port of ``fastk_tpu/ops/tables.py``. Keys are host (n, W) uint32 word rows
(ops/kmers.py packing); on the device they become W int64 word tensors,
crossing as their int32 bits (convert.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from fastk_tpu_torch.convert import fetch, words_from_numpy, words_to_numpy
from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.count import ONES, merge_unique_blocks, sort_keys

DEVICE_MIN_ROWS = 1 << 20  # below this, numpy beats the transfers


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
    wt = tuple(torch.cat([w, torch.full((pad,), ONES, dtype=torch.int64,
                                        device=device)])
               for w in words_from_numpy(words.T, device))
    ct = torch.cat([
        torch.from_numpy(np.asarray(counts).astype(np.int32)).to(device),
        torch.zeros(pad, dtype=torch.int32, device=device)])
    return wt, ct


def _merge_np(words_list, counts_list):
    W = words_list[0].shape[1]
    allw = np.concatenate(list(words_list)) if words_list else \
        np.zeros((0, W), np.uint32)
    allc = np.concatenate([c.astype(np.int64) for c in counts_list]) if \
        counts_list else np.zeros(0, np.int64)
    if len(allc) == 0:
        return allw, allc
    be = np.ascontiguousarray(allw.astype(">u4")).view(f"S{4 * W}").ravel()
    order = np.argsort(be, kind="stable")
    sw, sc, sv = allw[order], allc[order], be[order]
    starts = np.ones(len(sv), bool)
    starts[1:] = sv[1:] != sv[:-1]
    idx = np.flatnonzero(starts)
    return sw[idx], np.add.reduceat(sc, idx)


def merge_counted(words_list: Sequence[np.ndarray],
                  counts_list: Sequence[np.ndarray], device="cuda"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Union-merge keyed count sets, summing the counts of equal keys.
    Returns the sorted unique (words uint32 (m, W), counts int64).

    From DEVICE_MIN_ROWS rows on, one merge_unique_blocks on `device`; below
    it the numpy merge (a stable sort of the big-endian key bytes and
    reduceat), copied from the JAX package. Counts enter
    the merge clipped to int32, as in JAX."""
    dev = resolve_device(device)
    total = sum(len(c) for c in counts_list)
    if total < DEVICE_MIN_ROWS:
        return _merge_np(words_list, counts_list)
    counts = np.concatenate(
        [np.minimum(c, 0x7FFFFFFF).astype(np.int32) for c in counts_list])
    merged = merge_unique_blocks(
        *pad_counted(np.concatenate(list(words_list)), counts, dev))
    n = int(fetch(merged["nuniq"], "merge_counted_nuniq"))
    rec = words_to_numpy(merged["seg_words"] + (merged["seg_counts"],), n)
    return np.ascontiguousarray(rec[:-1].T), rec[-1].astype(np.int64)


def sort_counted(words: np.ndarray, counts: np.ndarray, device="cuda"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Sort (words, counts) rows by key, without dedup (Symmex's core op).

    From DEVICE_MIN_ROWS rows on, sort_keys on `device` (torch.sort over
    the keys packed two words to an int64, as merge_counted's merge packs
    them) gives the order, and the host gathers the rows by it; below it a
    stable numpy argsort of the big-endian key bytes, copied from the JAX
    package. On the device the order of equal keys is unspecified, as in
    JAX: callers' keys are distinct (a canonical table never holds both x
    and rc(x))."""
    dev = resolve_device(device)
    n = len(counts)
    W = words.shape[1]
    if n < DEVICE_MIN_ROWS:
        be = np.ascontiguousarray(words.astype(">u4")).view(f"S{4 * W}").ravel()
        order = np.argsort(be, kind="stable")
        return words[order], counts[order]
    wt = words_from_numpy(words.T, dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    _, (order,) = sort_keys(wt, (idx,))
    order = order.cpu().numpy()
    return words[order], counts[order]
