"""Bounded-memory windowed streaming over sorted .ktab file-sets.

N KmerStreams advance in lockstep through keyspace windows aligned at pivot
keys: every window materializes at most nstreams * window entries, however
large the tables (human-scale tables are 40-50 GB loaded whole — reference
README.md). This is the TPU framework's analog of the reference's
GoTo_Kmer_Entry-aligned N-way merges (Fastmerge.c:168-450 table_thread;
Logex.c:1403-1478 streaming evaluation), windowed-vectorized instead of
entry-at-a-time — per window each stream does one binary search and one
memmap range read, and all combining is numpy over the window.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from fastk_tpu_torch.formats.ktab import KmerStream

DEFAULT_WINDOW = 1 << 20  # entries per stream per window


def key_at(s: KmerStream, i: int) -> bytes:
    """The full packed key of entry ordinal i (position-preserving)."""
    save = s.idx
    s.goto_index(i)
    packed, _ = s.current_entry()
    s.idx = save
    return bytes(packed)


def _first_geq(s: KmerStream, key: bytes) -> int:
    """Ordinal of the first entry >= key (position-preserving)."""
    save = s.idx
    s.goto_kmer(np.frombuffer(key, dtype=np.uint8))
    e = s.idx
    s.idx = save
    return e


def stream_window_ranges(
    streams: Sequence[KmerStream],
    window: int = DEFAULT_WINDOW,
    lo_key: Optional[bytes] = None,
    hi_key: Optional[bytes] = None,
) -> Iterator[List[Tuple[int, int]]]:
    """Yield aligned windows over the streams as per-stream (lo, hi) record
    ordinal ranges covering the same half-open key interval; successive
    windows tile the keyspace in order. Restricted to [lo_key, hi_key)
    when given.

    The window cut key is the min over streams of their key `window` entries
    ahead, so at least one stream consumes a full window per round and no
    round holds more than len(streams) * window entries.
    """
    for s in streams:
        if lo_key is not None:
            s.goto_kmer(np.frombuffer(lo_key, dtype=np.uint8))
        else:
            s.goto_index(0)
    if hi_key is not None:
        ends = [_first_geq(s, hi_key) for s in streams]
    else:
        ends = [s.nels for s in streams]

    while True:
        cands = []
        for s, end in zip(streams, ends):
            j = s.idx + window
            if j < end:
                cands.append(key_at(s, j))
        cut = min(cands) if cands else None

        ranges: List[Tuple[int, int]] = []
        for s, end in zip(streams, ends):
            e = end if cut is None else max(_first_geq(s, cut), s.idx)
            e = min(e, end)
            ranges.append((s.idx, e))
            s.goto_index(e)
        yield ranges
        if cut is None:
            return


def stream_windows(
    streams: Sequence[KmerStream],
    window: int = DEFAULT_WINDOW,
    lo_key: Optional[bytes] = None,
    hi_key: Optional[bytes] = None,
) -> Iterator[List[Tuple[np.ndarray, np.ndarray]]]:
    """Yield aligned windows over the streams: each item is a list with one
    (packed (m, kbyte) uint8, counts (m,) uint16) pair per stream (see
    stream_window_ranges for the alignment rule)."""
    for ranges in stream_window_ranges(streams, window, lo_key, hi_key):
        yield [s.read_range(lo, hi)
               for s, (lo, hi) in zip(streams, ranges)]


def _universe_of(chunk: Sequence[Tuple[np.ndarray, np.ndarray]], kb: int):
    """Sorted unique keys of a window as an S{kb} view, exploiting that
    every stream's keys are ALREADY sorted: pairwise searchsorted merges
    (O(n log n) binary searches, no argsort — the windows come from sorted
    .ktab parts, so a comparison sort here would redo known work)."""
    views = [np.ascontiguousarray(p).view(f"S{kb}").ravel()
             for p, _ in chunk if len(p)]
    if not views:
        return None
    acc = views[0]
    for v in views[1:]:
        pa = np.arange(len(acc)) + np.searchsorted(v, acc, side="left")
        pb = np.arange(len(v)) + np.searchsorted(acc, v, side="right")
        out = np.empty(len(acc) + len(v), dtype=acc.dtype)
        out[pa] = acc
        out[pb] = v
        acc = out
    if len(acc) > 1:
        keep = np.empty(len(acc), bool)
        keep[0] = True
        np.not_equal(acc[1:], acc[:-1], out=keep[1:])
        acc = acc[keep]
    return acc


def window_union(
    chunk: Sequence[Tuple[np.ndarray, np.ndarray]], kb: int
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Union of one window's k-mers + per-stream aligned int64 count vectors
    (0 where absent) — merge_universe over a window. Native k-way merge
    when available, searchsorted-merge numpy fallback."""
    from fastk_tpu_torch import native

    res = native.union_slots([p for p, _ in chunk], kb)
    if res is not None:
        uni, slots = res
        cvecs = []
        for (_, c), sl in zip(chunk, slots):
            vec = np.zeros(len(uni), np.int64)
            vec[sl] = c
            cvecs.append(vec)
        return uni, cvecs

    uni = _universe_of(chunk, kb)
    if uni is None:
        return np.zeros((0, kb), np.uint8), [np.zeros(0, np.int64)
                                             for _ in chunk]
    cvecs = []
    for p, c in chunk:
        vec = np.zeros(len(uni), np.int64)
        if len(p):
            view = np.ascontiguousarray(p).view(f"S{kb}").ravel()
            vec[np.searchsorted(uni, view)] = c
        cvecs.append(vec)
    return uni.view(np.uint8).reshape(-1, kb), cvecs


def _merge_sum(va, ca, vb, cb):
    """Merge two sorted-unique (keys, counts) pairs, summing counts of
    shared keys. Because both inputs are unique, equal-key runs in the
    merged order have length <= 2, so the duplicate's count folds into its
    kept predecessor with plain fancy indexing (no add.at)."""
    pa = np.arange(len(va)) + np.searchsorted(vb, va, side="left")
    pb = np.arange(len(vb)) + np.searchsorted(va, vb, side="right")
    n = len(va) + len(vb)
    mv = np.empty(n, dtype=va.dtype)
    mc = np.empty(n, dtype=np.int64)
    mv[pa] = va
    mv[pb] = vb
    mc[pa] = ca
    mc[pb] = cb
    keep = np.empty(n, bool)
    keep[0] = True
    np.not_equal(mv[1:], mv[:-1], out=keep[1:])
    out_v = mv[keep]
    out_c = mc[keep]
    di = np.flatnonzero(~keep)
    if len(di):
        oidx = np.cumsum(keep) - 1
        out_c[oidx[di]] += mc[di]
    return out_v, out_c


def window_sum(
    chunk: Sequence[Tuple[np.ndarray, np.ndarray]], kb: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Union of one window's k-mers with per-key count SUMS (the fastmerge
    combine, reference Fastmerge.c table_thread): native k-way merge when
    available, else a pairwise merge-sum fold over the sorted streams."""
    from fastk_tpu_torch import native

    res = native.merge_sum_rows([p for p, _ in chunk],
                                [c for _, c in chunk], kb)
    if res is not None:
        return res

    pairs = [(np.ascontiguousarray(p).view(f"S{kb}").ravel(),
              c.astype(np.int64)) for p, c in chunk if len(p)]
    if not pairs:
        return np.zeros((0, kb), np.uint8), np.zeros(0, np.int64)
    va, ca = pairs[0]
    for vb, cb in pairs[1:]:
        va, ca = _merge_sum(va, ca, vb, cb)
    return va.view(np.uint8).reshape(-1, kb), ca
