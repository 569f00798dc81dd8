"""Device-side counting of canonical k-mers, in torch ops: key sort, segment
reduction, per-batch uniques, their merge, and the histogram job.

Port of ``fastk_tpu/ops/count.py``. The JAX code avoids scatter and gather
for their cost on the TPU; here scatter, gather and bincount are used freely
and only the outputs match. Key words are int64 tensors holding 32-bit
values (see ops/kmers.py); the port does not narrow the last word, since a
sort key here is a packed int64 whatever the word width.

unique_batch and merge_unique_blocks do not wait for the device: their
counts come back as device tensors, so the pipeline's host work on the next
batch overlaps the device work.
"""

from __future__ import annotations

import torch

from fastk_tpu.formats.hist import HIST_HIGH
from fastk_tpu_torch.ops.kmers import canonical_kmers

ONES = 0xFFFFFFFF  # an invalid record or an empty slot: all-ones in every word
_SIGN = -(1 << 63)  # XOR with the sign bit makes signed order unsigned order


def fold_invalid(words, invalid):
    """Encode invalid records as all-ones keys, which sort last.

    A canonical key is never all-ones: the reverse complement of T^k is A^k,
    which is smaller."""
    return tuple(torch.where(invalid, ONES, w) for w in words)


def is_invalid_key(words) -> torch.Tensor:
    m = words[0] == ONES
    for w in words[1:]:
        m &= w == ONES
    return m


def _packed_keys(words):
    """Words -> int64 sort keys, most significant first: two 32-bit words a
    key, the sign bit flipped so that torch's signed order is the unsigned
    one. A lone last word is non-negative and needs no flip."""
    keys = []
    for i in range(0, len(words), 2):
        if i + 1 < len(words):
            keys.append(((words[i] << 32) | words[i + 1]) ^ _SIGN)
        else:
            keys.append(words[i])
    return keys


def _unpacked_words(keys, W: int):
    words = []
    for key in keys:
        if len(words) + 1 < W:
            key = key ^ _SIGN
            words.append((key >> 32) & ONES)
            words.append(key & ONES)
        else:
            words.append(key)
    return tuple(words)


def sort_keys(words, values=()):
    """Sort records by their key words, ascending, carrying `values`.

    Returns (sorted words, sorted values). torch.sort takes one key, so the
    words are packed two to an int64 key and sorted least significant key
    first, each later pass stable (k <= 32: one pass; k = 40: two)."""
    keys = _packed_keys(words)
    s_key, perm = torch.sort(keys[-1])
    s_keys = [s_key]
    for key in reversed(keys[:-1]):
        s_key, p2 = torch.sort(key[perm], stable=True)
        perm = perm[p2]
        s_keys = [s_key] + [k_[p2] for k_ in s_keys]
    return (_unpacked_words(s_keys, len(words)),
            tuple(v[perm] for v in values))


def run_starts(s_words) -> torch.Tensor:
    """bool [size]: True where a sorted record's key differs from the one
    before it; record 0 always starts a run."""
    starts = torch.ones(s_words[0].numel(), dtype=torch.bool,
                        device=s_words[0].device)
    diff = s_words[0][1:] != s_words[0][:-1]
    for w in s_words[1:]:
        diff |= w[1:] != w[:-1]
    starts[1:] = diff
    return starts


def segment_reduce(s_words, weights=None):
    """Segment statistics over sorted (invalid-folded) key words.

    weights: per-record int32 weights summed per segment (None: run length).

    Returns dict(nseg int64 scalar tensor — number of segments, the trailing
    all-ones block being one of them; seg_counts int32 [size] — slot j holds
    segment j's sum, 0 beyond nseg; seg_words — tuple of int64 [size], slot j
    holds segment j's key, all-ones beyond nseg)."""
    size = s_words[0].numel()
    dev = s_words[0].device
    starts = run_starts(s_words)
    slot = torch.cumsum(starts, 0) - 1  # segment of each record
    nseg = slot[-1] + 1
    idx = torch.arange(size, device=dev)
    # record index of each segment's start, size beyond nseg (one dump slot)
    seg_start = torch.full((size + 1,), size, dtype=torch.int64, device=dev)
    seg_start[torch.where(starts, slot, size)] = idx
    seg_start[size] = size  # the dump slot doubles as the last end bound
    if weights is None:
        bounds = seg_start
    else:
        bounds = torch.cat([weights.new_zeros(1, dtype=torch.int64),
                            torch.cumsum(weights, 0, dtype=torch.int64)])
        bounds = bounds[seg_start]
    seg_counts = (bounds[1:] - bounds[:-1]).to(torch.int32)
    seg_start = seg_start[:size]
    in_seg = idx < nseg
    src = torch.clamp(seg_start, max=size - 1)
    seg_words = tuple(torch.where(in_seg, w[src], ONES) for w in s_words)
    return dict(nseg=nseg, seg_counts=seg_counts, seg_words=seg_words)


def hist_batch(codes: torch.Tensor, k: int, size: int):
    """The histogram job for one code stream (``FastK -k``).

    Returns dict(hist int64 [32768] — hist[c] = unique canonical k-mers with
    count c clipped at 32767, hist[0] = 0; nvalid int — valid k-mer
    instances). The host computes the instance overflow as
    nvalid - sum(c * hist[c]). On CUDA the histogram is the run-length kernel
    of ops/histker.py."""
    from fastk_tpu_torch.ops.histker import hist_device_part, run_hist

    start_words, valid_end = hist_device_part(codes, k, size)
    hist, nvalid = run_hist(start_words, valid_end)
    return dict(hist=hist, nvalid=nvalid)


def unique_batch(codes: torch.Tensor, k: int, size: int):
    """Sorted unique canonical k-mers of one code stream, with counts.

    Returns dict(seg_words tuple of int64 [size] — slot j = j-th unique key,
    all-ones beyond; seg_counts int32 [size]; nseg, nuniq and nvalid as int64
    scalar tensors — nseg includes a trailing invalid segment, nuniq does
    not)."""
    words, invalid = canonical_kmers(codes, k, size)
    ninv = invalid.sum()
    s_words, _ = sort_keys(fold_invalid(words, invalid))
    del words, invalid
    seg = segment_reduce(s_words)
    nuniq = seg["nseg"] - (ninv > 0).to(torch.int64)
    real = torch.arange(size, device=codes.device) < nuniq
    return dict(
        seg_words=tuple(torch.where(real, w, ONES) for w in seg["seg_words"]),
        seg_counts=torch.where(real, seg["seg_counts"], 0),
        nseg=seg["nseg"], nuniq=nuniq, nvalid=size - ninv)


def merge_unique_blocks(words, counts):
    """Merge concatenated per-batch unique blocks into global sorted uniques.

    words: tuple of W int64 [size] (all-ones = empty slot); counts int32
    [size] (0 at empty slots). Returns dict(seg_words, seg_counts — the same
    layout, globally deduplicated; nuniq int64 scalar tensor; hist int64
    [32768] — the histogram of merged counts clipped at 32767)."""
    size = counts.numel()
    s_words, (s_counts,) = sort_keys(words, (counts,))
    seg = segment_reduce(s_words, weights=s_counts)
    del s_words, s_counts
    slot = torch.arange(size, device=counts.device)
    real = ((slot < seg["nseg"]) & ~is_invalid_key(seg["seg_words"])
            & (seg["seg_counts"] > 0))
    seg_counts = torch.where(real, seg["seg_counts"], 0)
    vals = torch.where(real, torch.clamp(seg_counts, max=HIST_HIGH),
                       HIST_HIGH + 1)
    hist = torch.bincount(vals, minlength=HIST_HIGH + 2)[: HIST_HIGH + 1]
    return dict(
        seg_words=tuple(torch.where(real, w, ONES) for w in seg["seg_words"]),
        seg_counts=seg_counts, nuniq=real.sum(), hist=hist)
