"""Device-side counting of canonical k-mers, in torch ops: key sort, segment
reduction, per-batch uniques and their merge, the histogram job, the fused
single-batch count with per-position counts, the -t table compaction and
the sort-merge join of positions against a table (profiles).

Port of ``fastk_tpu/ops/count.py``. The JAX code avoids scatter and gather
for their cost on the TPU; here scatter, gather, cumsum and bincount are used
freely and only the outputs match. Key words are int64 tensors holding 32-bit
values (see ops/kmers.py); the port does not narrow the last word, since a
sort key here is a packed int64 whatever the word width. Clipped counts
(at most 32767) that go back to the host ride as int16 (ops/pack.py
fetch_u16).

unique_batch and merge_unique_blocks return their counts as device tensors,
so the pipeline's host work on the next batch overlaps the device work:
unique_batch queues a whole slice without the host waiting for the card.
merge_unique_blocks' torch.bincount reads its values' extremes on the host,
and count_batch waits for the number of valid positions that the run-length
kernel needs.
"""

from __future__ import annotations

import torch

from fastk_tpu_torch import trace
from fastk_tpu_torch.convert import fetch
from fastk_tpu_torch.formats.hist import HIST_HIGH
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
    holds segment j's key, all-ones beyond nseg). Does not wait for the
    device."""
    size = s_words[0].numel()
    dev = s_words[0].device
    starts = run_starts(s_words)
    slot = torch.cumsum(starts, 0) - 1  # segment of each record
    nseg = slot[-1] + 1
    idx = torch.arange(size, device=dev)
    # record index of each segment's start, size beyond nseg: slot size
    # keeps its fill as the last end bound, and size + 1 is the dump slot
    seg_start = torch.full((size + 2,), size, dtype=torch.int64, device=dev)
    seg_start[torch.where(starts, slot, size + 1)] = idx
    bounds = seg_start[: size + 1]
    if weights is not None:
        bounds = torch.cat([weights.new_zeros(1, dtype=torch.int64),
                            torch.cumsum(weights, 0, dtype=torch.int64)]
                           )[bounds]
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


def _sorted_keys(codes: torch.Tensor, k: int, size: int, values=()):
    """Canonical keys of a code stream, invalid windows folded to all-ones,
    sorted and carrying `values`. Returns (s_words, s_values, ninv)."""
    words, invalid = canonical_kmers(codes, k, size)
    ninv = invalid.sum()
    s_words, s_values = sort_keys(fold_invalid(words, invalid), values)
    return s_words, s_values, ninv


def _uniques(s_words, ninv: torch.Tensor, size: int):
    seg = segment_reduce(s_words)
    nuniq = seg["nseg"] - (ninv > 0).to(torch.int64)
    real = torch.arange(size, device=ninv.device) < nuniq
    return dict(
        seg_words=tuple(torch.where(real, w, ONES) for w in seg["seg_words"]),
        seg_counts=torch.where(real, seg["seg_counts"], 0),
        nseg=seg["nseg"], nuniq=nuniq, nvalid=size - ninv)


def unique_batch(codes: torch.Tensor, k: int, size: int):
    """Sorted unique canonical k-mers of one code stream, with counts.

    Returns dict(seg_words tuple of int64 [size] — slot j = j-th unique key,
    all-ones beyond; seg_counts int32 [size]; nseg, nuniq and nvalid as int64
    scalar tensors — nseg includes a trailing invalid segment, nuniq does
    not). Traced: the span dedup."""
    with trace.span("dedup"):
        s_words, _, ninv = _sorted_keys(codes, k, size)
        return _uniques(s_words, ninv, size)


def unique_batch_inst(codes: torch.Tensor, k: int, size: int):
    """unique_batch plus the sorted instance stream: the same key sort also
    carries each record's position.

    Extra keys: s_words (folded key words, ascending, the invalid all-ones
    records last) and s_pos (int32 position of each sorted record). The
    multi-batch profile pass joins this stream against the merged table
    (profile_join_inst) with no re-upload and no canonical recompute.
    Traced: the span dedup."""
    with trace.span("dedup"):
        pos = torch.arange(size, dtype=torch.int32, device=codes.device)
        s_words, (s_pos,), ninv = _sorted_keys(codes, k, size, (pos,))
        out = _uniques(s_words, ninv, size)
    out.update(s_words=s_words, s_pos=s_pos)
    return out


def compact_table_min(words, counts, tmin: int):
    """Keep the entries with count >= tmin, in key order, counts clipped at
    32767 (the -t<min> table, filtered before it crosses to the host).

    words: tuple of int64 [n] sorted keys; counts int32 [n]. Returns
    dict(words, counts — kept entries first, all-ones / 0 after them;
    nkeep — int64 scalar tensor). Does not wait for the device."""
    n = counts.numel()
    keep = counts >= tmin
    dest = torch.where(keep, torch.cumsum(keep, 0) - 1, n)  # n: dump slot
    out_words = []
    for w in words:
        o = torch.full((n + 1,), ONES, dtype=w.dtype, device=w.device)
        o[dest] = w
        out_words.append(o[:n])
    c = torch.zeros(n + 1, dtype=torch.int32, device=counts.device)
    c[dest] = torch.clamp(counts, max=HIST_HIGH).to(torch.int32)
    return dict(words=tuple(out_words), counts=c[:n], nkeep=keep.sum())


def merge_unique_blocks(words, counts, want_back: bool = False):
    """Merge concatenated per-batch unique blocks into global sorted uniques.

    words: tuple of W int64 [size] (all-ones = empty slot); counts int32
    [size] (0 at empty slots). Returns dict(seg_words, seg_counts — the same
    layout, globally deduplicated; nuniq int64 scalar tensor; hist int64
    [32768] — the histogram of merged counts clipped at 32767).

    want_back: also return rec_counts, int32 [size] — each input record's
    merged count clipped at 32767, in input order (0 at empty slots). The
    out-of-core profile pass reads its instances' counts from it. The input
    index rides the sort; each sorted record gathers its segment's total by
    its segment index (the running count of run starts), and a scatter by
    the input index puts the totals back in input order.

    Traced: the span merge, and the wait bincount (torch.bincount on the
    card reads its values' least and greatest on the host)."""
    with trace.span("merge"):
        return _merge_unique_blocks(words, counts, want_back)


def _merge_unique_blocks(words, counts, want_back):
    size = counts.numel()
    values = (counts,)
    if want_back:
        values += (torch.arange(size, dtype=torch.int32,
                                device=counts.device),)
    s_words, s_values = sort_keys(words, values)
    seg = segment_reduce(s_words, weights=s_values[0])
    rec_counts = None
    if want_back:
        seg_of = torch.cumsum(run_starts(s_words), 0) - 1
        rec_counts = positions_inverse(
            s_values[1], torch.clamp(seg["seg_counts"][seg_of], max=HIST_HIGH))
        del seg_of
    del s_words, s_values
    slot = torch.arange(size, device=counts.device)
    real = ((slot < seg["nseg"]) & ~is_invalid_key(seg["seg_words"])
            & (seg["seg_counts"] > 0))
    seg_counts = torch.where(real, seg["seg_counts"], 0)
    vals = torch.where(real, torch.clamp(seg_counts, max=HIST_HIGH),
                       HIST_HIGH + 1)
    with trace.wait("bincount"):
        hist = torch.bincount(vals, minlength=HIST_HIGH + 2)[: HIST_HIGH + 1]
    out = dict(
        seg_words=tuple(torch.where(real, w, ONES) for w in seg["seg_words"]),
        seg_counts=seg_counts, nuniq=real.sum(), hist=hist)
    if want_back:
        out["rec_counts"] = rec_counts
    return out


def fill_forward(markers: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """out[i] = values[j] at the largest j <= i with markers[j] (-1 if none).

    The marked values are scattered to one slot per marker and gathered back
    by the running marker count: a cumsum, a scatter and a gather. (A
    running max of marked indices, torch.cummax, took ~200 ms at 2^26 on an
    H100, against under 1 ms for a cumsum.)"""
    n = markers.numel()
    seg = torch.cumsum(markers, 0) - 1  # the last marker at or before i
    at = values.new_full((n + 1,), -1)
    at[torch.where(markers, seg, n)] = values  # n: dump slot
    return torch.where(seg >= 0, at[torch.clamp(seg, min=0)], -1)


def next_start_after(starts: torch.Tensor) -> torch.Tensor:
    """out[i] = the smallest start index strictly greater than i (size if
    none): the start of the segment after i's, by a cumsum, a scatter and a
    gather."""
    size = starts.numel()
    seg = torch.cumsum(starts, 0) - 1
    first = torch.full((size + 2,), size, dtype=torch.int64,
                       device=starts.device)
    first[torch.where(starts, seg, size + 1)] = torch.arange(
        size, device=starts.device)  # size + 1: dump slot
    return first[seg + 1]


def positions_inverse(pos: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """`values` reordered to position order: out[pos[i]] = values[i] (pos
    is a permutation of [0, n))."""
    out = torch.empty_like(values)
    out[pos.long()] = values
    return out


def segmented_count(s_words, want_elem_counts: bool = False,
                    want_hist: bool = False, weights=None):
    """Segment statistics over sorted, invalid-folded key words.

    Returns dict(seg_words, seg_counts — slot j = j-th segment in key order,
    the trailing invalid segment included, all-ones / 0 beyond nseg;
    seg_valid bool [size]; nseg int64 scalar tensor; overflow — instances
    beyond 32767 in valid segments[, hist int64 [32768]][, elem_counts int32
    [size] — each sorted record's segment count clipped at 32767, 0 for
    invalid records]). The histogram is the run-length kernel over the
    packed run starts (ops/histker.py run_hist), which waits once for the
    number of valid records.

    weights: int32 per-record weights summed per segment instead of run
    lengths (the receive side of the multi-device exchange of locally
    deduplicated records, parallel/dist.py). The histogram then bins the
    clipped segment sums with bincount, as JAX's bincount_by_sort does: run
    lengths are not the counts."""
    if want_elem_counts and weights is not None:
        raise ValueError("elem_counts are run lengths; pass no weights")
    size = s_words[0].numel()
    seg = segment_reduce(s_words, weights=weights)
    slot = torch.arange(size, device=s_words[0].device)
    seg_valid = (slot < seg["nseg"]) & ~is_invalid_key(seg["seg_words"])
    seg_counts = seg["seg_counts"]
    overflow = torch.where(seg_valid & (seg_counts > HIST_HIGH),
                           seg_counts - HIST_HIGH, 0).sum()
    out = dict(seg_words=seg["seg_words"], seg_counts=seg_counts,
               seg_valid=seg_valid, nseg=seg["nseg"], overflow=overflow)
    rec_invalid = is_invalid_key(s_words)
    if want_hist and weights is not None:
        vals = torch.where(seg_valid, torch.clamp(seg_counts, max=HIST_HIGH),
                           HIST_HIGH + 1)
        out["hist"] = torch.bincount(
            vals, minlength=HIST_HIGH + 2)[: HIST_HIGH + 1]
    elif want_hist:
        from fastk_tpu_torch.ops.histker import run_hist, start_words

        valid_end = size - int(fetch(rec_invalid.sum(), "count_invalid"))
        out["hist"], _ = run_hist(start_words(s_words, valid_end), valid_end)
    if want_elem_counts:
        starts = run_starts(s_words)
        start_len = torch.clamp(next_start_after(starts) - slot, max=HIST_HIGH)
        elem = torch.clamp(fill_forward(starts, start_len), min=0)
        out["elem_counts"] = torch.where(rec_invalid, 0, elem).to(torch.int32)
    return out


def count_batch(codes: torch.Tensor, k: int, size: int, want_positions: bool,
                want_hist: bool = False):
    """Count the canonical k-mers of one code stream: the fused single batch
    of the -t -p jobs.

    Returns segmented_count's dict plus nvalid (int64 scalar tensor) and,
    with want_positions, pos_counts int16 [size] — the clipped count of the
    k-mer that starts at each position, 0 at invalid positions."""
    values = ((torch.arange(size, dtype=torch.int32, device=codes.device),)
              if want_positions else ())
    s_words, s_values, ninv = _sorted_keys(codes, k, size, values)
    out = segmented_count(s_words, want_elem_counts=want_positions,
                          want_hist=want_hist)
    out["nvalid"] = size - ninv
    if want_positions:
        elem = out.pop("elem_counts").to(torch.int16)
        out["pos_counts"] = positions_inverse(s_values[0], elem)
    return out


def _join_counts(table_words, table_counts, q_folded, q_pos=None):
    """Sort-merge join: the clipped table count of each query key, 0 where
    the key is absent or all-ones, as int16 [size] in position order.

    Table entries and queries are sorted together by (words..., pos'), pos'
    being 0 for a table entry and i+1 for the query at position i (q_pos[i]
    when given: the instance stream arrives in key order). So a table entry
    leads its key's segment and its count reaches the whole segment by
    fill_forward, while a segment that starts with a query (an absent key)
    gets 0. All-ones queries meet no table entry but the table's all-ones
    empty slots, whose count is 0. pos' rides the sort as one more key
    word, which for even W costs no extra sort pass. The scatter by pos'
    then puts the counts in position order; slot 0 takes the table
    entries' and is dropped."""
    W = len(table_words)
    A = table_counts.numel()
    size = q_folded[0].numel()
    dev = q_folded[0].device
    qp = (torch.arange(size, device=dev) if q_pos is None
          else q_pos.to(torch.int64))
    pos = torch.cat([torch.zeros(A, dtype=torch.int64, device=dev), qp + 1])
    merged = tuple(torch.cat([tw, qw]) for tw, qw in zip(table_words, q_folded))
    cnt = torch.cat([torch.clamp(table_counts, max=HIST_HIGH).to(torch.int16),
                     torch.zeros(size, dtype=torch.int16, device=dev)])
    s_keys, (s_cnt,) = sort_keys(merged + (pos,), (cnt,))
    del merged, pos, cnt
    elem = torch.clamp(fill_forward(run_starts(s_keys[:W]), s_cnt), min=0)
    out = torch.zeros(size + 1, dtype=torch.int16, device=dev)
    out[s_keys[W]] = elem
    return out[1:]


def profile_join(table_words, table_counts, codes: torch.Tensor, k: int,
                 size: int):
    """Per-position clipped counts of a code stream against a sorted table
    (see _join_counts); invalid positions get 0.

    table_words: tuple of W int64 [A], sorted unique keys (all-ones at empty
    slots); table_counts: int32 [A], 0 at empty slots. Traced: the span
    join."""
    with trace.span("join"):
        words, invalid = canonical_kmers(codes, k, size)
        return _join_counts(table_words, table_counts,
                            fold_invalid(words, invalid))


def profile_join_keys(table_words, table_counts, q_words):
    """Join query key words, already invalid-folded, against a sorted
    table: clipped int16 counts in query order (see _join_counts)."""
    return _join_counts(table_words, table_counts, q_words)


def profile_join_inst(table_words, table_counts, s_words, s_pos):
    """Join a batch's retained sorted instance stream (unique_batch_inst's
    s_words and s_pos) against a sorted table: clipped int16 counts in
    position order. Traced: the span join."""
    with trace.span("join"):
        return _join_counts(table_words, table_counts, s_words, q_pos=s_pos)
