"""The in-core counting job end to end: host ingest, device count, and the
.hist, .ktab and .prof outputs.

Port of ``fastk_tpu/pipeline/count.py``:

- one batch of at most MAX_DEVICE_POSITIONS positions, histogram only:
  ``hist_batch`` (keys, sort, run starts, the run-length kernel);
- one such batch with profiles (``-p``, with or without ``-t``):
  ``count_batch``, whose one sort gives the histogram (the run-length
  kernel again), the table and the per-position counts;
- anything else: ``unique_batch`` on every device slice, the compacted blocks
  kept on the device, then one ``merge_unique_blocks`` whose histogram is
  the job's and whose uniques are the table (``compact_table_min`` for
  ``-t`` above 1). Profiles then join every position against the merged
  table: from the sorted instance stream kept on the device while it fits
  the ``FASTK_TPU_INST_HBM`` budget (``unique_batch_inst``,
  ``profile_join_inst``), else by uploading the batch's packed codes again
  (``profile_join``);
- ``-p:<table>`` (relative_table): no counting pass, only the join.

A device slice's codes go to the device as bytes on their first trip
(``device_codes``). The host packs a slice 2 bits a base only where it keeps
the packed form for a second upload: a ``-p`` batch whose instance streams do
not all fit the budget, and every batch of ``-p:<table>``.

Host reading, packing and the file formats (``fastk_tpu_torch.io.reader``,
``fastk_tpu_torch.formats``, the native packer and profile encoder) are the
port's copies of the JAX package's, which write the same bytes.

A job that keeps nothing per batch for a later pass (neither profiles nor a
relative table: the histogram and -t jobs) reads its input in batches of at
most one device slice, so the card counts slice i while the reader reads
slice i+1; the first two batches are read before the first slice is queued,
since they decide whether the job is one batch. Each slice is queued whole
without the host waiting for the card, and its counts are fetched one slice
later. A -p job reads batches of batch_bases, since its instance budget,
packed store and profile encode are decided a batch; its slices' device work
overlaps the packing of the kept slices, and in the profile pass batch
i+1's join overlaps batch i's fetch and encode.
"""

from __future__ import annotations

import itertools
import os
import tempfile
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from fastk_tpu_torch import trace
from fastk_tpu_torch.formats.hist import HIST_HIGH, Histogram
from fastk_tpu_torch.formats.ktab import KmerTable, write_ktab
from fastk_tpu_torch.formats.prof import ProfWriter, encode_profiles_bulk
from fastk_tpu_torch.io.reader import ReadBatch, batched_reads
from fastk_tpu_torch.convert import (
    device_codes,
    fetch,
    fetch_async,
    fetch_u16,
    words_from_numpy,
    words_to_numpy,
)
from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.count import (
    ONES,
    compact_table_min,
    count_batch,
    hist_batch,
    merge_unique_blocks,
    profile_join,
    profile_join_inst,
    unique_batch,
    unique_batch_inst,
)
from fastk_tpu_torch.ops.kmers import (
    nwords,
    packed_to_words,
    pad_needed,
    words_to_packed,
)
from fastk_tpu_torch.ops.pack import pack_stream_words, upload_packed

DEFAULT_BATCH_BASES = 64 << 20  # bases per device batch
_MIN_SIZE = 1 << 15
# positions per device call: a longer batch (or read) is counted in slices of
# this many k-mer start positions, each carrying the k-1 halo after it
MAX_DEVICE_POSITIONS = 1 << 26
# device bytes of retained sorted instance streams, over all batches
DEFAULT_INST_HBM = 4 << 30


def _round_size(n: int, k: int) -> int:
    """Device size for a batch of n codes: the next power of two (at least
    32768), at most MAX_DEVICE_POSITIONS."""
    want = n + pad_needed(k)
    size = _MIN_SIZE
    while size < want:
        size <<= 1
    return min(size, MAX_DEVICE_POSITIONS)


def _pad_codes(batch: ReadBatch, k: int, size: int) -> np.ndarray:
    codes = np.full(size + pad_needed(k), 4, dtype=np.uint8)
    codes[: len(batch.codes)] = batch.codes
    return codes


def _slicing(n: int, k: int, max_size: int = MAX_DEVICE_POSITIONS):
    """(size, count) of the device slices of n codes: count windows of size
    start positions each, at least one."""
    size = min(_round_size(n, k), max_size)
    return size, max(1, -(-n // size))


def _code_slices(codes: np.ndarray, k: int,
                 max_size: int = MAX_DEVICE_POSITIONS):
    """Yield (offset, size, padded slice) windows of at most max_size start
    positions (_slicing); slice i covers the starts [offset, offset + size)
    and carries the k-1 halo after them, padded with code 4."""
    size, count = _slicing(len(codes), k, max_size)
    pad = pad_needed(k)
    for off in range(0, count * size, size):
        buf = np.full(size + pad, 4, dtype=np.uint8)
        chunk = codes[off: off + size + pad]
        buf[: len(chunk)] = chunk
        yield off, size, buf


def _trim(n: int) -> int:
    """Block slots to keep for n uniques (a multiple of 32768)."""
    return max(_MIN_SIZE, -(-n // _MIN_SIZE) * _MIN_SIZE)


def _inst_bytes(size: int, k: int) -> int:
    """Device bytes of unique_batch_inst's s_words and s_pos for one slice:
    W int64 words and one int32 position per record."""
    return size * (8 * nwords(k) + 4)


@dataclass
class CountOutput:
    kmer: int
    hist: Optional[Histogram]
    table: Optional[KmerTable]
    profiles: Optional[List[np.ndarray]]
    nreads: int
    totlen: int
    # set when the table was streamed to disk (table above is then None):
    # the number of entries written
    table_entries: Optional[int] = None
    nshort: int = 0  # reads shorter than k, which hold no k-mer


def _histogram(k: int, hist_bins: torch.Tensor, nvalid: int) -> Histogram:
    """The job's histogram; the instances lost to clipping at 32767 are
    nvalid - sum(c * hist[c]). Traced: part of the span merge, and the wait
    hist_bins."""
    with trace.span("merge"):
        bins = fetch(hist_bins, "hist_bins").astype(np.int64)
        overflow = nvalid - int(
            (bins[1:] * np.arange(1, HIST_HIGH + 1, dtype=np.int64)).sum())
        return Histogram.from_bins(k, bins, overflow)


def _profiles_from_meta(boff: np.ndarray, rlen: np.ndarray,
                        pos_counts: np.ndarray, k: int) -> List[np.ndarray]:
    profs = []
    for r in range(len(rlen)):
        o = int(boff[r])
        n = int(rlen[r]) - k + 1
        if n <= 0:
            profs.append(np.zeros(0, dtype=np.uint16))
        else:
            profs.append(pos_counts[o: o + n].astype(np.uint16))
    return profs


def _profiles_from_positions(batch: ReadBatch, pos_counts: np.ndarray, k: int
                             ) -> List[np.ndarray]:
    return _profiles_from_meta(batch.boff, batch.rlen, pos_counts, k)


def _device_table(table: KmerTable, k: int, dev: torch.device):
    """Host table -> device (words tuple of int64 [n], counts int32 [n]
    clipped at 32767). The join needs no padding: torch has no static
    shapes to keep. Traced: the span relative_table.upload, and the wait
    table_upload (the counts' copy from pageable memory blocks the host)."""
    with trace.span("relative_table.upload"):
        words = packed_to_words(table.packed, k)
        counts = np.minimum(table.counts, HIST_HIGH).astype(np.int32)
        t_words = words_from_numpy(words.T, dev)
        with trace.wait("table_upload"):
            return t_words, torch.from_numpy(counts).to(dev)


def _table_entries(k: int, table_min: int, words, counts: torch.Tensor,
                   n: int):
    """The -t<table_min> entries of the first n sorted unique keys and
    counts on the device, on the host: (packed keys, uint16 counts clipped
    at 32767). Above -t1 the entries are filtered on the device
    (compact_table_min), so only the kept ones cross to the host: at -t3
    most uniques are the error tail. Traced: the span table_out, and the
    waits table_nkeep and table_words."""
    with trace.span("table_out"):
        words, counts = tuple(w[:n] for w in words), counts[:n]
        if table_min > 1:
            kept = compact_table_min(words, counts, table_min)
            n = int(fetch(kept["nkeep"], "table_nkeep"))
            words, counts = kept["words"], kept["counts"]
        with trace.wait("table_words"):
            u_words = words_to_numpy(words, n).T
        return (words_to_packed(u_words, k),
                fetch_u16(torch.clamp(counts[:n], max=HIST_HIGH)))


def _table(k: int, table_min: int, words, counts: torch.Tensor, n: int,
           out_base: Optional[str], out_nparts: int):
    """The -t<table_min> table of the first n sorted unique keys and counts
    on the device (_table_entries): (in-memory KmerTable, or None when the
    .ktab was written to out_base; number of entries)."""
    tab = KmerTable(k, table_min, *_table_entries(k, table_min, words,
                                                  counts, n))
    if out_base is None:
        return tab, len(tab)
    with trace.span("ktab_write"):
        write_ktab(out_base, tab, nparts=out_nparts)
    return None, len(tab)


class _ProfSink:
    """Where finished per-batch position counts go: a streaming ProfWriter
    (out_base set: bounded memory) or an in-memory list of count arrays.
    Traced: the spans prof_out.encode (the encoder) and prof_out.write (the
    .prof writer)."""

    def __init__(self, k: int, out_base: Optional[str], out_nparts: int,
                 nreads: int):
        self.k = k
        self.profs: Optional[List[np.ndarray]] = None
        self._pw = None
        if out_base is not None:
            self._pw = ProfWriter(out_base, k, nreads,
                                  nparts=min(out_nparts, max(1, nreads)))
        else:
            self.profs = []

    def add_batch(self, boff: np.ndarray, rlen: np.ndarray,
                  pos_counts: np.ndarray) -> None:
        if self._pw is not None:
            plen = np.maximum(np.asarray(rlen) - self.k + 1, 0)
            with trace.span("prof_out.encode"):
                blob, offs = encode_profiles_bulk(
                    pos_counts.astype(np.uint16, copy=False),
                    np.asarray(boff[:-1]), plen)
            with trace.span("prof_out.write"):
                self._pw.add_block(blob, offs)
        else:
            self.profs.extend(
                _profiles_from_meta(boff, rlen, pos_counts, self.k))

    def close(self) -> None:
        if self._pw is not None:
            with trace.span("prof_out.write"):
                self._pw.close()


def count_files(
    paths: Sequence[str],
    k: int,
    table_min: Optional[int] = None,
    profiles: bool = False,
    hc: bool = False,
    bc: int = 0,
    batch_bases: int = DEFAULT_BATCH_BASES,
    relative_table: Optional[KmerTable] = None,
    verbose: bool = False,
    out_base: Optional[str] = None,
    out_nparts: int = 4,
    device="cuda",
) -> CountOutput:
    """Count the canonical k-mers of the given sequence files on `device`.

    table_min: build the table of k-mers seen at least this often (-t).
    profiles: per-read count profiles (-p). relative_table: take profiles
    against this table instead of the input's own counts (-p:<table>); no
    counting pass runs. hc: homopolymer-compress reads; bc: drop this many
    leading bases of each read.

    out_base: stream the .ktab and .prof file-sets to disk (out_nparts parts
    each) instead of returning them (table and profiles come back None,
    table_entries set). The histogram is always returned, never written.
    Traced: the counter count.slices_ahead, the device slices queued while
    the reader still had input to read."""
    dev = resolve_device(device)
    if not profiles and relative_table is None:
        # nothing is kept a batch: a batch is one device slice
        batch_bases = min(batch_bases, MAX_DEVICE_POSITIONS - pad_needed(k))
    gen = batched_reads(list(paths), batch_bases, hc=hc, bc=bc)
    first_two = [batch for batch, _ordinal in itertools.islice(gen, 2)]
    single = (len(first_two) == 1
              and len(first_two[0].codes) + pad_needed(k)
              <= MAX_DEVICE_POSITIONS)
    if single and profiles and relative_table is None:
        return _count_single_fused(first_two[0], k, table_min, verbose,
                                   out_base, out_nparts, dev)
    if (single and not profiles and table_min is None
            and relative_table is None):
        return _count_single_hist(first_two[0], k, verbose, dev)

    metas = []  # per batch: (boff, rlen, number of codes)
    # per batch: its slices (off, size, packed words, exceptions, codes
    # packed), the packed form kept only where the join uploads it again
    packed_store = []
    inst_store = []  # per batch: (off, size, s_words, s_pos) on the device
    inst_budget = int(os.environ.get("FASTK_TPU_INST_HBM", DEFAULT_INST_HBM))
    inst_bytes = 0
    blocks_words, blocks_counts = [], []
    nvalid_total = 0
    pending = None
    queued = ahead = 0  # slices queued; those queued before the last read

    def _finalize(res, nuniq, nvalid, size):
        nonlocal nvalid_total
        nv, nu = int(nvalid()), int(nuniq())
        trace.count("dedup.positions", nv)
        trace.count("dedup.uniques", nu)
        nvalid_total += nv
        keep = min(_trim(nu), size)
        # clone: a slice would keep the whole batch-sized tensor alive
        blocks_words.append(tuple(w[:keep].clone() for w in res["seg_words"]))
        blocks_counts.append(res["seg_counts"][:keep].clone())

    batches = itertools.chain(first_two, (b for b, _ordinal in gen))
    for i, batch in enumerate(batches):
        if i >= len(first_two):  # read after the slices before it were queued
            ahead = queued
        metas.append((np.asarray(batch.boff), np.asarray(batch.rlen),
                      len(batch.codes)))
        # decided before the batch's first slice: the join reads the
        # batch's instance streams only when every slice keeps its own, and
        # uploads the packed slices again otherwise
        size, count = _slicing(len(batch.codes), k)
        keep_inst = (profiles and relative_table is None
                     and inst_bytes + count * _inst_bytes(size, k)
                     <= inst_budget)
        keep_packed = profiles and not keep_inst
        if profiles:
            packed_store.append([])
            inst_store.append([])
        for off, size, buf in _code_slices(batch.codes, k):
            if relative_table is None:
                codes = device_codes(buf, dev)
                if keep_inst:
                    res = unique_batch_inst(codes, k, size)
                    inst_store[-1].append(
                        (off, size, res.pop("s_words"), res.pop("s_pos")))
                    inst_bytes += _inst_bytes(size, k)
                else:
                    res = unique_batch(codes, k, size)
                del codes
                queued += 1
                fetches = (fetch_async(res["nuniq"], "later"),
                           fetch_async(res["nvalid"], "later"))
                if pending is not None:
                    _finalize(*pending)
                pending = (res, *fetches, size)
                del res
            if profiles:
                # packed while the device counts the slice, without the
                # code-4 fill past the batch's end, which _kept_codes
                # writes back on the device
                n = min(len(buf), len(batch.codes) - off)
                pw, exc = (pack_stream_words(buf[:n]) if keep_packed
                           else (None, None))
                packed_store[-1].append((off, size, pw, exc, n))
        if verbose:
            print(f"  batch {len(metas)}: {len(metas[-1][1])} reads, "
                  f"{int(metas[-1][1].sum())} bases", flush=True)
        del batch
    if pending is not None:
        _finalize(*pending)
        pending = None
    trace.count("count.slices_ahead", ahead)

    rlens = [m[1] for m in metas]
    nreads = sum(len(r) for r in rlens)
    totlen = sum(int(r.sum()) for r in rlens)
    nshort = sum(int((r < k).sum()) for r in rlens)

    if relative_table is not None:
        t_words, t_counts = _device_table(relative_table, k, dev)
        sink = _ProfSink(k, out_base, out_nparts, nreads)
        _join_profiles_packed(metas, packed_store, k, t_words, t_counts,
                              sink, dev)
        sink.close()
        return CountOutput(k, None, None, sink.profs, nreads, totlen,
                           nshort=nshort)

    # one empty slot, so that an input without reads still merges
    m_words = tuple(
        torch.cat([b[j] for b in blocks_words]
                  + [torch.full((1,), ONES, dtype=torch.int64, device=dev)])
        for j in range(nwords(k)))
    m_counts = torch.cat(
        blocks_counts + [torch.zeros(1, dtype=torch.int32, device=dev)])
    del blocks_words, blocks_counts
    merged = merge_unique_blocks(m_words, m_counts)
    del m_words, m_counts
    hist = _histogram(k, merged["hist"], nvalid_total)

    table = table_entries = None
    if table_min is not None or profiles:
        nuniq = int(fetch(merged["nuniq"], "merge_nuniq"))
    if table_min is not None:
        table, table_entries = _table(
            k, table_min, merged["seg_words"], merged["seg_counts"],
            nuniq, out_base, out_nparts)

    profs = None
    if profiles:
        # join against the merged table on the device
        t_words = tuple(w[:nuniq] for w in merged["seg_words"])
        t_counts = torch.clamp(merged["seg_counts"][:nuniq], max=HIST_HIGH)
        sink = _ProfSink(k, out_base, out_nparts, nreads)
        _join_profiles_any(metas, inst_store, packed_store, k, t_words,
                           t_counts, sink, dev)
        sink.close()
        profs = sink.profs
    return CountOutput(k, hist, table, profs, nreads, totlen,
                       table_entries=table_entries, nshort=nshort)


def _count_single_hist(batch: ReadBatch, k: int, verbose: bool,
                       dev: torch.device) -> CountOutput:
    """Single-batch histogram job (the plain ``FastK -k``): no segment
    compaction and no merge."""
    size = _round_size(len(batch.codes), k)
    res = hist_batch(device_codes(_pad_codes(batch, k, size), dev), k, size)
    if verbose:
        print(f"  batch 1 (hist-only): {batch.nreads} reads, "
              f"{batch.totlen} bases", flush=True)
    rlen = np.asarray(batch.rlen)
    return CountOutput(k, _histogram(k, res["hist"], res["nvalid"]), None,
                       None, batch.nreads, batch.totlen,
                       nshort=int((rlen < k).sum()))


def _count_single_fused(batch: ReadBatch, k: int, table_min: Optional[int],
                        verbose: bool, out_base: Optional[str],
                        out_nparts: int, dev: torch.device) -> CountOutput:
    """Single-batch -p jobs (with or without -t): one count_batch gives the
    histogram, the unique table and the per-position counts."""
    size = _round_size(len(batch.codes), k)
    res = count_batch(device_codes(_pad_codes(batch, k, size), dev), k, size,
                      True, True)
    pos_fetch = fetch_async(res["pos_counts"].to(torch.int16), "fetch_u16")
    if verbose:
        print(f"  batch 1 (fused): {batch.nreads} reads, "
              f"{batch.totlen} bases", flush=True)
    nvalid = int(fetch(res["nvalid"], "fused_nvalid"))
    hist = _histogram(k, res["hist"], nvalid)

    table = table_entries = None
    if table_min is not None:
        # valid segments are the slots before the one trailing invalid one
        nuniq = (int(fetch(res["nseg"], "fused_nseg"))
                 - (1 if nvalid < size else 0))
        table, table_entries = _table(k, table_min, res["seg_words"],
                                      res["seg_counts"], nuniq, out_base,
                                      out_nparts)
    sink = _ProfSink(k, out_base, out_nparts, batch.nreads)
    sink.add_batch(batch.boff, batch.rlen, pos_fetch().view(np.uint16))
    sink.close()
    rlen = np.asarray(batch.rlen)
    return CountOutput(k, hist, table, sink.profs, batch.nreads,
                       batch.totlen, table_entries=table_entries,
                       nshort=int((rlen < k).sum()))


def _drain(metas, joins, sink: _ProfSink) -> None:
    """Assemble each batch's per-position counts from its slices' join
    results and hand them to the sink, one batch behind the joins: batch
    i+1's joins are queued on the device before batch i's counts are waited
    for. joins yields, per batch, a list of (off, size, int16 counts)."""
    pending = None

    def _emit(meta, fetches):
        boff, rlen, clen = meta
        pos_counts = np.zeros(clen, dtype=np.uint16)
        for off, size, got in fetches:
            take = min(size, clen - off)
            if take > 0:
                pos_counts[off: off + take] = got()[:take].view(np.uint16)
        sink.add_batch(boff, rlen, pos_counts)

    for meta, slices in zip(metas, joins):
        fetches = [(off, size, fetch_async(pc.to(torch.int16), "fetch_u16"))
                   for off, size, pc in slices]
        if pending is not None:
            _emit(*pending)
        pending = (meta, fetches)
    if pending is not None:
        _emit(*pending)


def _kept_codes(pw, exc, n: int, length: int, dev) -> torch.Tensor:
    """A kept packed slice on the device: its n packed codes, then code 4
    up to the slice's length."""
    codes = upload_packed(pw, exc, n, dev)
    if n == length:
        return codes
    out = torch.full((length,), 4, dtype=torch.uint8, device=dev)
    out[:n] = codes
    return out


def _packed_joins(pslices, k, t_words, t_counts, dev):
    pad = pad_needed(k)
    return [(off, size, profile_join(
        t_words, t_counts, _kept_codes(pw, exc, n, size + pad, dev), k,
        size)) for off, size, pw, exc, n in pslices]


def _join_profiles_any(metas, inst_store, packed_store, k, t_words,
                       t_counts, sink: _ProfSink, dev) -> None:
    """The profile pass: a batch whose sorted instance streams are all on
    the device joins them (profile_join_inst: no upload, no canonical keys,
    position order straight off the join); any other batch uploads its
    packed slices again (profile_join)."""
    def joins():
        for i, pslices in enumerate(packed_store):
            islices = inst_store[i]
            inst_store[i] = []  # free each stream once it is joined
            if islices:
                yield [(off, size, profile_join_inst(t_words, t_counts,
                                                     s_words, s_pos))
                       for off, size, s_words, s_pos in islices]
            else:
                del islices
                yield _packed_joins(pslices, k, t_words, t_counts, dev)

    _drain(metas, joins(), sink)


def _join_profiles_packed(metas, packed_store, k, t_words, t_counts,
                          sink: _ProfSink, dev) -> None:
    """The profile pass from the packed slices alone (relative profiles)."""
    _drain(metas, (_packed_joins(pslices, k, t_words, t_counts, dev)
                   for pslices in packed_store), sink)


def count_reads(reads: List[bytes], k: int, **kw) -> CountOutput:
    """Count an in-memory list of raw reads (written to a temporary FASTA)."""
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "in.fasta")
        with open(p, "w") as f:
            for i, r in enumerate(reads):
                s = r.decode() if isinstance(r, (bytes, bytearray)) else r
                f.write(f">r{i}\n{s}\n")
        return count_files([p], k, **kw)
