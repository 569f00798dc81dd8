"""`fastmerge` — merge per-part k-mer tables produced by separate counting
jobs into one table/histogram (reference: Fastmerge.c:459-1048):

    fastmerge [-ht] [-T<int(4)>] [-#<int(1)>] [-P<dir(/tmp)>]
              [-S<N:int>of<D:int>] <target> <source>[.hist|.ktab] ...

Counts of k-mers present in several sources are summed and clipped at 32767
(reference: Fastmerge.c table_thread count-sum with 0x7fff clip). With
-S NofD only the Nth of D keyspace slices is produced; slice boundaries come
from the pivot (largest) table's entry quantiles so every slice job cuts the
keyspace identically (reference: Fastmerge.c:784-799), and slices then
concatenate with fastcat.

The merge STREAMS: sources advance through bounded keyspace windows
(formats.twindow — the GoTo_Kmer_Entry-aligned N-way merge of
Fastmerge.c:168-450) and the output table streams through KtabWriter, so
tables larger than RAM merge in O(window) memory.

The port's copy of ``fastk_tpu/tools/fastmerge.py``. Only the library call
``merge_tables`` differs: it takes the device of its union (default
``"cuda"``; ``ops.tables.merge_counted``). The command is the host's
streamed merge and never imports torch.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

from fastk_tpu_torch.formats.hist import Histogram, write_histogram
from fastk_tpu_torch.formats.ktab import KmerTable, read_ktab, write_ktab
from fastk_tpu_torch.tools._cli import die

USAGE = """Usage: fastmerge [-ht] [-T<int(4)>] [#<int(1)>] [-P<dir(/tmp)>] [-S<N:int>of<D:int>]
                 <target> <source>[.hist|.ktab] ..."""


def _slice_ibyte(tels: int) -> int:
    """Stub-index byte width from total entries (Fastmerge.c:748-760 — the
    same 1/2/3-byte IDX rule as the table writer)."""
    return 3 if tels >= 0x8000000 else (2 if tels >= 0x80000 else 1)


def _snap_prefix(key: bytes, ibyte: int, kb: int) -> bytes:
    """Slice cuts land on prefix-block boundaries: the reference zeroes the
    pivot key's suffix bytes before aligning every source at it
    (Fastmerge.c:781-812 \"partition must be at a prefix boundary\").
    `key` may arrive with trailing nulls stripped (numpy S-dtype)."""
    return (key.ljust(kb, b"\x00"))[:ibyte] + b"\x00" * (kb - ibyte)


def merge_tables(tables, slice_spec=None, device="cuda"):
    """Sum-merge sorted tables on `device`; optionally restrict to slice
    (n, d)."""
    kmer = tables[0].kmer
    kb = tables[0].packed.shape[1]
    for t in tables[1:]:
        if t.kmer != kmer:
            die("fastmerge: tables do not have a common k-mer size")

    lo_key = hi_key = None
    if slice_spec is not None:
        n, d = slice_spec
        pivot = max(tables, key=len)
        nels = len(pivot)
        ib = _slice_ibyte(sum(len(t) for t in tables))
        pv = pivot.packed.view(f"S{kb}").ravel()
        if n > 1:
            lo_key = np.frombuffer(
                _snap_prefix(bytes(pv[nels * (n - 1) // d]), ib, kb),
                dtype=f"S{kb}")[0]
        if n < d:
            hi_key = np.frombuffer(
                _snap_prefix(bytes(pv[nels * n // d]), ib, kb),
                dtype=f"S{kb}")[0]

    allp = np.concatenate([t.packed for t in tables])
    allc = np.concatenate([t.counts.astype(np.int64) for t in tables])
    view = allp.view(f"S{kb}").ravel()
    if lo_key is not None or hi_key is not None:
        m = np.ones(len(view), bool)
        if lo_key is not None:
            m &= view >= lo_key
        if hi_key is not None:
            m &= view < hi_key
        allp, allc = allp[m], allc[m]

    # union-merge with count sums, on `device` for large inputs
    from fastk_tpu_torch.ops.kmers import packed_to_words, words_to_packed
    from fastk_tpu_torch.ops.tables import merge_counted

    uwords, summed = merge_counted([packed_to_words(allp, kmer)], [allc],
                                   device=device)
    minval = min(t.minval for t in tables)
    return KmerTable(kmer, minval, words_to_packed(uwords, kmer),
                     np.minimum(summed, 32767).astype(np.uint16))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    do_hist = do_table = False
    nthreads, per_thread = 4, 1
    slice_spec = None
    cache_dir = None
    pos = []
    for a in argv:
        if a.startswith("-") and len(a) > 1 and all(c in "ht" for c in a[1:]):
            do_hist |= "h" in a[1:]
            do_table |= "t" in a[1:]
        elif a.startswith("-T"):
            nthreads = int(a[2:])
        elif a.startswith("#") or a.startswith("-#"):
            per_thread = int(a.lstrip("-#") or "1")
        elif a.startswith("-P"):
            cache_dir = a[2:] or "/tmp"
        elif a.startswith("-S"):
            m = re.fullmatch(r"(\d+)of(\d+)", a[2:])
            if not m:
                die(f"fastmerge: -S argument must be <N>of<D>: {a}")
            slice_spec = (int(m.group(1)), int(m.group(2)))
            if not 1 <= slice_spec[0] <= slice_spec[1]:
                die("fastmerge: slice number out of range")
        elif a.startswith("-"):
            die(f"fastmerge: {a} is an illegal option\n{USAGE}")
        else:
            pos.append(a)
    if not (do_hist or do_table):
        die("fastmerge: at least one of -h or -t must be set")
    if len(pos) < 2:
        die(USAGE)
    target, sources = pos[0], pos[1:]
    return merge_streamed(sources, target, max(1, nthreads * per_thread),
                          do_hist, do_table, slice_spec,
                          cache_dir=cache_dir, nthreads=max(1, nthreads))


def _cache_slice(s, lo_key, hi_key, cache_base: str):
    """Node-local byte-range cache: copy ONLY the records of [lo_key,
    hi_key) from a (shared-FS) source table into a private table at
    cache_base and reopen it there — the reference's Open_Kmer_Cache
    (libfastk.c:1056-1139), which a multi-node slice job uses so each node
    reads its slice's bytes once over the network.

    The cached stub keeps the source geometry (same ibyte/nparts; parts
    outside the range are empty) with the prefix index clipped to the kept
    window, so every downstream positioning works unchanged."""
    import struct as _struct

    from fastk_tpu_torch.formats.ktab import KmerStream
    from fastk_tpu_torch.formats.paths import part_path, stub_path

    kb = s.kbyte
    if lo_key is not None:
        s.goto_kmer(np.frombuffer(bytes(lo_key).ljust(kb, b"\x00"),
                                  np.uint8))
        bidx = s.idx
    else:
        bidx = 0
    if hi_key is not None:
        s.goto_kmer(np.frombuffer(bytes(hi_key).ljust(kb, b"\x00"),
                                  np.uint8))
        eidx = s.idx
    else:
        eidx = s.nels

    pindex = np.clip(s._pindex, bidx, eidx) - bidx
    with open(stub_path(cache_base, ".ktab"), "wb") as f:
        f.write(_struct.pack("<iiii", s.kmer, s.nparts, s.minval, s.ibyte))
        pindex.astype("<i8").tofile(f)
    for p in range(s.nparts):
        blo = max(bidx, s._bases[p]) - s._bases[p]
        bhi = max(blo, min(eidx, s._bases[p + 1]) - s._bases[p])
        with open(part_path(cache_base, ".ktab", p + 1), "wb") as f:
            f.write(_struct.pack("<i", s.kmer))
            f.write(_struct.pack("<q", bhi - blo))
            if bhi > blo:
                s._maps[p][blo:bhi].tofile(f)
    return KmerStream(cache_base)


def merge_streamed(sources, target, nparts, do_hist, do_table, slice_spec,
                   window=None, cache_dir=None, nthreads: int = 1):
    """Windowed streaming merge: O(window) memory at any table scale.
    nthreads > 1 splits the OUTPUT PART ranges across worker threads
    (each walks its contiguous keyspace range with its own cursors and
    writes its own parts; the fused C merges release the GIL) — the
    reference's Fastmerge thread split (Fastmerge.c:365-450)."""
    from fastk_tpu_torch.formats.hist import HIST_HIGH
    from fastk_tpu_torch.formats.ktab import KmerStream
    from fastk_tpu_torch.formats.twindow import (
        DEFAULT_WINDOW, key_at, stream_windows, window_sum)

    streams = []
    for s in sources:
        for ext in (".hist", ".ktab", ".prof"):
            if s.endswith(ext):  # USAGE accepts suffixed roots
                s = s[: -len(ext)]
                break
        try:
            streams.append(KmerStream(s))
        except FileNotFoundError:
            die(f"fastmerge: Cannot open {s}")
    kmer = streams[0].kmer
    kb = streams[0].kbyte
    for s in streams[1:]:
        if s.kmer != kmer:
            die("fastmerge: tables do not have a common k-mer size")

    lo_key = hi_key = None
    if slice_spec is not None:
        n, d = slice_spec
        pivot = max(streams, key=lambda s: s.nels)
        ib = _slice_ibyte(sum(s.nels for s in streams))
        if pivot.nels:
            if n > 1:
                lo_key = _snap_prefix(
                    key_at(pivot, pivot.nels * (n - 1) // d), ib, kb)
            if n < d:
                hi_key = _snap_prefix(
                    key_at(pivot, pivot.nels * n // d), ib, kb)

    minval = min(s.minval for s in streams)
    ktw = None
    if do_table:
        # single-pass reference layout (Fastmerge.c:748-812): the output
        # ibyte comes from the PRE-merge sum of source sizes and part cuts
        # from pivot quantiles snapped to prefix boundaries, both known up
        # front — so part files stream out directly, no spool, O(window)
        # memory. (KtabWriter's exact-total layout would need the merged
        # count first.)
        tels = sum(s.nels for s in streams)
        ib_out = _slice_ibyte(tels)
        pivot = max(streams, key=lambda s: s.nels)
        base = ((slice_spec[0] - 1) if slice_spec else 0) * nparts
        den = (slice_spec[1] if slice_spec else 1) * nparts
        cut_keys = []
        for t in range(1, nparts):
            p = pivot.nels * (base + t) // den
            if p >= pivot.nels:
                cut_keys.append(b"\xff" * kb)  # trailing parts stay empty
            else:
                cut_keys.append(_snap_prefix(key_at(pivot, p), ib_out, kb))
        from fastk_tpu_torch.formats.ktab import KtabDirectWriter

        ktw = KtabDirectWriter(target, kmer, minval, ib_out, cut_keys)

    cache_tmp = None
    if cache_dir is not None and (lo_key is not None or hi_key is not None):
        # -P: cache each source's slice byte range on local disk (AFTER
        # the cut geometry above, which must see the FULL pivot)
        import tempfile

        cache_tmp = tempfile.mkdtemp(prefix="fastmerge.P.", dir=cache_dir)
        streams = [_cache_slice(s, lo_key, hi_key,
                                os.path.join(cache_tmp, f"c{i}"))
                   for i, s in enumerate(streams)]

    bins = np.zeros(HIST_HIGH + 1, dtype=np.int64)
    from fastk_tpu_torch import native

    T = max(1, int(nthreads))
    if ktw is None or T > nparts:
        T = min(T, nparts) if ktw is not None else 1
    if (native.load() is not None and len(streams) <= 64 and kb <= 62
            and T > 1 and ktw is not None):
        # threaded fused merge: worker r owns output parts
        # [starts[r], starts[r+1]) — a contiguous keyspace range bounded
        # by the part cut keys (combined with the -S slice bounds at the
        # ends); each worker runs fk_merge_windows over its own cursors
        # into its own KtabDirectWriter slice; the stub assembles from
        # the summed per-thread prefix histograms
        from concurrent.futures import ThreadPoolExecutor

        from fastk_tpu_torch.formats.ktab import (KtabDirectWriter,
                                            write_direct_stub)
        from fastk_tpu_torch.formats.twindow import stream_window_ranges

        ib_out = ktw.ibyte
        cut_keys = ktw.cuts
        ktw = None  # replaced by per-thread slice writers
        starts = [r * nparts // T for r in range(T + 1)]
        key_ranges = [
            (cut_keys[starts[r] - 1] if starts[r] > 0 else lo_key,
             cut_keys[starts[r + 1] - 1] if starts[r + 1] < nparts
             else hi_key) for r in range(T)]
        roots = [s.path for s in streams]

        def _work(r):
            lo_r, hi_r = key_ranges[r]
            strs = [KmerStream(p) for p in roots]
            h2_r = np.zeros(1 << 16, np.int64)
            bins_r = np.zeros(HIST_HIGH + 1, np.int64)
            w = KtabDirectWriter(target, kmer, minval, ib_out,
                                 cut_keys[starts[r]: starts[r + 1] - 1],
                                 part_base=starts[r], write_stub=False)
            if ib_out <= 2:
                w.skip_prefix = True
            ok_r = False
            try:
                for ranges in stream_window_ranges(
                        strs, window or DEFAULT_WINDOW, lo_r, hi_r):
                    rec = native.merge_windows(strs, ranges, kb, h2_r,
                                               bins_r)
                    assert rec is not None
                    w.add_records(rec)
                w.close()
                ok_r = True
            finally:
                if not ok_r:
                    try:
                        w.abort()
                    except Exception:
                        pass
            return w, h2_r, bins_r

        with ThreadPoolExecutor(T) as pool:
            results = list(pool.map(_work, range(T)))
        pind = np.zeros(1 << (8 * ib_out), np.int64)
        for w, h2_r, bins_r in results:
            pind += ((h2_r if ib_out == 2
                      else h2_r.reshape(256, 256).sum(axis=1))
                     if w.skip_prefix else w._pindex)
            bins += bins_r
        write_direct_stub(target, kmer, nparts, minval, ib_out, pind)
    elif native.load() is not None and len(streams) <= 64 and kb <= 62:
        # fused native window: part memmaps -> writer-format records with
        # clipped sums, prefix histogram and count histogram in ONE pass.
        # The native 2-byte prefix histogram feeds the direct writer's
        # stub index when ib_out <= 2 so Python never re-counts prefixes.
        h2 = np.zeros(1 << 16, np.int64)
        if ktw is not None and ktw.ibyte <= 2:
            ktw.skip_prefix = True
        from fastk_tpu_torch.formats.twindow import stream_window_ranges
        for ranges in stream_window_ranges(
                streams, window or DEFAULT_WINDOW, lo_key, hi_key):
            rec = native.merge_windows(streams, ranges, kb, h2, bins)
            assert rec is not None  # load() checked above
            if ktw is not None:
                ktw.add_records(rec)
        if ktw is not None and ktw.skip_prefix:
            ktw.set_pindex(h2 if ktw.ibyte == 2
                           else h2.reshape(256, 256).sum(axis=1))
    else:
        for chunk in stream_windows(streams, window or DEFAULT_WINDOW,
                                    lo_key, hi_key):
            rows, sums = window_sum(chunk, kb)
            if len(rows) == 0:
                continue
            clipped = np.minimum(sums, HIST_HIGH).astype(np.uint16)
            if ktw is not None:
                ktw.add(rows, clipped)
            if do_hist:
                bins += np.bincount(clipped, minlength=HIST_HIGH + 1
                                    ).astype(np.int64)
    if ktw is not None:
        ktw.close()
    if do_hist:
        write_histogram(target, Histogram.from_bins(kmer, bins))
    if cache_tmp is not None:
        import shutil

        shutil.rmtree(cache_tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
