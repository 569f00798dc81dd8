"""The ``.ktab`` sorted k-mer/count table format.

A table is a *stub* file plus N hidden part files (reference: README.md
"K-mer Table Files"; stub writer table.c:488-504; readers libfastk.c:253-1470).

Stub ``<dir>/<base>.ktab``:

    int32   kmer size k
    int32   number of parts N (the reference's thread count)
    int32   minimum count m (the -t cutoff the table was built with)
    int32   prefix bytes p (1..3)
    int64 x 4^(4p)   IDX;  IDX[i] = ordinal index of the first entry whose
                     first 4p bases exceed value i (cumulative counts)

Part ``<dir>/.<base>.ktab.<i>`` (1-based i):

    int32   kmer size k
    int64   number of entries n in this part
    n x ( uint8[ceil(k/4) - p] suffix, uint16 count )

K-mer bases pack 2 bits each, 4 per byte, high bits first, a/c/g/t = 0/1/2/3;
the last byte's unused low bits are zero. Prefix-value intervals never span
parts, so each part is independently sorted and their concatenation is the
full sorted table.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from fastk_tpu_torch.formats.paths import part_path, stub_path

_BASES = "acgt"
_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(_BASES):
    _CODE[ord(_b)] = _i
    _CODE[ord(_b.upper())] = _i


def kbytes(kmer: int) -> int:
    return (kmer + 3) // 4


def pack_kmer(s: str) -> np.ndarray:
    """2-bit pack one k-mer string into ceil(k/4) bytes, high bits first."""
    codes = _CODE[np.frombuffer(s.encode(), dtype=np.uint8)]
    if (codes > 3).any():
        raise ValueError(f"non-acgt base in {s!r}")
    return pack_codes(codes[None, :])[0]


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Pack (n, k) 2-bit base codes into (n, ceil(k/4)) bytes."""
    n, k = codes.shape
    kb = kbytes(k)
    padded = np.zeros((n, kb * 4), dtype=np.uint8)
    padded[:, :k] = codes
    return (
        (padded[:, 0::4] << 6)
        | (padded[:, 1::4] << 4)
        | (padded[:, 2::4] << 2)
        | padded[:, 3::4]
    ).astype(np.uint8)


def unpack_codes(packed: np.ndarray, kmer: int) -> np.ndarray:
    """Unpack (n, kb) bytes into (n, kmer) 2-bit base codes."""
    packed = np.asarray(packed, dtype=np.uint8)
    n = packed.shape[0]
    out = np.empty((n, packed.shape[1] * 4), dtype=np.uint8)
    out[:, 0::4] = packed >> 6
    out[:, 1::4] = (packed >> 4) & 3
    out[:, 2::4] = (packed >> 2) & 3
    out[:, 3::4] = packed & 3
    return out[:, :kmer]


def kmer_to_string(packed: np.ndarray, kmer: int) -> str:
    codes = unpack_codes(np.asarray(packed, dtype=np.uint8)[None, :], kmer)[0]
    return "".join(_BASES[c] for c in codes)


def idx_bytes_for(n_entries: int, kmer: int) -> int:
    """Stub prefix-byte width rule (reference: count.c:1620-1626)."""
    if n_entries > 0x4000000 and kmer >= 12:
        return 3
    if n_entries >= 0x40000 and kmer >= 8:
        return 2
    return 1


def _prefix_values(packed: np.ndarray, ibyte: int) -> np.ndarray:
    """Big-endian integer value of the first ibyte bytes of each entry."""
    v = packed[:, 0].astype(np.int64)
    for j in range(1, ibyte):
        v = (v << 8) | packed[:, j]
    return v


@dataclass
class KmerTable:
    """An in-memory sorted k-mer/count table (reference: Kmer_Table,
    libfastk.h:47-74, libfastk.c:253-766)."""

    kmer: int
    minval: int
    packed: np.ndarray  # (n, ceil(k/4)) uint8, lexicographically sorted
    counts: np.ndarray  # (n,) uint16

    def __post_init__(self) -> None:
        self.packed = np.ascontiguousarray(self.packed, dtype=np.uint8)
        self.counts = np.ascontiguousarray(self.counts, dtype=np.uint16)

    def __len__(self) -> int:
        return self.packed.shape[0]

    def kmer_string(self, i: int) -> str:
        return kmer_to_string(self.packed[i], self.kmer)

    def fetch_count(self, i: int) -> int:
        return int(self.counts[i])

    def find(self, kmer_str_or_packed) -> Optional[int]:
        """Binary search for a k-mer's ordinal index; canonicalizes the query
        like Find_Kmer (reference: libfastk.c:719-766). Returns None if absent.
        """
        from fastk_tpu_torch.ops.canonical import canonical_packed

        if isinstance(kmer_str_or_packed, str):
            q = pack_kmer(kmer_str_or_packed)
        else:
            q = np.asarray(kmer_str_or_packed, dtype=np.uint8)
        q = canonical_packed(q[None, :], self.kmer)[0]
        i = self._searchsorted(q)
        if i < len(self) and bytes(self.packed[i]) == bytes(q):
            return i
        return None

    def _searchsorted(self, q: np.ndarray) -> int:
        view = self.packed.view(f"S{self.packed.shape[1]}").ravel()
        return int(np.searchsorted(view, bytes(q)))

    def check_sorted(self) -> bool:
        """Sortedness validator (reference: Tabex -C check, Tabex.c:31-62)."""
        view = self.packed.view(f"S{self.packed.shape[1]}").ravel()
        return bool(np.all(view[:-1] < view[1:]))


def part_splits(prefix_vals: np.ndarray, pidxlen: int, nparts: int) -> List[int]:
    """Choose part boundaries (entry ordinals) aligned to prefix boundaries.

    The reference fixes its split from internal bucket geometry
    (count.c:1560-1594); we target equal entry counts per part subject to the
    format invariant that a prefix interval never spans parts.
    """
    n = len(prefix_vals)
    if nparts <= 1 or n == 0:
        return [0] * max(nparts - 1, 0)
    # first entry ordinal of each distinct prefix
    starts = np.flatnonzero(np.diff(prefix_vals, prepend=-1))  # ordinals
    cuts = []
    for t in range(1, nparts):
        target = n * t // nparts
        j = int(np.searchsorted(starts, target))
        if j >= len(starts):
            cuts.append(n)
            continue
        lo = starts[j - 1] if j > 0 else 0
        hi = starts[j]
        cuts.append(int(hi if hi - target <= target - lo else lo))
    return cuts


def part_splits_from_pindex(pindex: np.ndarray, nparts: int) -> List[int]:
    """part_splits computed from the cumulative prefix index alone (no
    per-entry prefix array): candidate boundaries are exactly the pindex
    values; equivalent to part_splits on the full prefix-value array."""
    n = int(pindex[-1]) if len(pindex) else 0
    if nparts <= 1:
        return []
    if n == 0:
        return [0] * (nparts - 1)
    cuts = []
    for t in range(1, nparts):
        target = n * t // nparts
        i0 = int(np.searchsorted(pindex, target, side="left"))
        hi = int(pindex[i0]) if i0 < len(pindex) else n
        if hi >= n:
            # no prefix start at or past the target: cut at the end,
            # unconditionally (part_splits' starts array excludes n)
            cuts.append(n)
            continue
        lo = int(pindex[i0 - 1]) if i0 > 0 else 0
        cuts.append(hi if hi - target <= target - lo else lo)
    return cuts


class KtabWriter:
    """Stream sorted (packed, count) chunks to a .ktab file-set in bounded
    memory. Chunks accumulate in RAM up to a budget (FASTK_TPU_KTAB_SPILL_MB,
    default 1024) and spill to a raw temp file beyond it; close() fixes ibyte
    from the exact total, builds the stub prefix index, and emits part files
    — so arbitrary-scale tables write with O(budget) RAM, byte-identical to
    ``write_ktab`` whether or not they spilled (the reference's phase-3
    table writer streams under the same SORT_MEMORY budget idea,
    table.c:162-533)."""

    _CHUNK = 1 << 22  # records per conversion chunk

    def __init__(self, path: str, kmer: int, minval: int, nparts: int = 1,
                 ibyte: Optional[int] = None,
                 spill_bytes: Optional[int] = None):
        self.path = path
        self.kmer = kmer
        self.minval = minval
        self.nparts = nparts
        self.ibyte = ibyte
        self.kb = kbytes(kmer)
        self.n = 0
        self._budget = (spill_bytes if spill_bytes is not None else
                        int(os.environ.get("FASTK_TPU_KTAB_SPILL_MB",
                                           "1024")) << 20)
        self._mem: List[np.ndarray] = []  # (m, kb+2) uint8 chunks
        self._mem_bytes = 0
        self._tmp_path = stub_path(path, ".ktab") + ".tmp"
        self._tmp = None  # opened on first spill
        # 2-byte-prefix histogram accumulated as chunks arrive: lets close()
        # build the stub index without re-reading the spool (ibyte <= 2,
        # i.e. every table under 0x4000000 entries — the idx_bytes_for rule)
        self._h2 = np.zeros(1 << 16, dtype=np.int64)

    def add(self, packed: np.ndarray, counts: np.ndarray) -> None:
        """Append a chunk of entries (must continue the global sort order)."""
        m = len(counts)
        if m == 0:
            return
        from fastk_tpu_torch import native

        rec = native.writer_add(packed, counts, self._h2)
        if rec is None:
            rec = np.empty((m, self.kb + 2), dtype=np.uint8)
            rec[:, : self.kb] = packed
            rec[:, self.kb:] = np.ascontiguousarray(
                counts, dtype="<u2").view(np.uint8).reshape(m, 2)
            pv2 = packed[:, 0].astype(np.int32) << 8
            if self.kb > 1:  # k <= 4 tables have a single key byte
                pv2 |= packed[:, 1]
            self._h2 += np.bincount(pv2, minlength=1 << 16).astype(np.int64)
        self._append_rows(rec)

    def add_records(self, rec: np.ndarray) -> None:
        """Append preassembled (m, kb+2) writer-format rows whose 2-byte
        prefix histogram contribution was ALREADY accumulated into _h2 by
        the producer (the native fused merge, fk_merge_windows)."""
        if len(rec):
            self._append_rows(rec)

    def _append_rows(self, rec: np.ndarray) -> None:
        if self._tmp is None and self._mem_bytes + rec.nbytes > self._budget:
            self._tmp = open(self._tmp_path, "wb")
            for old in self._mem:
                old.tofile(self._tmp)
            self._mem = []
            self._mem_bytes = 0
        if self._tmp is not None:
            rec.tofile(self._tmp)
        else:
            self._mem.append(rec)
            self._mem_bytes += rec.nbytes
        self.n += len(rec)

    def close(self) -> None:
        if self._tmp is not None:
            self._tmp.close()
        try:
            self._write_final()
        finally:
            self._mem = []
            if self._tmp is not None:
                try:
                    os.unlink(self._tmp_path)
                except OSError:
                    pass

    def _iter_rows(self, lo: int, hi: int):
        """Yield contiguous (m, kb+2) row blocks covering records [lo, hi),
        each at most _CHUNK records, from the spool or the in-RAM chunks."""
        if self._tmp is not None:
            # bounded reads, NOT a memmap: close() walks the whole spool,
            # and memmap pages it touches stay resident — peak RSS grew
            # with table size (found by benchmarks/bench_rss.py timelines)
            rb = self.kb + 2
            with open(self._tmp_path, "rb") as f:
                for c0 in range(lo, hi, self._CHUNK):
                    c1 = min(hi, c0 + self._CHUNK)
                    f.seek(c0 * rb)
                    buf = np.fromfile(f, dtype=np.uint8,
                                      count=(c1 - c0) * rb)
                    yield buf.reshape(c1 - c0, rb)
            return
        base = 0
        for rec in self._mem:
            m = len(rec)
            s0, s1 = max(lo - base, 0), min(hi - base, m)
            base += m
            if s1 <= s0:
                continue
            for c0 in range(s0, s1, self._CHUNK):
                yield rec[c0: min(s1, c0 + self._CHUNK)]

    def _write_final(self) -> None:
        n = self.n
        ibyte = self.ibyte or idx_bytes_for(n, self.kmer)
        pidxlen = 1 << (8 * ibyte)

        # prefix histogram -> cumulative index + part cuts. For ibyte <= 2
        # the 2-byte histogram accumulated during add() already has it; only
        # ibyte == 3 (tables past 0x4000000 entries) re-reads the records.
        if ibyte == 1:
            pindex = self._h2.reshape(256, 256).sum(axis=1)
        elif ibyte == 2:
            pindex = self._h2.copy()
        else:
            pindex = np.zeros(pidxlen, dtype=np.int64)
            for rows in self._iter_rows(0, n):
                pv = _prefix_values(rows, ibyte)
                pindex += np.bincount(pv, minlength=pidxlen).astype(np.int64)
        np.cumsum(pindex, out=pindex)
        cuts = [0] + part_splits_from_pindex(pindex, self.nparts) + [n]

        with open(stub_path(self.path, ".ktab"), "wb") as f:
            f.write(struct.pack("<iiii", self.kmer, self.nparts,
                                self.minval, ibyte))
            pindex.astype("<i8").tofile(f)

        # pass 2: strip the ibyte prefix, emit part files
        for p in range(self.nparts):
            lo, hi = cuts[p], cuts[p + 1]
            with open(part_path(self.path, ".ktab", p + 1), "wb") as f:
                f.write(struct.pack("<i", self.kmer))
                f.write(struct.pack("<q", hi - lo))
                for rows in self._iter_rows(lo, hi):
                    np.ascontiguousarray(rows[:, ibyte:]).tofile(f)

    def abort(self) -> None:
        """Tear down without finalizing: drop buffered chunks and remove the
        tmp spool (no stub/part files have been written yet at this point)."""
        self._mem = []
        if self._tmp is not None:
            try:
                self._tmp.close()
            finally:
                try:
                    os.unlink(self._tmp_path)
                except OSError:
                    pass

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.close()
        else:
            self.abort()


class KtabDirectWriter:
    """Single-pass .ktab writer: part files stream out as records arrive.

    Unlike KtabWriter (which buffers/spools because ibyte and part cuts
    need the final totals), this takes both UP FRONT — the reference's
    Fastmerge layout, where ibyte comes from the PRE-merge sum of source
    sizes (tels, Fastmerge.c:748-760) and output pieces cut at pivot-table
    quantiles snapped to prefix boundaries (Fastmerge.c:784-812) — so every
    record byte is touched exactly once and memory stays O(chunk).

    cut_keys: nparts-1 non-decreasing full-width keys (suffix past ibyte
    zeroed); part p takes records in [cut[p-1], cut[p]).

    part_base/write_stub: a writer may cover a SLICE of the output's
    parts (files numbered from part_base+1) without writing the stub —
    the threaded tools give each worker thread a contiguous part range
    and assemble the stub from the summed per-thread prefix histograms
    (the reference's table tools split output parts across threads the
    same way, e.g. Fastmerge.c:365-390)."""

    def __init__(self, path: str, kmer: int, minval: int, ibyte: int,
                 cut_keys, part_base: int = 0, write_stub: bool = True):
        self.path = path
        self.kmer = kmer
        self.minval = minval
        self.ibyte = ibyte
        self.kb = kbytes(kmer)
        self.cuts = [bytes(c) for c in cut_keys]
        assert all(len(c) == self.kb for c in self.cuts)
        self.nparts = len(self.cuts) + 1
        self.part_base = part_base
        self.write_stub = write_stub
        self.n = 0
        self._p = 0  # current part
        self._f = None  # current part file
        self._part_n = 0
        self._pindex = np.zeros(1 << (8 * ibyte), dtype=np.int64)
        self._h2 = None  # native add()'s 2-byte prefix histogram
        self.skip_prefix = False  # caller supplies pindex via set_pindex

    def _open_part(self) -> None:
        self._f = open(part_path(self.path, ".ktab",
                                 self.part_base + self._p + 1), "wb")
        self._f.write(struct.pack("<i", self.kmer))
        self._f.write(struct.pack("<q", 0))  # nels patched on part close
        self._part_n = 0

    def _close_part(self) -> None:
        if self._f is None:
            self._open_part()  # empty part still gets its header
        self._f.seek(4)
        self._f.write(struct.pack("<q", self._part_n))
        self._f.close()
        self._f = None
        self._p += 1

    def _emit(self, rec: np.ndarray) -> None:
        if len(rec) == 0:
            return
        if self._f is None:
            self._open_part()
        np.ascontiguousarray(rec[:, self.ibyte:]).tofile(self._f)
        self._part_n += len(rec)
        self.n += len(rec)

    def add_records(self, rec: np.ndarray, prefix_done: bool = False
                    ) -> None:
        """Append (m, kb+2) writer-format rows continuing the global sort
        order (key bytes then little-endian uint16 count). prefix_done:
        this chunk's prefix counts were already accumulated elsewhere."""
        m = len(rec)
        if m == 0:
            return
        ib = self.ibyte
        if not self.skip_prefix and not prefix_done:
            pv = rec[:, 0].astype(np.int64)
            for j in range(1, ib):
                pv = (pv << 8) | rec[:, j]
            # sorted-run accumulation: few distinct prefixes per chunk
            b = np.flatnonzero(np.diff(pv)) + 1
            starts = np.concatenate([[0], b, [m]])
            self._pindex[pv[starts[:-1]]] += np.diff(starts)

        lo = 0
        while self._p < self.nparts - 1:
            cut = self.cuts[self._p]
            # common case: the whole remaining chunk stays in this part
            if bytes(rec[m - 1, : self.kb]) < cut:
                break
            keys = np.ascontiguousarray(rec[lo:, : self.kb]
                                        ).view(f"S{self.kb}").ravel()
            split = lo + int(np.searchsorted(
                keys, np.frombuffer(cut, dtype=f"S{self.kb}")[0]))
            self._emit(rec[lo:split])
            self._close_part()
            lo = split
        self._emit(rec[lo:])

    def add(self, packed: np.ndarray, counts: np.ndarray) -> None:
        """Assemble writer-format rows from keys + counts — through the
        native assembler (which also accumulates the 2-byte prefix
        histogram, folded into the stub index at close) when available."""
        m = len(counts)
        if m == 0:
            return
        if self.ibyte <= 2 and not self.skip_prefix:
            from fastk_tpu_torch import native

            if self._h2 is None:
                self._h2 = np.zeros(1 << 16, dtype=np.int64)
            rec = native.writer_add(packed, counts, self._h2)
            if rec is not None:
                self.add_records(rec, prefix_done=True)
                return
        rec = np.empty((m, self.kb + 2), dtype=np.uint8)
        rec[:, : self.kb] = packed
        rec[:, self.kb:] = np.ascontiguousarray(
            counts, dtype="<u2").view(np.uint8).reshape(m, 2)
        self.add_records(rec)

    def set_pindex(self, pindex: np.ndarray) -> None:
        """Adopt an externally accumulated (un-cumulated) prefix histogram
        of width ibyte — used with skip_prefix when the record producer
        already counts prefixes (e.g. the native fastmerge window engine's
        2-byte histogram), so the bytes aren't walked twice."""
        assert len(pindex) == 1 << (8 * self.ibyte)
        self._pindex = np.asarray(pindex, dtype=np.int64)

    def close(self) -> None:
        while self._p < self.nparts:
            self._close_part()
        if self._h2 is not None:  # fold the native assembler's histogram
            self._pindex += (self._h2 if self.ibyte == 2
                             else self._h2.reshape(256, 256).sum(axis=1))
        if not self.write_stub:
            return  # a part-slice worker; the owner assembles the stub
        pindex = np.cumsum(self._pindex)
        with open(stub_path(self.path, ".ktab"), "wb") as f:
            f.write(struct.pack("<iiii", self.kmer, self.nparts,
                                self.minval, self.ibyte))
            pindex.astype("<i8").tofile(f)

    def abort(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        for p in range(self._p + 1):
            try:
                os.unlink(part_path(self.path, ".ktab",
                                    self.part_base + p + 1))
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.close()
        else:
            self.abort()


def write_direct_stub(path: str, kmer: int, nparts: int, minval: int,
                      ibyte: int, pindex_counts: np.ndarray) -> None:
    """Write a .ktab stub from an (un-cumulated) prefix histogram — the
    assembly step after part-sliced threaded writers (KtabDirectWriter
    with write_stub=False) finish their ranges."""
    pindex = np.cumsum(np.asarray(pindex_counts, dtype=np.int64))
    with open(stub_path(path, ".ktab"), "wb") as f:
        f.write(struct.pack("<iiii", kmer, nparts, minval, ibyte))
        pindex.astype("<i8").tofile(f)


def write_ktab(
    path: str,
    table: KmerTable,
    nparts: int = 1,
    ibyte: Optional[int] = None,
) -> None:
    """Write stub + hidden parts (reference layout: table.c:162-533)."""
    n = len(table)
    kb = kbytes(table.kmer)
    if ibyte is None:
        ibyte = idx_bytes_for(n, table.kmer)
    pidxlen = 1 << (8 * ibyte)

    pv = _prefix_values(table.packed, ibyte) if n else np.zeros(0, np.int64)
    pindex = np.bincount(pv, minlength=pidxlen).astype(np.int64) if n else np.zeros(pidxlen, np.int64)
    np.cumsum(pindex, out=pindex)

    cuts = [0] + part_splits(pv, pidxlen, nparts) + [n]

    with open(stub_path(path, ".ktab"), "wb") as f:
        f.write(struct.pack("<iiii", table.kmer, nparts, table.minval, ibyte))
        pindex.astype("<i8").tofile(f)

    for p in range(nparts):
        lo, hi = cuts[p], cuts[p + 1]
        m = hi - lo
        rec = np.empty((m, (kb - ibyte) + 2), dtype=np.uint8)
        rec[:, : kb - ibyte] = table.packed[lo:hi, ibyte:]
        rec[:, kb - ibyte:] = (
            table.counts[lo:hi].astype("<u2").view(np.uint8).reshape(m, 2)
        )
        with open(part_path(path, ".ktab", p + 1), "wb") as f:
            f.write(struct.pack("<i", table.kmer))
            f.write(struct.pack("<q", m))
            rec.tofile(f)


def _read_stub(path: str):
    with open(stub_path(path, ".ktab"), "rb") as f:
        kmer, nparts, minval, ibyte = struct.unpack("<iiii", f.read(16))
        pindex = np.fromfile(f, dtype="<i8", count=1 << (8 * ibyte))
    return kmer, nparts, minval, ibyte, pindex


def read_ktab(path: str) -> KmerTable:
    """Load a full table into memory, re-attaching excised prefixes
    (reference: Load_Kmer_Table libfastk.c:380-546)."""
    kmer, nparts, minval, ibyte, pindex = _read_stub(path)
    kb = kbytes(kmer)
    sbyte = kb - ibyte
    total = int(pindex[-1])

    packed = np.empty((total, kb), dtype=np.uint8)
    counts = np.empty(total, dtype=np.uint16)

    # prefix of ordinal j: smallest i with pindex[i] > j
    if total:
        ords = np.arange(total, dtype=np.int64)
        pvals = np.searchsorted(pindex, ords, side="right")
        for j in range(ibyte):
            packed[:, j] = (pvals >> (8 * (ibyte - 1 - j))) & 0xFF

    off = 0
    for p in range(nparts):
        fn = part_path(path, ".ktab", p + 1)
        with open(fn, "rb") as f:
            (k2,) = struct.unpack("<i", f.read(4))
            (m,) = struct.unpack("<q", f.read(8))
            if k2 != kmer:
                raise ValueError(f"part {fn} kmer {k2} != stub {kmer}")
            rec = np.fromfile(f, dtype=np.uint8, count=m * (sbyte + 2))
        rec = rec.reshape(m, sbyte + 2)
        packed[off: off + m, ibyte:] = rec[:, :sbyte]
        counts[off: off + m] = rec[:, sbyte:].copy().view("<u2").ravel()
        off += m
    if off != total:
        raise ValueError(f"parts hold {off} entries, stub says {total}")
    return KmerTable(kmer, minval, packed, counts)


class KmerStream:
    """Buffered sequential scan over a table's parts with random access
    (reference: Kmer_Stream, libfastk.h:76-96, libfastk.c:774-1470).

    Iterates (packed_kmer, count) in sorted order without loading the whole
    table; supports goto_index and goto_kmer via the stub prefix index.
    """

    def __init__(self, path: str):
        self.path = path
        (self.kmer, self.nparts, self.minval, self.ibyte, self._pindex) = _read_stub(path)
        self.kbyte = kbytes(self.kmer)
        self.sbyte = self.kbyte - self.ibyte
        self.nels = int(self._pindex[-1])
        self._maps: List[np.ndarray] = []
        self._bases: List[int] = [0]
        for p in range(self.nparts):
            fn = part_path(path, ".ktab", p + 1)
            with open(fn, "rb") as f:
                f.read(4)
                (m,) = struct.unpack("<q", f.read(8))
            mm = np.memmap(fn, dtype=np.uint8, mode="r", offset=12)
            self._maps.append(mm.reshape(m, self.sbyte + 2) if m else mm.reshape(0, self.sbyte + 2))
            self._bases.append(self._bases[-1] + m)
        self.idx = 0

    # -- positioning ---------------------------------------------------------

    def goto_index(self, i: int) -> None:
        self.idx = int(i)

    def goto_kmer(self, q) -> None:
        """Position at the first entry >= q (reference: GoTo_Kmer_Entry,
        libfastk.c:1383-1470)."""
        if isinstance(q, str):
            q = pack_kmer(q)
        q = np.asarray(q, dtype=np.uint8)
        pv = 0
        for j in range(self.ibyte):
            pv = (pv << 8) | int(q[j])
        lo = int(self._pindex[pv - 1]) if pv > 0 else 0
        hi = int(self._pindex[pv])
        suf = bytes(q[self.ibyte:])
        while lo < hi:
            mid = (lo + hi) // 2
            if bytes(self._entry_suffix(mid)) < suf:
                lo = mid + 1
            else:
                hi = mid
        self.idx = lo

    # -- access --------------------------------------------------------------

    def _locate(self, i: int) -> tuple[int, int]:
        p = int(np.searchsorted(self._bases, i, side="right")) - 1
        if p >= self.nparts:
            p = self.nparts - 1
        return p, i - self._bases[p]

    def _entry_suffix(self, i: int) -> np.ndarray:
        p, j = self._locate(i)
        return self._maps[p][j, : self.sbyte]

    def _prefix_of(self, i: int) -> int:
        return int(np.searchsorted(self._pindex, i, side="right"))

    def current_entry(self) -> tuple[np.ndarray, int]:
        i = self.idx
        p, j = self._locate(i)
        row = self._maps[p][j]
        pv = self._prefix_of(i)
        packed = np.empty(self.kbyte, dtype=np.uint8)
        for b in range(self.ibyte):
            packed[b] = (pv >> (8 * (self.ibyte - 1 - b))) & 0xFF
        packed[self.ibyte:] = row[: self.sbyte]
        cnt = int(row[self.sbyte]) | (int(row[self.sbyte + 1]) << 8)
        return packed, cnt

    def current_kmer(self) -> str:
        packed, _ = self.current_entry()
        return kmer_to_string(packed, self.kmer)

    def next(self) -> None:
        self.idx += 1

    @property
    def exhausted(self) -> bool:
        return self.idx >= self.nels

    def __iter__(self) -> Iterator[tuple[np.ndarray, int]]:
        while not self.exhausted:
            yield self.current_entry()
            self.next()

    # -- bulk (vectorized) ---------------------------------------------------

    def read_range(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        """Materialize entries [lo, hi) as (packed (m,kbyte), counts (m,))."""
        from fastk_tpu_torch import native

        res = native.read_range(self.kbyte, self.ibyte, self._maps,
                                self._pindex, lo, hi)
        if res is not None:
            return res
        m = hi - lo
        packed = np.empty((m, self.kbyte), dtype=np.uint8)
        counts = np.empty(m, dtype=np.uint16)
        ords = np.arange(lo, hi, dtype=np.int64)
        pvals = np.searchsorted(self._pindex, ords, side="right")
        for b in range(self.ibyte):
            packed[:, b] = (pvals >> (8 * (self.ibyte - 1 - b))) & 0xFF
        done = 0
        while done < m:
            p, j = self._locate(lo + done)
            take = min(m - done, self._maps[p].shape[0] - j)
            rows = self._maps[p][j: j + take]
            packed[done: done + take, self.ibyte:] = rows[:, : self.sbyte]
            counts[done: done + take] = np.ascontiguousarray(rows[:, self.sbyte:]).view("<u2").ravel()
            done += take
        return packed, counts
