"""Native (C) host codecs, loaded via ctypes with transparent fallback.

The port's copy of ``fastk_tpu/native``: the host-side per-byte loops around
the device count (sequence parsing, 2-bit packing, profile encode and decode
— the parts the reference implements in io.c/split.c). ``fastk_native.c``
here is compiled on first use with the system C compiler into the port's
``_build/fastk_native.so``; if no compiler is available the callers silently
use their pure-Python implementations, which write the same bytes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "fastk_native.c")
_SO = os.path.join(os.path.dirname(_HERE), "_build", "fastk_native.so")

_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    cc = os.environ.get("CC", "cc")
    # build beside it and rename, so a process that loads the library
    # concurrently never maps a half-written file
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [cc, "-O2", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("FASTK_TPU_NO_NATIVE"):
        return None
    if not os.path.exists(_SO) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.fk_scan_seq.restype = ctypes.c_long
    lib.fk_scan_seq.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long]
    lib.fk_scan_bam.restype = ctypes.c_long
    lib.fk_scan_bam.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_void_p]
    lib.fk_scan_sam.restype = ctypes.c_long
    lib.fk_scan_sam.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
    lib.fk_cram_slice.restype = ctypes.c_long
    lib.fk_cram_slice.argtypes = [
        ctypes.c_void_p, ctypes.c_int,                     # encs
        ctypes.c_void_p, ctypes.c_void_p,                  # htab, hsym
        ctypes.c_void_p,                                   # series
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,    # tags
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,  # ext ptrs/lens
        ctypes.c_int,
        ctypes.c_void_p, ctypes.c_long,                    # core
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_long,    # ref window
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
        ctypes.c_int,                                      # per-ref table
        ctypes.c_void_p,                                   # subs
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64,                                    # flags, start
        ctypes.c_long, ctypes.c_int, ctypes.c_int,         # nrec, hc, bc
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long]
    lib.fk_symmex_bucket.restype = ctypes.c_long
    lib.fk_symmex_bucket.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p]
    lib.fk_bam_cut.restype = ctypes.c_long
    lib.fk_bam_cut.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.fk_pack2.restype = ctypes.c_long
    lib.fk_pack2.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_long]
    lib.fk_prof_decode.restype = ctypes.c_long
    lib.fk_prof_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
    lib.fk_rans_decode.restype = ctypes.c_long
    lib.fk_rans_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_long]
    lib.fk_union_slots.restype = ctypes.c_long
    lib.fk_union_slots.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.fk_prof_encode_bulk.restype = ctypes.c_long
    lib.fk_prof_encode_bulk.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
    lib.fk_read_range.restype = ctypes.c_long
    lib.fk_read_range.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p]
    lib.fk_merge_sum_rows.restype = ctypes.c_long
    lib.fk_merge_sum_rows.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.fk_writer_add.restype = None
    lib.fk_writer_add.argtypes = [
        ctypes.c_int, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.fk_merge_windows.restype = ctypes.c_long
    lib.fk_merge_windows.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.fk_union_cvecs.restype = ctypes.c_long
    lib.fk_union_cvecs.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p]
    lib.fk_logex_windows.restype = ctypes.c_long
    lib.fk_logex_windows.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,          # kb, kmer, ns
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # cursor pack
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,                  # prog, prog_off
        ctypes.c_int, ctypes.c_int, ctypes.c_int64,        # nasg, gc, solo
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_long,    # out_recs, cap
        ctypes.c_void_p,                                   # h2
        ctypes.c_int, ctypes.c_int, ctypes.c_int,          # do_hist, lo, hi
        ctypes.c_void_p, ctypes.c_void_p,                  # hbins, hsum
        ctypes.c_void_p]                                   # out_u
    _lib = lib
    return _lib


def scan_seq(buf: bytes, fastq: bool, hc: bool = False, bc: int = 0
             ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Parse a whole FASTA/FASTQ buffer -> (codes, boff, rlen), or None if
    the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(buf)
    src = np.frombuffer(buf, dtype=np.uint8)
    codes = np.empty(n + 2, dtype=np.uint8)
    rcap = max(16, n // 4 + 16)
    boff = np.empty(rcap + 1, dtype=np.int64)
    rlen = np.empty(rcap, dtype=np.int64)
    r = lib.fk_scan_seq(
        src.ctypes.data, n, int(fastq), int(hc), int(bc),
        codes.ctypes.data, len(codes), boff.ctypes.data, rlen.ctypes.data,
        rcap)
    if r == -3:
        raise ValueError("malformed sequence file")
    if r < 0:  # capacity (shouldn't happen with these bounds)
        return None
    return codes[: int(boff[r])], boff[: r + 1].copy(), rlen[:r].copy()


def scan_bam(buf: bytes, hc: bool = False, bc: int = 0):
    """Parse whole BAM alignment records from `buf` (header stripped) ->
    (codes, boff, rlen, consumed_bytes); a trailing partial record is left
    for the caller to carry. None if the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(buf)
    src = np.frombuffer(buf, dtype=np.uint8)
    # <= 2 bases per payload byte, + 1 separator per record (>= 36 B each)
    codes = np.empty(2 * n + 16, dtype=np.uint8)
    rcap = max(16, n // 36 + 16)
    boff = np.empty(rcap + 1, dtype=np.int64)
    rlen = np.empty(rcap, dtype=np.int64)
    consumed = np.zeros(1, dtype=np.int64)
    r = lib.fk_scan_bam(src.ctypes.data, n, int(hc), int(bc),
                        codes.ctypes.data, len(codes), boff.ctypes.data,
                        rlen.ctypes.data, rcap, consumed.ctypes.data)
    if r == -3:
        raise ValueError("malformed BAM record")
    if r < 0:
        return None
    return (codes[: int(boff[r])], boff[: r + 1].copy(), rlen[:r].copy(),
            int(consumed[0]))


def cram_slice(encs: np.ndarray, htab: np.ndarray, hsym: np.ndarray,
               series: np.ndarray, tag_off: np.ndarray, tag_enc: np.ndarray,
               ext_bufs, core: bytes, ref: Optional[bytes], ref_start: int,
               refs, subs: bytes, rn_preserved: bool, ap_delta: bool,
               multi_ref: bool, slice_start: int, n_records: int,
               hc: bool, bc: int):
    """Decode one CRAM slice's records natively -> (codes, boff, rlen), or
    None when the native library is unavailable / the slice needs the
    Python decoder (unsupported feature, ref-window miss)."""
    lib = load()
    if lib is None:
        return None
    ext_arrs = [np.frombuffer(b, dtype=np.uint8) if len(b)
                else np.zeros(1, np.uint8) for b in ext_bufs]
    ext_ptrs = (ctypes.c_void_p * max(len(ext_arrs), 1))(
        *[a.ctypes.data for a in ext_arrs])
    ext_lens = np.array([len(b) for b in ext_bufs] or [0], dtype=np.int64)
    core_a = (np.frombuffer(core, dtype=np.uint8) if len(core)
              else np.zeros(1, np.uint8))
    ref_a = (np.frombuffer(ref, dtype=np.uint8) if ref else None)
    refs = refs or []
    ref_arrs = [np.frombuffer(b, dtype=np.uint8) if len(b)
                else np.zeros(1, np.uint8) for b in refs]
    ref_ptrs = (ctypes.c_void_p * max(len(ref_arrs), 1))(
        *[a.ctypes.data for a in ref_arrs])
    ref_lens = np.array([len(b) for b in refs] or [0], dtype=np.int64)
    subs_a = np.frombuffer(subs, dtype=np.uint8)
    ext_total = int(ext_lens.sum())
    ccap = max(1 << 20, 8 * ext_total + 4096)
    rcap = n_records + 1
    boff = np.empty(rcap + 1, dtype=np.int64)
    rlen = np.empty(rcap, dtype=np.int64)
    # -1 (codes buffer full) grows and retries: reference-reconstructed
    # reads can dwarf the external byte streams, so 8*ext_total is only a
    # guess. Growth is capped: past 2 GB per slice the input is not a sane
    # CRAM slice and the Python decoder takes over. Data-length errors in
    # the record walk return -6 (fkc_read_bytes), NOT -1 — growing the
    # buffer cannot fix malformed slice data, so those fall through to the
    # `r < 0` Python-fallback arm immediately.
    while ccap <= (1 << 31):
        codes = np.empty(ccap, dtype=np.uint8)
        r = lib.fk_cram_slice(
            encs.ctypes.data, len(encs), htab.ctypes.data, hsym.ctypes.data,
            series.ctypes.data, tag_off.ctypes.data, len(tag_off) - 1,
            tag_enc.ctypes.data, ext_ptrs, ext_lens.ctypes.data,
            len(ext_bufs), core_a.ctypes.data, len(core),
            ref_a.ctypes.data if ref_a is not None else None,
            ref_start, len(ref) if ref else 0,
            ref_ptrs, ref_lens.ctypes.data, len(refs),
            subs_a.ctypes.data,
            int(rn_preserved), int(ap_delta), int(multi_ref),
            slice_start, n_records,
            int(hc), int(bc), codes.ctypes.data, ccap, boff.ctypes.data,
            rlen.ctypes.data, rcap)
        if r == -1:
            ccap *= 4
            continue
        if r < 0:
            return None  # caller decodes this slice in Python
        return codes[: int(boff[r])], boff[: r + 1].copy(), rlen[:r].copy()
    return None


def symmex_bucket(fwd: np.ndarray, fc: np.ndarray, rc_rows: np.ndarray,
                  kb: int) -> Optional[np.ndarray]:
    """Sort one bucket's RC rows and merge with the sorted forward stream
    into writer rows (nf+nr, kb+2), or None if unavailable."""
    lib = load()
    if lib is None:
        return None
    fwd = np.ascontiguousarray(fwd, dtype=np.uint8)
    fc = np.ascontiguousarray(fc, dtype=np.uint16)
    rc_rows = np.ascontiguousarray(rc_rows, dtype=np.uint8)
    nf, nr = len(fc), len(rc_rows)
    tmp = np.empty_like(rc_rows)
    out = np.empty((nf + nr, kb + 2), dtype=np.uint8)
    lib.fk_symmex_bucket(kb, fwd.ctypes.data, fc.ctypes.data, nf,
                         rc_rows.ctypes.data, nr, tmp.ctypes.data,
                         out.ctypes.data)
    return out


def bam_cut(buf: bytes) -> Optional[int]:
    """Byte length of the largest whole-records prefix of a BAM alignment
    buffer (record-size hops only; no parsing). None if unavailable."""
    lib = load()
    if lib is None:
        return None
    src = np.frombuffer(buf, dtype=np.uint8)
    r = lib.fk_bam_cut(src.ctypes.data, len(src))
    if r == -3:
        raise ValueError("corrupt BAM record size")
    return int(r)


def scan_sam(buf: bytes, hc: bool = False, bc: int = 0,
             final: bool = False):
    """Parse SAM text lines from `buf` -> (codes, boff, rlen,
    consumed_bytes); a trailing partial line is carried unless `final`.
    None if the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(buf)
    src = np.frombuffer(buf, dtype=np.uint8)
    codes = np.empty(n + 16, dtype=np.uint8)
    rcap = max(16, n // 16 + 16)
    boff = np.empty(rcap + 1, dtype=np.int64)
    rlen = np.empty(rcap, dtype=np.int64)
    consumed = np.zeros(1, dtype=np.int64)
    r = lib.fk_scan_sam(src.ctypes.data, n, int(hc), int(bc), int(final),
                        codes.ctypes.data, len(codes), boff.ctypes.data,
                        rlen.ctypes.data, rcap, consumed.ctypes.data)
    if r == -3:
        raise ValueError("truncated SAM record")
    if r < 0:
        return None
    return (codes[: int(boff[r])], boff[: r + 1].copy(), rlen[:r].copy(),
            int(consumed[0]))


def pack2(codes: np.ndarray, ecap: int
          ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """2-bit pack (codes length must be a multiple of 4)."""
    lib = load()
    if lib is None:
        return None
    n = len(codes)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    packed = np.empty(n // 4, dtype=np.uint8)
    exc = np.empty(ecap, dtype=np.uint32)
    ne = lib.fk_pack2(codes.ctypes.data, n, packed.ctypes.data,
                      exc.ctypes.data, ecap)
    if ne < 0:
        return None
    return packed, exc, int(ne)


def prof_encode_bulk(cnts: np.ndarray, boff: np.ndarray, plen: np.ndarray
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Encode every read's profile in one call -> (blob bytes, end offsets),
    or None if the native library is unavailable.

    cnts: flat uint16 per-position counts; read r's profile is
    cnts[boff[r] : boff[r] + plen[r]] (plen <= 0 -> empty blob)."""
    lib = load()
    if lib is None:
        return None
    cnts = np.ascontiguousarray(cnts, dtype=np.uint16)
    boff = np.ascontiguousarray(boff, dtype=np.int64)
    plen = np.ascontiguousarray(plen, dtype=np.int64)
    nreads = len(plen)
    ocap = int(2 * np.maximum(plen, 0).sum() + 2 * nreads + 16)
    out = np.empty(ocap, dtype=np.uint8)
    offs = np.empty(max(nreads, 1), dtype=np.int64)
    total = lib.fk_prof_encode_bulk(
        cnts.ctypes.data, boff.ctypes.data, plen.ctypes.data, nreads,
        out.ctypes.data, ocap, offs.ctypes.data)
    if total < 0:
        return None
    return out[:total], offs[:nreads]


def union_slots(streams, kb: int):
    """K-way union of sorted-unique key streams -> (universe (U, kb) uint8,
    [slots_i int64] mapping each stream's keys to universe rows), or None if
    the native library is unavailable. Streams are (m_i, kb) uint8 arrays."""
    lib = load()
    if lib is None or len(streams) > 64:
        return None
    ns = len(streams)
    streams = [np.ascontiguousarray(s, dtype=np.uint8) for s in streams]
    lens = np.array([len(s) for s in streams], dtype=np.int64)
    total = int(lens.sum())
    out = np.empty((total, kb), dtype=np.uint8)
    slots = [np.empty(int(m), dtype=np.int64) for m in lens]
    kptr = (ctypes.c_void_p * ns)(*[s.ctypes.data for s in streams])
    sptr = (ctypes.c_void_p * ns)(*[a.ctypes.data for a in slots])
    u = lib.fk_union_slots(kb, ns, kptr, lens.ctypes.data,
                           out.ctypes.data, sptr)
    if u < 0:
        return None
    return out[:u], slots


def read_range(kb: int, ibyte: int, part_maps, pindex: np.ndarray,
               lo: int, hi: int
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Materialize table records [lo, hi) as (packed (m, kb) uint8 full
    keys, counts (m,) uint16) straight from the part memmaps + the stub's
    cumulative prefix index, or None if the native library is unavailable.
    part_maps are the KmerStream's (nels_p, sbyte+2) uint8 memmaps."""
    lib = load()
    if lib is None:
        return None
    m = hi - lo
    packed = np.empty((m, kb), dtype=np.uint8)
    counts = np.empty(m, dtype=np.uint16)
    lens = np.array([mm.shape[0] for mm in part_maps], dtype=np.int64)
    ptrs = (ctypes.c_void_p * len(part_maps))(
        *[mm.ctypes.data for mm in part_maps])
    pindex = np.ascontiguousarray(pindex, dtype=np.int64)
    r = lib.fk_read_range(kb, ibyte, len(part_maps), ptrs,
                          lens.ctypes.data, pindex.ctypes.data, len(pindex),
                          lo, hi, packed.ctypes.data, counts.ctypes.data)
    if r < 0:
        return None
    return packed, counts


def merge_sum_rows(streams, counts, kb: int
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """K-way merge of sorted-unique (keys, uint16 counts) streams with
    per-key count sums -> (union (U, kb) uint8, sums (U,) int32), or None
    if the native library is unavailable."""
    lib = load()
    if lib is None or len(streams) > 64:
        return None
    ns = len(streams)
    streams = [np.ascontiguousarray(s, dtype=np.uint8) for s in streams]
    counts = [np.ascontiguousarray(c, dtype=np.uint16) for c in counts]
    lens = np.array([len(s) for s in streams], dtype=np.int64)
    total = int(lens.sum())
    out = np.empty((total, kb), dtype=np.uint8)
    sums = np.empty(total, dtype=np.int32)
    kptr = (ctypes.c_void_p * ns)(*[s.ctypes.data for s in streams])
    cptr = (ctypes.c_void_p * ns)(*[c.ctypes.data for c in counts])
    u = lib.fk_merge_sum_rows(kb, ns, kptr, lens.ctypes.data, cptr,
                              out.ctypes.data, sums.ctypes.data)
    if u < 0:
        return None
    return out[:u], sums[:u]


def _cursor_args(streams, ranges):
    """Flatten KmerStream part maps + stub indexes + record ranges into the
    ctypes argument pack shared by the cursor-based kernels. Returns
    (args tuple, cap, keepalive list)."""
    ns = len(streams)
    all_parts = []
    part_off = np.zeros(ns + 1, dtype=np.int32)
    for i, s in enumerate(streams):
        all_parts.extend(s._maps)
        part_off[i + 1] = len(all_parts)
    part_ptrs = (ctypes.c_void_p * max(len(all_parts), 1))(
        *[mm.ctypes.data for mm in all_parts])
    part_nels = np.array([mm.shape[0] for mm in all_parts] or [0],
                         dtype=np.int64)
    pindexes = [np.ascontiguousarray(s._pindex, dtype=np.int64)
                for s in streams]
    pptr = (ctypes.c_void_p * ns)(*[p.ctypes.data for p in pindexes])
    plens = np.array([len(p) for p in pindexes], dtype=np.int64)
    ibytes = np.array([s.ibyte for s in streams], dtype=np.int32)
    lo = np.array([r[0] for r in ranges], dtype=np.int64)
    hi = np.array([r[1] for r in ranges], dtype=np.int64)
    cap = int((hi - lo).sum())
    args = (part_ptrs, part_nels.ctypes.data, part_off.ctypes.data,
            pptr, plens.ctypes.data, ibytes.ctypes.data, lo.ctypes.data,
            hi.ctypes.data)
    keep = (all_parts, part_off, part_nels, pindexes, plens, ibytes, lo, hi)
    return args, cap, keep


def merge_windows(streams, ranges, kb: int, h2: np.ndarray,
                  chist: np.ndarray) -> Optional[np.ndarray]:
    """Fused fastmerge window: k-way merge of KmerStream record ranges
    straight from the part memmaps into writer-format (U, kb+2) records
    with clipped summed counts, accumulating the writer's 2-byte-prefix
    histogram and the 32768-bin merged-count histogram in the same pass.
    ranges: per-stream (lo, hi) record ordinals. Returns the record rows,
    or None if the native library is unavailable."""
    lib = load()
    if lib is None or len(streams) > 64 or kb > 62:
        return None
    args, cap, keep = _cursor_args(streams, ranges)
    rec = np.empty((max(cap, 1), kb + 2), dtype=np.uint8)
    u = lib.fk_merge_windows(kb, len(streams), *args, rec.ctypes.data, cap,
                             h2.ctypes.data, chist.ctypes.data)
    if u < 0:
        return None
    return rec[:u]


def union_cvecs(streams, ranges, kb: int
                ) -> Optional[Tuple[np.ndarray, list]]:
    """Windowed k-way union with per-source aligned uint16 count vectors,
    straight from the part memmaps (the logex/vennex window input).
    Returns (universe (U, kb) uint8, [counts (U,) uint16 per source]), or
    None if the native library is unavailable."""
    lib = load()
    if lib is None or len(streams) > 64 or kb > 62:
        return None
    args, cap, keep = _cursor_args(streams, ranges)
    cap = max(cap, 1)
    keys = np.empty((cap, kb), dtype=np.uint8)
    cnts = np.empty((len(streams), cap), dtype=np.uint16)
    u = lib.fk_union_cvecs(kb, len(streams), *args, keys.ctypes.data, cap,
                           cnts.ctypes.data)
    if u < 0:
        return None
    return keys[:u], [cnts[i, :u] for i in range(len(streams))]


def logex_windows(streams, ranges, kb: int, kmer: int, progs,
                  need_gc: bool, solo_ok: int, do_table: bool, h2,
                  hist_range, hbins, hsum):
    """Fused logex window: stream per-source (lo, hi) cursor ranges
    through nasg compiled expression programs per union key
    (fk_logex_windows). progs: list of int32 RPN arrays
    (algebra.compile_program). When do_table, returns a list of
    writer-format (U_a, kb+2) record arrays (one per assignment) and
    accumulates h2 (nasg x 65536 prefix histogram) in place; hist_range
    (low, high) additionally accumulates hbins (nasg x span) and hsum
    (nasg x 2 boundary instance sums). Returns None if the native
    library is unavailable or inputs exceed engine limits."""
    lib = load()
    if lib is None or len(streams) > 64 or kb > 62 or len(progs) > 16:
        return None
    args, cap, keep = _cursor_args(streams, ranges)
    nasg = len(progs)
    prog = np.ascontiguousarray(np.concatenate(progs), dtype=np.int32)
    prog_off = np.zeros(nasg + 1, dtype=np.int64)
    np.cumsum([len(p) for p in progs], out=prog_off[1:])
    cap = max(cap, 1)
    out_u = np.zeros(nasg, dtype=np.int64)
    if do_table:
        recs = [np.empty((cap, kb + 2), dtype=np.uint8)
                for _ in range(nasg)]
        rptr = (ctypes.c_void_p * nasg)(*[r.ctypes.data for r in recs])
    else:
        recs = None
        rptr = None
    do_hist = hist_range is not None
    hlow, hhigh = hist_range if do_hist else (1, 1)
    r = lib.fk_logex_windows(
        kb, kmer, len(streams), *args,
        prog.ctypes.data, prog_off.ctypes.data, nasg, int(need_gc),
        int(solo_ok),
        rptr, cap, h2.ctypes.data if h2 is not None else None,
        int(do_hist), hlow, hhigh,
        hbins.ctypes.data if hbins is not None else None,
        hsum.ctypes.data if hsum is not None else None,
        out_u.ctypes.data)
    if r < 0:
        return None
    if not do_table:
        return []
    return [recs[a][: out_u[a]] for a in range(nasg)]


def writer_add(packed: np.ndarray, counts: np.ndarray, h2: np.ndarray
               ) -> Optional[np.ndarray]:
    """Assemble KtabWriter records (m, kb+2) from keys + counts and
    accumulate the 2-byte prefix histogram in-place, or None if the native
    library is unavailable."""
    lib = load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    counts = np.ascontiguousarray(counts, dtype=np.uint16)
    m, kb = packed.shape
    rec = np.empty((m, kb + 2), dtype=np.uint8)
    lib.fk_writer_add(kb, m, packed.ctypes.data, counts.ctypes.data,
                      rec.ctypes.data, h2.ctypes.data)
    return rec


def rans_decode(payload: bytes, order: int, out_sz: int) -> Optional[bytes]:
    """Decode a CRAM rANS-4x8 payload (bytes after the order/csize/usize
    header) -> out_sz decoded bytes, None if the native library is
    unavailable. Raises ValueError on malformed input."""
    lib = load()
    if lib is None:
        return None
    src = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(max(out_sz, 1), dtype=np.uint8)
    r = lib.fk_rans_decode(src.ctypes.data, len(src), int(order),
                           out.ctypes.data, out_sz)
    if r < 0:
        raise ValueError("malformed rANS stream")
    return out[:out_sz].tobytes()


def prof_decode(buf: np.ndarray, ocap: int) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    b = np.ascontiguousarray(buf, dtype=np.uint8)
    out = np.empty(ocap, dtype=np.uint16)
    m = lib.fk_prof_decode(b.ctypes.data, len(b), out.ctypes.data, ocap)
    if m < 0:
        raise ValueError("malformed profile")
    return out[:m]
