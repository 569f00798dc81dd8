"""Host-side sequence ingestion: FASTA/FASTQ → code arrays for the device.

The device consumes a flat uint8 code stream: acgt/ACGT → 0..3, every other
byte (N, separators) → 4 (the invalid sentinel). Reads are joined with a
single sentinel so windows never span reads, mirroring the reference's
0-terminated DATA_BLOCK packing (reference: io.c:296-333, FastK.h:87-98).

Homopolymer compression (-c) drops bytes equal to the previous RAW byte,
case-sensitively, exactly like the reference's ADD macro (io.c:557-570).
"""

from __future__ import annotations

import gzip
import mmap
import os
import re
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

from fastk_tpu_torch import trace

SENTINEL = 4

CODE_TABLE = np.full(256, SENTINEL, dtype=np.uint8)
for _i, _b in enumerate("acgt"):
    CODE_TABLE[ord(_b)] = _i
    CODE_TABLE[ord(_b.upper())] = _i


def _open(path: str):
    if path.endswith(".gz"):
        from fastk_tpu_torch.io.bgzf import open_gz

        return open_gz(path)  # block-parallel when the .gz is BGZF-framed
    return open(path, "rb")


def detect_format(path: str) -> str:
    """File-type resolution by suffix, with the reference's 17-variant
    suffix table reduced to its stem cases (reference: io.c:72-79,137-258)."""
    p = path[:-3] if path.endswith(".gz") else path
    if p.endswith((".fastq", ".fq")):
        return "fastq"
    if p.endswith((".fasta", ".fa", ".fna")):
        return "fasta"
    if p.endswith((".sam",)):
        return "sam"
    if p.endswith((".bam",)):
        return "bam"
    if p.endswith((".cram",)):
        return "cram"
    if p.endswith((".db", ".dam")):
        return "dazz"
    # headerless default: sniff first byte
    with _open(path) as f:
        c = f.read(1)
    if c == b">":
        return "fasta"
    if c == b"@":
        return "fastq"
    raise ValueError(f"cannot determine sequence format of {path}")


def iter_reads(path: str) -> Iterator[bytes]:
    """Yield raw (case-preserving) read sequences from FASTA or FASTQ."""
    fmt = detect_format(path)
    if fmt == "fasta":
        yield from _iter_fasta(path)
    elif fmt == "fastq":
        yield from _iter_fastq(path)
    elif fmt in ("sam", "bam"):
        from fastk_tpu_torch.io.sam import iter_sam_reads

        yield from iter_sam_reads(path, fmt)
    elif fmt == "dazz":
        from fastk_tpu_torch.io.dazz import iter_dazz_reads

        yield from iter_dazz_reads(path)
    elif fmt == "cram":
        from fastk_tpu_torch.io.cram import iter_cram_reads

        yield from iter_cram_reads(path)
    else:
        raise NotImplementedError(f"{fmt} input not supported yet")


def _iter_fasta(path: str) -> Iterator[bytes]:
    cur: List[bytes] = []
    with _open(path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(b">"):
                if cur:
                    yield b"".join(cur)
                    cur = []
            else:
                cur.append(line)
    if cur:
        yield b"".join(cur)


def _iter_fastq(path: str) -> Iterator[bytes]:
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                return
            seq = f.readline().rstrip()
            f.readline()
            f.readline()
            yield seq


def homopoly_compress_bytes(seq: np.ndarray) -> np.ndarray:
    """Case-sensitive raw-byte homopolymer compression (-c)."""
    if len(seq) == 0:
        return seq
    keep = np.ones(len(seq), dtype=bool)
    keep[1:] = seq[1:] != seq[:-1]
    return seq[keep]


@dataclass
class ReadBatch:
    """A block of reads packed for the device.

    codes: uint8 [total]; reads joined by one SENTINEL, NOT terminated at the
           very start; the tail is padded with SENTINEL up to ``size``.
    boff:  int64 [nreads+1]; read r occupies codes[boff[r] : boff[r]+rlen[r]].
    rlen:  int64 [nreads] raw (possibly compressed) read lengths.
    more:  True where the reader knows that reads follow: it cut the batch
           before a read that did not fit. False where it cannot tell.
    """

    codes: np.ndarray
    boff: np.ndarray
    rlen: np.ndarray
    more: bool = False

    @property
    def nreads(self) -> int:
        return len(self.rlen)

    @property
    def totlen(self) -> int:
        return int(self.rlen.sum())


def pack_reads(reads: List[bytes], hc: bool = False, bc: int = 0,
               pad_to: int | None = None) -> ReadBatch:
    """Pack raw read strings into a device-ready code stream.

    bc: drop this many leading bases of each read (barcodes); applied AFTER
    homopolymer compression, matching the reference (split.c:1075 skips
    BC_PREFIX on the already-compressed DATA_BLOCK)."""
    arrs = []
    for r in reads:
        a = np.frombuffer(r, dtype=np.uint8)
        if hc:
            a = homopoly_compress_bytes(a)
        if bc:
            a = a[bc:]
        arrs.append(CODE_TABLE[a])
    rlen = np.array([len(a) for a in arrs], dtype=np.int64)
    boff = np.zeros(len(arrs) + 1, dtype=np.int64)
    np.cumsum(rlen + 1, out=boff[1:])  # +1 sentinel after each read
    total = int(boff[-1])
    size = total if pad_to is None else max(total, pad_to)
    codes = np.full(size, SENTINEL, dtype=np.uint8)
    for a, o in zip(arrs, boff[:-1]):
        codes[o: o + len(a)] = a
    return ReadBatch(codes=codes, boff=boff, rlen=rlen)


def read_file(path: str, hc: bool = False) -> ReadBatch:
    return pack_reads(list(iter_reads(path)), hc=hc)


INGEST_CHUNK = 32 << 20  # raw bytes per streamed read() chunk
NL_BLOCK = 1 << 18  # bytes a FASTQ newline count compares at once
_TEXT = re.compile(rb"\S")  # a byte that bytes.strip() keeps


def _read_into(f, view) -> int:
    """Fill `view` from `f` as one f.read(len(view)) would, short only at
    the end of the input. Traced: the span reader.raw (file read plus
    inflate) and the counter reader.text_bytes (bytes after inflate)."""
    n = 0
    with trace.span("reader.raw"):
        while n < len(view):
            got = f.readinto(view[n:])
            if not got:
                break
            n += got
    trace.count("reader.text_bytes", n)
    return n


def _disk_bytes(f, path: str) -> int:
    """Bytes of `path` read from disk so far through `f`, an object of
    _open: the plain file's position, the compressed file's under gzip, or
    the whole file once a BGZF stream (read ahead by its pool) is open."""
    raw = getattr(f, "fileobj", f)  # gzip.GzipFile reads its fileobj
    try:
        return raw.tell()
    except (OSError, ValueError):
        return os.path.getsize(path)


def _count_newlines(view) -> int:
    """Newlines in `view`, compared a cache-sized block at a time."""
    a = np.frombuffer(view, dtype=np.uint8)
    return sum(int(np.count_nonzero(a[i: i + NL_BLOCK] == 0x0A))
               for i in range(0, len(a), NL_BLOCK))


def _fastq_cut(buf, filled: int, nl: int) -> int:
    """The end of the last whole FASTQ record in buf[:filled], which holds
    nl newlines and starts at a record: just past its last newline whose
    ordinal is a multiple of four (-1 if it has fewer than four)."""
    if nl < 4:
        return -1
    pos = filled
    for _ in range(nl % 4 + 1):
        pos = buf.rfind(b"\n", 0, pos)
    return pos + 1


def _buffer(size: int) -> mmap.mmap:
    """A buffer of `size` bytes whose pages the OS maps in as they are
    first written: private anonymous memory, in huge pages where the OS
    gives them on request (fewer faults than a malloc'd bytes object)."""
    buf = mmap.mmap(-1, size, flags=mmap.MAP_PRIVATE)
    buf.madvise(mmap.MADV_HUGEPAGE)
    return buf


def _carried(buf, start: int, n: int, size: int) -> mmap.mmap:
    """A new buffer of `size` bytes that starts with buf[start: start + n]."""
    new = _buffer(size)
    memoryview(new)[:n] = memoryview(buf)[start: start + n]
    return new


def _record_chunks(path: str, fmt: str,
                   chunk: int = INGEST_CHUNK) -> Iterator[memoryview]:
    """Yield views that each contain only WHOLE records: the record-
    boundary snap of the reference's input partitioner (io.c:409-498),
    applied at chunk seams instead of thread ranges. The file is streamed
    in chunks of `chunk` bytes (gzip'd or not), so nothing is ever
    whole-file resident (the reference byte-range-partitions inputs for
    the same reason, io.c:2280-2600).

    Each chunk is read (readinto) into a buffer of its own after the carry,
    the partial record the previous chunk left: the snap copies only the
    carry, into the next buffer. A view is never written again, and its
    buffer is freed with it. A record longer than a buffer grows it.

    FASTA: cut before the last header start ('\\n>' -- a '>' can only start
    a line in a header). FASTQ: cut after the last 4k-th newline (the carry
    always begins at a record boundary, so the newline count mod 4 is
    cut-invariant; '@' may appear inside quality lines, so newlines are the
    only safe anchor).

    Traced: the spans reader.raw (each read) and reader.snap (the cut and
    the carry's copy); the counters reader.text_bytes and reader.file_bytes
    (bytes read from disk, compressed for a .gz)."""
    fastq = fmt == "fastq"
    buf = _buffer(chunk)
    carry = carry_nl = nl = 0  # the carry's bytes, and newlines (FASTQ)
    with _open(path) as f:
        try:
            while True:
                got = _read_into(f, memoryview(buf)[carry: carry + chunk])
                if not got:
                    break
                filled = carry + got
                with trace.span("reader.snap"):
                    if fastq:
                        nl = carry_nl + _count_newlines(
                            memoryview(buf)[carry: filled])
                        cut = _fastq_cut(buf, filled, nl)
                    else:
                        cut = buf.rfind(b"\n>", 0, filled)
                        if cut >= 0:
                            cut += 1  # keep the newline with the records
                    if cut < 0:  # no whole record yet: read on after it
                        carry, carry_nl = filled, nl
                        if len(buf) < carry + chunk:
                            buf = _carried(buf, 0, carry,
                                           max(2 * len(buf), carry + chunk))
                        continue
                    out = memoryview(buf)[:cut]
                    carry, carry_nl = filled - cut, nl % 4
                    buf = _carried(buf, cut, carry, carry + chunk)
                yield out
        finally:
            if trace.active():
                trace.count("reader.file_bytes", _disk_bytes(f, path))
    with trace.span("reader.snap"):
        last = memoryview(buf)[:carry]
        if _TEXT.search(last) is None:
            return
    yield last


def _ingest_threads() -> int:
    """Parser worker count (shared policy with the BGZF inflate pool).
    The native scanner runs with the GIL released (ctypes), so workers
    parse distinct record chunks truly in parallel — the reference's
    ITHREADS byte-range input data-parallelism (io.c:2280-2600), with the
    record-boundary snap done once at chunk seams instead of per thread."""
    from fastk_tpu_torch.io.bgzf import _ingest_threads as n

    return n()


def _pooled(chunks, parse_one):
    """Parse an iterator of record chunks with a bounded worker pool,
    yielding results in file order, each as soon as it and those before it
    are parsed; at most (workers + 1) raw chunks are in flight, so host
    memory stays O(workers * chunk) regardless of file size. Native parsers
    release the GIL (ctypes), so workers run truly in parallel — the
    reference's ITHREADS input data-parallelism (io.c:2280-2600) with the
    boundary snap done once at chunk seams.

    Traced: the main thread's time on the pool, the hand-off of each chunk
    (which starts a worker the first times) and the wait until a parsed
    piece is in hand, is the span reader.wait (the parse itself, with one
    worker)."""
    nw = _ingest_threads()
    if nw <= 1:
        def gen_serial():
            for buf in chunks:
                with trace.span("reader.wait"):
                    piece = parse_one(buf)
                yield piece

        return gen_serial()

    def gen():
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=nw) as pool:
            pending = deque()
            for buf in chunks:
                with trace.span("reader.wait"):
                    pending.append(pool.submit(parse_one, buf))
                del buf
                while pending and (len(pending) > nw or pending[0].done()):
                    with trace.span("reader.wait"):
                        piece = pending.popleft().result()
                    yield piece
            while pending:
                with trace.span("reader.wait"):
                    piece = pending.popleft().result()
                yield piece

    return gen()


def _scan_stream_native(path: str, fmt: str, hc: bool, bc: int):
    """Streamed native parse: yields (codes, boff, rlen) per record chunk,
    or None when unavailable (caller falls back to the Python parser)."""
    if fmt in ("bam", "sam"):
        from fastk_tpu_torch.io.sam import scan_stream_native

        return scan_stream_native(path, fmt, hc, bc)
    if fmt == "cram":
        from fastk_tpu_torch import native

        if native.load() is None:
            return None  # Python record iterator path
        from fastk_tpu_torch.io.cram_native import scan_cram_pieces

        return scan_cram_pieces(path, hc, bc)
    if fmt not in ("fasta", "fastq"):
        return None
    from fastk_tpu_torch import native

    if native.load() is None:
        return None

    def parse_one(buf: bytes):
        with trace.span("reader.parse"):
            piece = native.scan_seq(buf, fastq=(fmt == "fastq"), hc=hc,
                                    bc=bc)
            if piece is None:  # capacity edge: fall back for this buffer
                piece_reads = list(_iter_buffer(buf, fmt))
                b = pack_reads(piece_reads, hc=hc, bc=bc)
                piece = (b.codes, b.boff, b.rlen)
        return piece

    return _pooled(_record_chunks(path, fmt), parse_one)


def _iter_buffer(buf: bytes, fmt: str) -> Iterator[bytes]:
    import io as _io

    f = _io.BytesIO(buf)
    if fmt == "fasta":
        cur: List[bytes] = []
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(b">"):
                if cur:
                    yield b"".join(cur)
                    cur = []
            else:
                cur.append(line)
        if cur:
            yield b"".join(cur)
    else:
        while True:
            h = f.readline()
            if not h:
                return
            seq = f.readline().rstrip()
            f.readline()
            f.readline()
            yield seq


class _PieceAccum:
    """Accumulate (codes, boff, rlen) pieces into ~batch_bases ReadBatches,
    splitting oversized pieces at read boundaries. Traced: the span
    reader.batch."""

    def __init__(self, batch_bases: int):
        self.batch_bases = batch_bases
        self.codes: List[np.ndarray] = []
        self.boffs: List[np.ndarray] = []
        self.rlens: List[np.ndarray] = []
        self.bases = 0

    def add(self, codes: np.ndarray, boff: np.ndarray, rlen: np.ndarray
            ) -> Iterator[ReadBatch]:
        lo = 0
        nreads = len(rlen)
        while lo < nreads:
            with trace.span("reader.batch"):
                want = self.batch_bases - self.bases
                # largest hi with boff[hi] - boff[lo] <= want, at least lo+1
                hi = int(np.searchsorted(boff, boff[lo] + want,
                                         side="right")) - 1
                hi = max(hi, lo + 1)
                if hi >= nreads and self.bases + int(
                        boff[nreads] - boff[lo]) < self.batch_bases:
                    hi = nreads  # piece exhausted below the batch target
                    self._push(codes, boff, rlen, lo, hi)
                    return
                hi = min(hi, nreads)
                self._push(codes, boff, rlen, lo, hi)
                batch = self.flush()
                batch.more = hi < nreads
            yield batch
            lo = hi

    def _push(self, codes, boff, rlen, lo, hi):
        self.codes.append(codes[boff[lo]: boff[hi]])
        self.boffs.append(np.asarray(boff[lo: hi + 1] - boff[lo]))
        self.rlens.append(np.asarray(rlen[lo:hi]))
        self.bases += int(boff[hi] - boff[lo])

    @property
    def nreads(self) -> int:
        return sum(len(r) for r in self.rlens)

    def flush(self) -> ReadBatch:
        if len(self.codes) == 1:
            batch = ReadBatch(self.codes[0], self.boffs[0], self.rlens[0])
        else:
            offs = np.cumsum([0] + [len(c) for c in self.codes])
            boff = np.concatenate(
                [b[:-1] + o for b, o in zip(self.boffs, offs[:-1])]
                + [np.array([offs[-1]], dtype=np.int64)])
            batch = ReadBatch(np.concatenate(self.codes), boff,
                              np.concatenate(self.rlens))
        self.codes, self.boffs, self.rlens, self.bases = [], [], [], 0
        return batch


def batched_reads(
    paths: List[str], batch_bases: int, hc: bool = False, bc: int = 0
) -> Iterator[Tuple[ReadBatch, int]]:
    """Stream ReadBatches of ~batch_bases each across input files.

    Yields (batch, first_read_ordinal). Reads are never split across batches
    (long-read splitting with a k-1 halo is handled at the device chunking
    layer, not here). FASTA/FASTQ parse through the native scanner over
    bounded streamed chunks — host memory stays O(batch) regardless of file
    size, gzip'd or not. A batch's ``more`` says where more reads are known
    to follow it. Traced: the counter reader.bases adds each batch's bases.
    """
    batches = _batched_reads(paths, batch_bases, hc, bc)
    try:
        for batch, ordinal in batches:
            trace.count("reader.bases", batch.totlen)
            yield batch, ordinal
    finally:
        batches.close()


def _batched_reads(paths, batch_bases, hc, bc):
    ordinal = 0
    accum = _PieceAccum(batch_bases)
    cur: List[bytes] = []
    cur_bases = 0
    for path in paths:
        fmt = detect_format(path)
        stream = _scan_stream_native(path, fmt, hc, bc)
        if stream is not None:
            if cur:  # flush python-path reads before native batches
                yield pack_reads(cur, hc=hc, bc=bc), ordinal
                ordinal += len(cur)
                cur, cur_bases = [], 0
            for codes, boff, rlen in stream:
                for batch in accum.add(codes, boff, rlen):
                    yield batch, ordinal
                    ordinal += batch.nreads
            continue
        if accum.nreads:  # flush native pieces before python-path reads
            with trace.span("reader.batch"):
                batch = accum.flush()
            yield batch, ordinal
            ordinal += batch.nreads
        for r in iter_reads(path):
            cur.append(r)
            cur_bases += len(r) + 1
            if cur_bases >= batch_bases:
                yield pack_reads(cur, hc=hc, bc=bc), ordinal
                ordinal += len(cur)
                cur, cur_bases = [], 0
    if accum.nreads:
        with trace.span("reader.batch"):
            batch = accum.flush()
        yield batch, ordinal
        ordinal += batch.nreads
    if cur:
        yield pack_reads(cur, hc=hc, bc=bc), ordinal
