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
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

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
    """

    codes: np.ndarray
    boff: np.ndarray
    rlen: np.ndarray

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


def _stream_raw(path: str, chunk: int = INGEST_CHUNK) -> Iterator[bytes]:
    """Stream a (possibly gzip'd) file in bounded chunks — nothing is ever
    whole-file resident (the reference byte-range-partitions inputs for the
    same reason, io.c:2280-2600)."""
    with _open(path) as f:
        while True:
            b = f.read(chunk)
            if not b:
                return
            yield b


def _record_chunks(path: str, fmt: str,
                   chunk: int = INGEST_CHUNK) -> Iterator[bytes]:
    """Yield buffers that each contain only WHOLE records: the record-
    boundary snap of the reference's input partitioner (io.c:409-498),
    applied at chunk seams instead of thread ranges.

    FASTA: cut before the last header start ('\\n>' — a '>' can only start
    a line in a header). FASTQ: cut after every 4th newline (carry always
    begins at a record boundary, so newline count mod 4 is cut-invariant;
    '@' may appear inside quality lines, so newlines are the only safe
    anchor)."""
    carry = b""
    for raw in _stream_raw(path, chunk):
        buf = carry + raw if carry else raw
        if fmt == "fasta":
            cut = buf.rfind(b"\n>")
            if cut < 0:
                carry = buf
                continue
            cut += 1  # keep the newline with the emitted records
        else:  # fastq
            arr = np.frombuffer(buf, dtype=np.uint8)
            nls = np.flatnonzero(arr == 0x0A)
            if len(nls) < 4:
                carry = buf
                continue
            last4 = (len(nls) // 4) * 4 - 1  # index of last 4k-th newline
            cut = int(nls[last4]) + 1
        yield buf[:cut]
        carry = buf[cut:]
    if carry and carry.strip():
        yield carry


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
    yielding results in file order; at most (workers + 1) raw chunks are
    in flight, so host memory stays O(workers * chunk) regardless of file
    size. Native parsers release the GIL (ctypes), so workers run truly
    in parallel — the reference's ITHREADS input data-parallelism
    (io.c:2280-2600) with the boundary snap done once at chunk seams."""
    nw = _ingest_threads()
    if nw <= 1:
        def gen_serial():
            for buf in chunks:
                yield parse_one(buf)

        return gen_serial()

    def gen():
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=nw) as pool:
            pending = deque()
            for buf in chunks:
                pending.append(pool.submit(parse_one, buf))
                del buf
                while len(pending) > nw:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

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
        piece = native.scan_seq(buf, fastq=(fmt == "fastq"), hc=hc, bc=bc)
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
    splitting oversized pieces at read boundaries."""

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
            want = self.batch_bases - self.bases
            # largest hi with boff[hi] - boff[lo] <= want, at least lo+1
            hi = int(np.searchsorted(boff, boff[lo] + want, side="right")) - 1
            hi = max(hi, lo + 1)
            if hi >= nreads and self.bases + int(
                    boff[nreads] - boff[lo]) < self.batch_bases:
                hi = nreads  # piece exhausted below the batch target
                self._push(codes, boff, rlen, lo, hi)
                return
            hi = min(hi, nreads)
            self._push(codes, boff, rlen, lo, hi)
            yield self.flush()
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
    size, gzip'd or not.
    """
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
        batch = accum.flush()
        yield batch, ordinal
        ordinal += batch.nreads
    if cur:
        yield pack_reads(cur, hc=hc, bc=bc), ordinal
