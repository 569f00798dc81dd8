"""SAM/BAM sequence ingestion (host side).

Mirrors the reference's record semantics (io.c:1317-1501): alignment records
whose FLAG has 0x900 set (secondary 0x100 / supplementary 0x800) are skipped
so every template is counted exactly once; everything else contributes its
stored SEQ. BGZF is a sequence of gzip members, which Python's zlib/gzip
layer decodes directly (the reference uses libdeflate for the same blocks,
io.c:858-1078).

The two formats deliberately differ in the reference, and we match both
exactly: SAM text SEQ is mapped character-by-character through IUPAC_2_DNA
(io.c:1398-1477) so every record byte becomes a concrete lowercase base —
'N'/'R'/... become 'a', 'Y'/'S'/'B' 'c', 'K' 'g', digits '1'/'2'/'3' map to
'c'/'g'/'t' — and no SAM base is ever invalid; BAM 4-bit codes become the
IUPAC letters "=acmgrsvtwyhkdbn" (io.c:1313) and the non-acgt ones stay
invalid, breaking k-mer windows downstream.
"""

from __future__ import annotations

import gzip
import struct
from typing import Iterator

import numpy as np


def _iupac_2_dna() -> bytes:
    """The reference's SAM base-normalization table (io.c:1398-1423):
    ASCII 0-127 map to a concrete lowercase base ('a' by default), bytes
    >= 128 to NUL (invalid downstream, like the C table's implicit zeros).
    """
    t = bytearray(256)
    for i in range(128):
        t[i] = ord("a")
    for src, dst in ((b"1Bb", b"c"), (b"CcSsYy", b"c"), (b"2GgKk", b"g"),
                     (b"3Tt", b"t")):
        for c in src:
            t[c] = dst[0]
    return bytes(t)


_IUPAC_2_DNA = _iupac_2_dna()

# BAM 4-bit SEQ codes "=ACMGRSVTWYHKDBN" -> bytes; non-ACGT stays an
# ambiguity letter and codes as invalid downstream (reader.CODE_TABLE)
_NIB = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
_NIB_HI = _NIB[np.arange(256) >> 4]
_NIB_LO = _NIB[np.arange(256) & 0xF]

_SKIP_FLAGS = 0x900  # secondary | supplementary (reference io.c:1357,1466)


def _open(path: str):
    if path.endswith(".gz") or path.endswith(".bam"):
        from fastk_tpu_torch.io.bgzf import open_gz

        return open_gz(path)
    return open(path, "rb")


def iter_sam_reads(path: str, fmt: str) -> Iterator[bytes]:
    if fmt == "sam":
        yield from _iter_sam(path)
    else:
        yield from _iter_bam(path)


def _iter_sam(path: str) -> Iterator[bytes]:
    with _open(path) as f:
        for line in f:
            if line.startswith(b"@"):
                continue
            fields = line.rstrip(b"\n").split(b"\t")
            if len(fields) < 11:
                if line.strip():
                    raise ValueError(f"{path}: truncated SAM record")
                continue
            flag = int(fields[1])
            if flag & _SKIP_FLAGS:
                continue
            seq = fields[9]
            if seq != b"*":
                yield seq.translate(_IUPAC_2_DNA)


def _read_exact(f, n: int, path: str) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise ValueError(f"{path}: truncated BAM file")
    return b


def _bam_header_len(buf: bytes) -> int:
    """Byte length of the BAM header (magic + text + refs) or -1 when buf
    is too short to hold it all."""
    if len(buf) < 12:
        return -1
    if buf[:4] != b"BAM\x01":
        raise ValueError("not a BAM file (bad magic)")
    (l_text,) = struct.unpack_from("<i", buf, 4)
    off = 8 + l_text
    if len(buf) < off + 4:
        return -1
    (n_ref,) = struct.unpack_from("<i", buf, off)
    off += 4
    for _ in range(n_ref):
        if len(buf) < off + 4:
            return -1
        (l_name,) = struct.unpack_from("<i", buf, off)
        off += 4 + l_name + 4
        if len(buf) < off:
            return -1
    return off


def _bam_record_chunks(path: str) -> Iterator[bytes]:
    """Buffers of WHOLE BAM alignment records (header stripped): inflated
    BGZF chunks accumulate and cut at record boundaries via the native
    size-hop (fk_bam_cut) — no per-record Python."""
    from fastk_tpu_torch import native
    from fastk_tpu_torch.io.bgzf import iter_bgzf_chunks, is_bgzf

    chunks = (iter_bgzf_chunks(path) if is_bgzf(path)
              else _raw_gz_chunks(path))
    carry = b""
    hdr_done = False
    for c in chunks:
        buf = carry + c if carry else c
        if not hdr_done:
            hlen = _bam_header_len(buf)
            if hlen < 0:
                carry = buf
                continue
            buf = buf[hlen:]
            hdr_done = True
        cut = native.bam_cut(buf)
        if cut:
            yield buf[:cut]
        carry = buf[cut:]
    if not hdr_done:
        if _bam_header_len(carry) != len(carry):
            raise ValueError(f"{path}: truncated BAM file")
        return
    if carry:
        raise ValueError(f"{path}: truncated BAM file")


def _raw_gz_chunks(path: str, chunk: int = 8 << 20) -> Iterator[bytes]:
    with _open(path) as f:
        while True:
            b = f.read(chunk)
            if not b:
                return
            yield b


def _sam_line_chunks(path: str, chunk: int = 16 << 20) -> Iterator[bytes]:
    """Buffers of whole SAM lines (the record-boundary snap at chunk
    seams; the final buffer may lack a trailing newline)."""
    carry = b""
    with _open(path) as f:
        while True:
            raw = f.read(chunk)
            if not raw:
                break
            buf = carry + raw if carry else raw
            cut = buf.rfind(b"\n") + 1
            if cut == 0:
                carry = buf
                continue
            yield buf[:cut]
            carry = buf[cut:]
    if carry:
        yield carry


def scan_stream_native(path: str, fmt: str, hc: bool, bc: int):
    """Streamed native BAM/SAM parse: a generator of (codes, boff, rlen)
    pieces, or None when the native library is unavailable (callers fall
    back to the per-record Python iterators). Chunks are parsed by the
    shared bounded worker pool — the reference scans both formats with
    threaded C the same way (io.c:1317-1654)."""
    from fastk_tpu_torch import native

    if native.load() is None:
        return None

    from fastk_tpu_torch.io.reader import pack_reads

    if fmt == "bam":
        chunks = _bam_record_chunks(path)

        def parse_one(buf: bytes):
            piece = native.scan_bam(buf, hc=hc, bc=bc)
            if piece is None:  # capacity edge: this buffer via Python
                b = pack_reads(list(_iter_bam_buffer(buf)), hc=hc, bc=bc)
                return b.codes, b.boff, b.rlen
            codes, boff, rlen, consumed = piece
            assert consumed == len(buf)  # producer cut at record bounds
            return codes, boff, rlen
    else:
        chunks = _sam_line_chunks(path)

        def parse_one(buf: bytes):
            piece = native.scan_sam(buf, hc=hc, bc=bc, final=True)
            if piece is None:
                b = pack_reads(list(_iter_sam_buffer(buf)), hc=hc, bc=bc)
                return b.codes, b.boff, b.rlen
            codes, boff, rlen, consumed = piece
            assert consumed == len(buf)
            return codes, boff, rlen

    from fastk_tpu_torch.io.reader import _pooled

    return _pooled(chunks, parse_one)


def _iter_bam_buffer(buf: bytes) -> Iterator[bytes]:
    """Reads from a buffer of whole raw BAM records (no header) — the
    per-buffer Python fallback behind the native scanner."""
    pos = 0
    n = len(buf)
    while pos + 4 <= n:
        (block_size,) = struct.unpack_from("<i", buf, pos)
        rec = buf[pos + 4: pos + 4 + block_size]
        pos += 4 + block_size
        l_read_name = rec[8]
        n_cigar_op, flag = struct.unpack_from("<HH", rec, 12)
        (l_seq,) = struct.unpack_from("<i", rec, 16)
        if flag & _SKIP_FLAGS or l_seq <= 0:
            continue
        off = 32 + l_read_name + 4 * n_cigar_op
        nb = (l_seq + 1) // 2
        packed = np.frombuffer(rec, dtype=np.uint8, count=nb, offset=off)
        seq = np.empty(2 * nb, dtype=np.uint8)
        seq[0::2] = _NIB_HI[packed]
        seq[1::2] = _NIB_LO[packed]
        yield seq[:l_seq].tobytes()


def _iter_sam_buffer(buf: bytes) -> Iterator[bytes]:
    """Reads from a buffer of whole SAM lines — the per-buffer Python
    fallback behind the native scanner."""
    for line in buf.split(b"\n"):
        if not line or line.startswith(b"@"):
            continue
        fields = line.split(b"\t")
        if len(fields) < 11:
            if line.strip():
                raise ValueError("truncated SAM record")
            continue
        flag = int(fields[1])
        if flag & _SKIP_FLAGS:
            continue
        seq = fields[9]
        if seq and seq != b"*":
            yield seq.translate(_IUPAC_2_DNA)


def _iter_bam(path: str) -> Iterator[bytes]:
    with _open(path) as f:
        magic = _read_exact(f, 4, path)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file (bad magic)")
        (l_text,) = struct.unpack("<i", _read_exact(f, 4, path))
        f.read(l_text)
        (n_ref,) = struct.unpack("<i", _read_exact(f, 4, path))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", _read_exact(f, 4, path))
            f.read(l_name + 4)
        while True:
            hdr = f.read(4)
            if not hdr:
                return
            if len(hdr) != 4:
                raise ValueError(f"{path}: truncated BAM file")
            (block_size,) = struct.unpack("<i", hdr)
            rec = _read_exact(f, block_size, path)
            l_read_name = rec[8]
            n_cigar_op, flag = struct.unpack_from("<HH", rec, 12)
            (l_seq,) = struct.unpack_from("<i", rec, 16)
            if flag & _SKIP_FLAGS or l_seq <= 0:
                continue
            off = 32 + l_read_name + 4 * n_cigar_op
            nb = (l_seq + 1) // 2
            packed = np.frombuffer(rec, dtype=np.uint8, count=nb, offset=off)
            seq = np.empty(2 * nb, dtype=np.uint8)
            seq[0::2] = _NIB_HI[packed]
            seq[1::2] = _NIB_LO[packed]
            yield seq[:l_seq].tobytes()
