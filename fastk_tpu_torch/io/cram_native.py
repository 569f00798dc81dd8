"""Self-contained CRAM 3.0 decoder (host side) — no htslib.

Decodes the container/slice structure, the block codecs the htslib writer
emits (raw, gzip, rANS-4x8 order 0/1), the record data series, and
reference-based sequence reconstruction — everything needed to yield each
record's SEQ, which is all FastK consumes (the reference vendors the whole
of htslib for exactly this, io.c:1821-1990 + HTSLIB/cram/*).

Scope (gated, not pretended): CRAM 2.0/2.1/3.0 (v2 = no CRCs, ITF8 record
counters, UNMAPPED_SLICE headers, no EOF container in 2.0 — the same set the
reference's vendored htslib 1.10.2 reads); codecs EXTERNAL / HUFFMAN / BETA /
GAMMA / BYTE_ARRAY_LEN / BYTE_ARRAY_STOP; references from an embedded-ref
slice block, an external FASTA (FASTK_TPU_CRAM_REF), or none (no-ref /
unmapped records). Unsupported features raise CramUnsupported so the caller
can fall back to a system htslib if one is configured.

Format facts follow the CRAM 3.0 specification (ITF8/LTF8 varints,
container/block/slice layouts, rANS order-0/1 with 12-bit frequencies).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class CramError(ValueError):
    pass


class CramUnsupported(NotImplementedError):
    pass


# ---------------------------------------------------------------------------
# Varints
# ---------------------------------------------------------------------------

class ByteReader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def u8(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos: self.pos + n]
        if len(b) != n:
            raise CramError("truncated CRAM stream")
        self.pos += n
        return b

    def itf8(self) -> int:
        b = self.u8()
        if not b & 0x80:
            v = b
        elif not b & 0x40:
            v = (b & 0x3F) << 8 | self.u8()
        elif not b & 0x20:
            v = (b & 0x1F) << 16 | self.u8() << 8 | self.u8()
        elif not b & 0x10:
            v = (b & 0x0F) << 24 | self.u8() << 16 | self.u8() << 8 | self.u8()
        else:
            v = ((b & 0x0F) << 28 | self.u8() << 20 | self.u8() << 12
                 | self.u8() << 4 | (self.u8() & 0x0F))
        # ITF8 is a 32-bit signed quantity
        return v - (1 << 32) if v >= (1 << 31) else v

    def ltf8(self) -> int:
        b = self.u8()
        if b < 0x80:
            return b
        next_counts = [(0xC0, 1, 14), (0xE0, 2, 21), (0xF0, 3, 28),
                       (0xF8, 4, 35), (0xFC, 5, 42), (0xFE, 6, 49),
                       (0xFF, 7, 56)]
        for bound, extra, bits in next_counts:
            if b < bound:
                v = b
                for _ in range(extra):
                    v = (v << 8) | self.u8()
                return v & ((1 << bits) - 1)
        v = 0
        for _ in range(8):
            v = (v << 8) | self.u8()
        return v - (1 << 64) if v >= (1 << 63) else v

    @property
    def remaining(self) -> int:
        return len(self.buf) - self.pos


# ---------------------------------------------------------------------------
# rANS 4x8 (order 0 / order 1), 12-bit frequencies — htslib rans_static
# ---------------------------------------------------------------------------

_TF_SHIFT = 12
_TOTFREQ = 1 << _TF_SHIFT
_RANS_LOW = 1 << 23


def _read_freqs0(r: ByteReader, zero_is_total: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray, bytearray]:
    """Order-0 frequency table -> (F[256], C[256], lookup[4096]).

    Mirrors htslib rans_static.c: symbol-RLE table, cumulative start = the
    running total in visit order, totals of 4095 allowed historically (the
    last slot repeats), and — in order-1 context rows (zero_is_total) —
    F == 0 means the whole table."""
    F = np.zeros(256, np.uint32)
    C = np.zeros(256, np.uint32)
    lookup = bytearray(_TOTFREQ)
    x = 0
    j = r.u8()
    rle = 0
    while True:
        f = r.u8()
        if f >= 128:
            f = ((f & 0x7F) << 8) | r.u8()
        if f == 0 and zero_is_total:
            f = _TOTFREQ
        F[j] = f
        C[j] = x
        if x + f > _TOTFREQ:
            raise CramError("rANS frequencies exceed 4096")
        lookup[x: x + f] = bytes([j]) * f
        x += f
        if rle > 0:
            rle -= 1
            j += 1
            if j > 255:
                raise CramError("rANS symbol RLE past 255")
        else:
            nj = r.u8()
            if nj == j + 1:
                rle = r.u8()
            j = nj
        if j == 0:
            break
    if x < _TOTFREQ - 1 or x > _TOTFREQ:
        raise CramError("rANS frequencies do not sum to 4096")
    if x < _TOTFREQ:  # historically tables fill 4095, not 4096
        lookup[x] = lookup[x - 1]
    return F, C, lookup


def _rans_uncompress_o0(r: ByteReader, out_sz: int) -> bytes:
    F, C, lookup = _read_freqs0(r)
    states = [struct.unpack("<I", r.take(4))[0] for _ in range(4)]
    buf = r.buf
    pos = r.pos
    out = bytearray(out_sz)
    for i in range(out_sz):
        j = i & 3
        x = states[j]
        m = x & (_TOTFREQ - 1)
        s = lookup[m]
        out[i] = s
        x = int(F[s]) * (x >> _TF_SHIFT) + m - int(C[s])
        while x < _RANS_LOW and pos < len(buf):
            x = (x << 8) | buf[pos]
            pos += 1
        states[j] = x
    r.pos = pos
    return bytes(out)


def _read_freqs1(r: ByteReader):
    """Order-1 tables: ctx -> (F, C, lookup)."""
    tables: Dict[int, tuple] = {}
    i = r.u8()
    rle_i = 0
    while True:
        tables[i] = _read_freqs0(r, zero_is_total=True)
        if rle_i > 0:
            rle_i -= 1
            i += 1
            if i > 255:
                raise CramError("rANS context RLE past 255")
        else:
            ni = r.u8()
            if ni == i + 1:
                rle_i = r.u8()
            i = ni
        if i == 0:
            break
    return tables


def _rans_uncompress_o1(r: ByteReader, out_sz: int) -> bytes:
    tables = _read_freqs1(r)
    states = [struct.unpack("<I", r.take(4))[0] for _ in range(4)]
    buf = r.buf
    pos = r.pos
    out = bytearray(out_sz)
    isz4 = out_sz >> 2
    ctx = [0, 0, 0, 0]
    for i in range(isz4):
        for j in range(4):
            x = states[j]
            m = x & (_TOTFREQ - 1)
            F, C, lookup = tables.get(ctx[j]) or _missing_ctx(ctx[j])
            s = lookup[m]
            out[j * isz4 + i] = s
            x = int(F[s]) * (x >> _TF_SHIFT) + m - int(C[s])
            while x < _RANS_LOW and pos < len(buf):
                x = (x << 8) | buf[pos]
                pos += 1
            states[j] = x
            ctx[j] = int(s)
    # remainder decoded by state 3, context continues
    for i in range(4 * isz4, out_sz):
        x = states[3]
        m = x & (_TOTFREQ - 1)
        F, C, lookup = tables.get(ctx[3]) or _missing_ctx(ctx[3])
        s = lookup[m]
        out[i] = s
        x = int(F[s]) * (x >> _TF_SHIFT) + m - int(C[s])
        while x < _RANS_LOW and pos < len(buf):
            x = (x << 8) | buf[pos]
            pos += 1
        states[3] = x
        ctx[3] = int(s)
    r.pos = pos
    return bytes(out)


def _missing_ctx(c):
    raise CramError(f"rANS O1 context {c} missing from table")


def rans_uncompress(data: bytes, raw_size: int) -> bytes:
    r = ByteReader(data)
    order = r.u8()
    _csize = struct.unpack("<I", r.take(4))[0]
    usize = struct.unpack("<I", r.take(4))[0]
    if usize != raw_size:
        raise CramError("rANS size mismatch")
    if order in (0, 1):
        from fastk_tpu_torch import native
        try:
            out = native.rans_decode(data[r.pos:], order, usize)
        except ValueError as e:
            raise CramError(str(e)) from None
        if out is not None:
            return out
    if order == 0:
        return _rans_uncompress_o0(r, usize)
    if order == 1:
        return _rans_uncompress_o1(r, usize)
    raise CramUnsupported(f"rANS order {order}")


# ---------------------------------------------------------------------------
# Blocks and containers
# ---------------------------------------------------------------------------

BLOCK_RAW, BLOCK_GZIP, BLOCK_BZIP2, BLOCK_LZMA, BLOCK_RANS = range(5)
CT_FILE_HEADER, CT_COMPRESSION_HEADER = 0, 1
CT_MAPPED_SLICE, CT_UNMAPPED_SLICE, CT_EXTERNAL, CT_CORE = 2, 3, 4, 5


@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes
    rsize: int = -1  # uncompressed size (set by read_block_raw)


def read_block_raw(f, v3: bool = True) -> Block:
    """Read one block WITHOUT decompressing its payload (data holds the
    on-disk bytes; content_type/content_id parsed). rsize kept on the
    instance for the deferred inflate."""
    head = f.read(2)
    if len(head) < 2:
        raise CramError("truncated block")
    method, ctype = head[0], head[1]
    hdr = _FileITF8(f)
    content_id = hdr.itf8()
    csize = hdr.itf8()
    rsize = hdr.itf8()
    data = f.read(csize)
    if len(data) != csize:
        raise CramError("truncated block data")
    if v3:
        f.read(4)  # CRC32 (v3+ only; cram_io.c gates on major >= 3)
    b = Block(method, ctype, content_id, data)
    b.rsize = rsize
    return b


def inflate_block(b: Block) -> bytes:
    method, data, rsize = b.method, b.data, b.rsize
    if method == BLOCK_RAW:
        raw = data
    elif method == BLOCK_GZIP:
        raw = zlib.decompress(data, wbits=31)
    elif method == BLOCK_RANS:
        raw = rans_uncompress(data, rsize)
    elif method == BLOCK_BZIP2:
        import bz2

        raw = bz2.decompress(data)
    elif method == BLOCK_LZMA:
        import lzma

        raw = lzma.decompress(data)
    else:
        raise CramUnsupported(f"block compression method {method}")
    if len(raw) != rsize:
        raise CramError("block raw size mismatch")
    return raw


def read_block(f, v3: bool = True) -> Block:
    b = read_block_raw(f, v3)
    return Block(b.method, b.content_type, b.content_id, inflate_block(b))


class _FileITF8:
    """ITF8/LTF8 reads straight off a file object."""

    def __init__(self, f):
        self.f = f

    def u8(self) -> int:
        b = self.f.read(1)
        if not b:
            raise EOFError
        return b[0]

    def itf8(self) -> int:
        return ByteReader.itf8(self)  # type: ignore[arg-type]

    def ltf8(self) -> int:
        return ByteReader.ltf8(self)  # type: ignore[arg-type]

    def take(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise CramError("truncated")
        return b


@dataclass
class ContainerHeader:
    length: int
    ref_id: int
    start: int
    span: int
    n_records: int
    counter: int
    n_bases: int
    n_blocks: int
    landmarks: List[int]


def read_container_header(f, v3: bool = True) -> Optional[ContainerHeader]:
    raw = f.read(4)
    if len(raw) < 4:
        return None
    (length,) = struct.unpack("<i", raw)
    r = _FileITF8(f)
    try:
        ref_id = r.itf8()
    except EOFError:
        return None
    start = r.itf8()
    span = r.itf8()
    nrec = r.itf8()
    # record counter widened to LTF8 in v3 (cram_io.c version gate)
    counter = r.ltf8() if v3 else r.itf8()
    nbases = r.ltf8()
    nblocks = r.itf8()
    nland = r.itf8()
    landmarks = [r.itf8() for _ in range(nland)]
    if v3:
        f.read(4)  # CRC32
    return ContainerHeader(length, ref_id, start, span, nrec, counter,
                           nbases, nblocks, landmarks)


# ---------------------------------------------------------------------------
# Encodings (codecs)
# ---------------------------------------------------------------------------

ENC_NULL, ENC_EXTERNAL, ENC_GOLOMB, ENC_HUFFMAN, ENC_BYTE_ARRAY_LEN, \
    ENC_BYTE_ARRAY_STOP, ENC_BETA, ENC_SUBEXP, ENC_GOLOMB_RICE, \
    ENC_GAMMA = range(10)


class BitReader:
    """MSB-first bit reader over the core block."""

    __slots__ = ("buf", "pos", "bit")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.bit = 0

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.buf[self.pos]
            v = (v << 1) | ((byte >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v

    def read1(self) -> int:
        byte = self.buf[self.pos]
        v = (byte >> (7 - self.bit)) & 1
        self.bit += 1
        if self.bit == 8:
            self.bit = 0
            self.pos += 1
        return v


def parse_encoding(r: ByteReader) -> tuple:
    codec = r.itf8()
    size = r.itf8()
    body = ByteReader(r.take(size))
    if codec == ENC_NULL:
        return ("null",)
    if codec == ENC_EXTERNAL:
        return ("external", body.itf8())
    if codec == ENC_HUFFMAN:
        n = body.itf8()
        symbols = [body.itf8() for _ in range(n)]
        n2 = body.itf8()
        lengths = [body.itf8() for _ in range(n2)]
        return ("huffman", symbols, lengths, _huffman_codes(symbols, lengths))
    if codec == ENC_BYTE_ARRAY_LEN:
        len_enc = parse_encoding(body)
        val_enc = parse_encoding(body)
        return ("byte_array_len", len_enc, val_enc)
    if codec == ENC_BYTE_ARRAY_STOP:
        stop = body.u8()
        cid = body.itf8()
        return ("byte_array_stop", stop, cid)
    if codec == ENC_BETA:
        offset = body.itf8()
        nbits = body.itf8()
        return ("beta", offset, nbits)
    if codec == ENC_GAMMA:
        offset = body.itf8()
        return ("gamma", offset)
    if codec == ENC_SUBEXP:
        offset = body.itf8()
        k = body.itf8()
        return ("subexp", offset, k)
    raise CramUnsupported(f"encoding codec {codec}")


def _huffman_codes(symbols: List[int], lengths: List[int]):
    """Canonical Huffman codes, ties broken by SYMBOL VALUE (the CRAM
    canonical rule; htslib writes tables pre-sorted by (len, symbol) so
    list-order ties happen to agree, but other writers need not)."""
    items = sorted(
        range(len(symbols)), key=lambda i: (lengths[i], symbols[i]))
    items = [(lengths[i], i) for i in items]
    codes = {}
    code = 0
    prev_len = 0
    for ln, idx in items:
        code <<= (ln - prev_len)
        prev_len = ln
        codes[(ln, code)] = symbols[idx]
        code += 1
    return codes


class SliceDecoder:
    """Decodes values of one slice: external streams + shared core bits."""

    def __init__(self, core: BitReader, external: Dict[int, ByteReader]):
        self.core = core
        self.external = external

    def _ext(self, cid: int) -> ByteReader:
        try:
            return self.external[cid]
        except KeyError:
            raise CramError(f"missing external block {cid}")

    def read_int(self, enc: tuple) -> int:
        kind = enc[0]
        if kind == "external":
            return self._ext(enc[1]).itf8()
        if kind == "huffman":
            symbols, lengths, codes = enc[1], enc[2], enc[3]
            if len(symbols) == 1 and lengths[0] == 0:
                return symbols[0]
            code, ln = 0, 0
            while True:
                code = (code << 1) | self.core.read1()
                ln += 1
                if (ln, code) in codes:
                    return codes[(ln, code)]
                if ln > 31:
                    raise CramError("bad huffman stream")
        if kind == "beta":
            offset, nbits = enc[1], enc[2]
            return self.core.read(nbits) - offset
        if kind == "gamma":
            offset = enc[1]
            ln = 0
            while self.core.read1() == 0:
                ln += 1
            v = 1
            for _ in range(ln):
                v = (v << 1) | self.core.read1()
            return v - offset
        if kind == "subexp":
            offset, k = enc[1], enc[2]
            i = 0
            while self.core.read1() == 1:
                i += 1
            if i == 0:
                b = k
                n = self.core.read(b)
            else:
                b = i + k - 1
                n = (1 << b) | self.core.read(b)
            return n - offset
        raise CramUnsupported(f"int read from {kind}")

    def read_byte(self, enc: tuple) -> int:
        kind = enc[0]
        if kind == "external":
            return self._ext(enc[1]).u8()
        if kind == "huffman":
            return self.read_int(enc)
        if kind == "beta":
            return self.read_int(enc)
        raise CramUnsupported(f"byte read from {kind}")

    def read_bytes(self, enc: tuple, implicit_len: Optional[int] = None
                   ) -> bytes:
        kind = enc[0]
        if kind == "byte_array_stop":
            stop, cid = enc[1], enc[2]
            r = self._ext(cid)
            end = r.buf.index(bytes([stop]), r.pos)
            out = r.buf[r.pos: end]
            r.pos = end + 1
            return out
        if kind == "byte_array_len":
            n = self.read_int(enc[1])
            return self._read_n(enc[2], n)
        if kind == "external":
            if implicit_len is None:
                raise CramError("external byte array needs a length")
            return self._ext(enc[1]).take(implicit_len)
        raise CramUnsupported(f"byte array from {kind}")

    def _read_n(self, enc: tuple, n: int) -> bytes:
        if enc[0] == "external":
            return self._ext(enc[1]).take(n)
        return bytes(self.read_byte(enc) for _ in range(n))

    def read_byte_run(self, enc: tuple, n: int) -> bytes:
        """n consecutive read_byte values, bulk-sliced when the series is
        EXTERNAL (the per-base SEQ/QS path of unmapped records)."""
        return self._read_n(enc, n)

    def skip_byte_run(self, enc: tuple, n: int) -> None:
        """Consume n read_byte values whose payload is discarded."""
        if enc[0] == "external":
            r = self._ext(enc[1])
            if r.pos + n > len(r.buf):
                raise CramError("external block exhausted")
            r.pos += n
            return
        for _ in range(n):
            self.read_byte(enc)


# ---------------------------------------------------------------------------
# Compression header / slice header
# ---------------------------------------------------------------------------

@dataclass
class CompressionHeader:
    rn_preserved: bool = True
    ap_delta: bool = True
    rr_ref_required: bool = True
    sub_matrix: bytes = b"\x00" * 5
    tag_dict: List[List[int]] = field(default_factory=list)
    series: Dict[bytes, tuple] = field(default_factory=dict)
    tags: Dict[int, tuple] = field(default_factory=dict)


def parse_compression_header(data: bytes) -> CompressionHeader:
    r = ByteReader(data)
    h = CompressionHeader()
    # --- preservation map
    r.itf8()  # size in bytes
    n = r.itf8()
    for _ in range(n):
        key = bytes(r.take(2))
        if key == b"RN":
            h.rn_preserved = bool(r.u8())
        elif key == b"AP":
            h.ap_delta = bool(r.u8())
        elif key == b"RR":
            h.rr_ref_required = bool(r.u8())
        elif key == b"SM":
            h.sub_matrix = bytes(r.take(5))
        elif key == b"TD":
            tn = r.itf8()
            blob = r.take(tn)
            h.tag_dict = _parse_tag_dict(blob)
        else:
            raise CramUnsupported(f"preservation key {key!r}")
    # --- data series encodings
    r.itf8()
    n = r.itf8()
    for _ in range(n):
        key = bytes(r.take(2))
        h.series[key] = parse_encoding(r)
    # --- tag encodings
    r.itf8()
    n = r.itf8()
    for _ in range(n):
        key = r.itf8()
        h.tags[key] = parse_encoding(r)
    return h


def _parse_tag_dict(blob: bytes) -> List[List[int]]:
    """TD: \\0-separated lines of 3-byte tag keys."""
    lines: List[List[int]] = []
    for part in blob.split(b"\x00"):
        keys = [part[i] << 16 | part[i + 1] << 8 | part[i + 2]
                for i in range(0, len(part) - 2, 3)]
        lines.append(keys)
    if blob.endswith(b"\x00") and lines and lines[-1] == []:
        lines.pop()
    return lines


@dataclass
class SliceHeader:
    ref_id: int
    start: int
    span: int
    n_records: int
    counter: int
    n_blocks: int
    content_ids: List[int]
    embedded_ref_id: int


def parse_slice_header(data: bytes, v3: bool = True,
                       mapped: bool = True) -> SliceHeader:
    """Mapped slices carry ref_id/start/span and an embedded-ref block id;
    UNMAPPED_SLICE headers (content type 3, written by v2-era encoders)
    omit both (cram_decode.c:978-1037). The record counter is ITF8 in v2,
    LTF8 in v3."""
    r = ByteReader(data)
    if mapped:
        ref_id = r.itf8()
        start = r.itf8()
        span = r.itf8()
    else:
        ref_id, start, span = -1, 0, 0
    nrec = r.itf8()
    counter = r.ltf8() if v3 else r.itf8()
    nblocks = r.itf8()
    nids = r.itf8()
    ids = [r.itf8() for _ in range(nids)]
    emb = r.itf8() if mapped else -1
    r.take(16)  # MD5
    return SliceHeader(ref_id, start, span, nrec, counter, nblocks, ids, emb)


# ---------------------------------------------------------------------------
# Record decoding / sequence reconstruction
# ---------------------------------------------------------------------------

_BAM_FUNMAP = 0x4
_BAM_SECSUP = 0x900
_CF_QS_STORED = 0x1
_CF_DETACHED = 0x2
_CF_MATE_DOWNSTREAM = 0x4
_CF_NO_SEQ = 0x8

_BASES = b"ACGTN"


def _sub_decode_table(sm: bytes) -> Dict[Tuple[int, int], int]:
    """(ref base index, BS code) -> substituted base byte."""
    table = {}
    for ri in range(5):
        alts = [b for b in range(5) if b != ri]
        byte = sm[ri]
        for pos, alt in enumerate(alts):
            code = (byte >> (6 - 2 * pos)) & 3
            table[(ri, code)] = _BASES[alt]
    return table


_BASE_INDEX = {b: i for i, b in enumerate(_BASES)}


def _decode_slice_records(ch: CompressionHeader, sh: SliceHeader,
                          dec: SliceDecoder, refget, verify_flags=True
                          ) -> Iterator[Tuple[int, bytes]]:
    """Yield (bam_flags, seq bytes) per record of one slice."""
    S = ch.series
    subs = _sub_decode_table(ch.sub_matrix)
    last_pos = sh.start

    def want(key: bytes) -> tuple:
        e = S.get(key)
        if e is None or e[0] == "null":
            raise CramUnsupported(f"data series {key!r} missing")
        return e

    for _ in range(sh.n_records):
        bf = dec.read_int(want(b"BF"))
        cf = dec.read_int(want(b"CF"))
        ref_id = sh.ref_id
        if sh.ref_id == -2:
            ref_id = dec.read_int(want(b"RI"))
        rl = dec.read_int(want(b"RL"))
        if ch.ap_delta:
            last_pos += dec.read_int(want(b"AP"))
            pos = last_pos
        else:
            pos = dec.read_int(want(b"AP"))
        dec.read_int(want(b"RG"))
        if ch.rn_preserved:
            dec.read_bytes(want(b"RN"))
        if cf & _CF_DETACHED:
            dec.read_int(want(b"MF"))
            if not ch.rn_preserved:
                dec.read_bytes(want(b"RN"))
            dec.read_int(want(b"NS"))
            dec.read_int(want(b"NP"))
            dec.read_int(want(b"TS"))
        elif cf & _CF_MATE_DOWNSTREAM:
            dec.read_int(want(b"NF"))
        tl = dec.read_int(want(b"TL"))
        if 0 <= tl < len(ch.tag_dict):
            for key in ch.tag_dict[tl]:
                enc = ch.tags.get(key)
                if enc is None:
                    raise CramUnsupported(f"tag {key:06x} encoding missing")
                dec.read_bytes(enc)

        if bf & _BAM_FUNMAP:
            if cf & _CF_NO_SEQ:
                seq = b"N" * rl
            else:
                seq = dec.read_byte_run(want(b"BA"), rl)
            if cf & _CF_QS_STORED:
                dec.skip_byte_run(want(b"QS"), rl)
            yield bf, seq
            continue

        # ---- mapped record: features against the reference ----
        nfeat = dec.read_int(want(b"FN"))
        seq = bytearray(rl)
        have = 0  # bases of the read produced so far
        rpos = pos  # 1-based reference cursor
        no_seq = bool(cf & _CF_NO_SEQ)

        def ref_fill(n):
            nonlocal have, rpos
            if n <= 0:
                return
            if no_seq:
                seq[have: have + n] = b"N" * n
            else:
                seq[have: have + n] = refget(ref_id, rpos - 1, n)
            have += n
            rpos += n

        fpos = 0
        for _ in range(nfeat):
            code = dec.read_byte(want(b"FC"))
            fpos += dec.read_int(want(b"FP"))
            gap = fpos - 1 - have
            ref_fill(gap)
            c = chr(code)
            if c == "X":
                bs = dec.read_byte(want(b"BS"))
                if no_seq:
                    seq[have] = ord("N")
                else:
                    rb = refget(ref_id, rpos - 1, 1)[0]
                    seq[have] = subs[(_BASE_INDEX.get(rb, 4), bs)]
                have += 1
                rpos += 1
            elif c == "S":
                sc = dec.read_bytes(want(b"SC"))
                seq[have: have + len(sc)] = sc
                have += len(sc)
            elif c == "I":
                ins = dec.read_bytes(want(b"IN"))
                seq[have: have + len(ins)] = ins
                have += len(ins)
            elif c == "i":
                seq[have] = dec.read_byte(want(b"BA"))
                have += 1
            elif c == "b":
                bb = dec.read_bytes(want(b"BB"))
                seq[have: have + len(bb)] = bb
                have += len(bb)
                rpos += len(bb)
            elif c == "B":
                seq[have] = dec.read_byte(want(b"BA"))
                have += 1
                rpos += 1
                dec.read_byte(want(b"QS"))
            elif c == "q":
                dec.read_bytes(want(b"QQ"))
            elif c == "Q":
                dec.read_byte(want(b"QS"))
            elif c == "D":
                rpos += dec.read_int(want(b"DL"))
            elif c == "N":
                rpos += dec.read_int(want(b"RS"))
            elif c == "P":
                dec.read_int(want(b"PD"))
            elif c == "H":
                dec.read_int(want(b"HC"))
            else:
                raise CramUnsupported(f"feature code {c!r}")
        ref_fill(rl - have)
        dec.read_int(want(b"MQ"))
        if cf & _CF_QS_STORED:
            dec.skip_byte_run(want(b"QS"), rl)
        yield bf, bytes(seq)


# ---------------------------------------------------------------------------
# Reference lookup
# ---------------------------------------------------------------------------

class Reference:
    """Reference bases per ref id: from an embedded-ref block or an external
    FASTA (FASTK_TPU_CRAM_REF), matched to @SQ order in the SAM header."""

    def __init__(self, sq_names: List[str]):
        self.sq_names = sq_names
        self._fasta: Optional[Dict[str, bytes]] = None
        # (ref_id, start-1, seq) of the CURRENT slice's embedded block
        self._embedded: Optional[Tuple[int, int, bytes]] = None

    def set_embedded(self, ref_id: int, start: int,
                     data: Optional[bytes]) -> None:
        """Install (or, with data=None, clear) the embedded reference for
        the slice about to decode. Embedded blocks are slice-scoped: a
        stale window from a previous slice must never serve a different
        slice (let alone a different ref_id)."""
        self._embedded = None if data is None else (ref_id, start - 1, data)

    def _load_fasta(self) -> Dict[str, bytes]:
        if self._fasta is None:
            path = os.environ.get("FASTK_TPU_CRAM_REF")
            if not path:
                raise CramUnsupported(
                    "reference-compressed CRAM needs FASTK_TPU_CRAM_REF="
                    "<ref.fasta> (or a system htslib fallback)")
            seqs: Dict[str, bytes] = {}
            name = None
            chunks: List[bytes] = []
            with open(path, "rb") as f:
                for line in f:
                    line = line.rstrip()
                    if line.startswith(b">"):
                        if name is not None:
                            seqs[name] = b"".join(chunks).upper()
                        name = line[1:].split()[0].decode()
                        chunks = []
                    else:
                        chunks.append(line)
            if name is not None:
                seqs[name] = b"".join(chunks).upper()
            self._fasta = seqs
        return self._fasta

    def get(self, ref_id: int, off0: int, n: int) -> bytes:
        return self.get_with(self._embedded, ref_id, off0, n)

    def get_with(self, embedded, ref_id: int, off0: int, n: int) -> bytes:
        """get() against an EXPLICIT embedded window — thread-safe form
        for parallel per-slice decoding (no shared mutable state beyond
        the read-only FASTA dict)."""
        if embedded is not None and embedded[0] == ref_id:
            _rid, base, data = embedded
            s = off0 - base
            if 0 <= s and s + n <= len(data):
                return data[s: s + n].upper()
        if ref_id < 0 or ref_id >= len(self.sq_names):
            raise CramError(f"bad reference id {ref_id}")
        seqs = self._load_fasta()
        name = self.sq_names[ref_id]
        if name not in seqs:
            raise CramError(f"reference sequence {name} not in FASTA")
        seq = seqs[name]
        # alignments may poke past either contig end (htslib pads with N,
        # which downstream codes as invalid); always return EXACTLY n
        # bytes — a short slice would silently shrink the SEQ buffer, and
        # a negative offset must not wrap around Python-style
        lo = min(max(off0, 0), len(seq))
        hi = min(max(off0 + n, lo), len(seq))
        chunk = seq[lo:hi]
        return (b"N" * (lo - off0)) + chunk + b"N" * (
            n - (lo - off0) - len(chunk))


def _sq_names_from_header(text: str) -> List[str]:
    names = []
    for line in text.splitlines():
        if line.startswith("@SQ"):
            for fieldv in line.split("\t"):
                if fieldv.startswith("SN:"):
                    names.append(fieldv[3:])
    return names


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def _iter_slices_raw(path: str):
    """Walk a CRAM 2.x/3.x file slice by slice, yielding (comp, sh,
    blocks, ref) where `blocks` are the slice's content blocks with their
    payloads STILL COMPRESSED — so a worker pool can inflate + decode
    slices concurrently while this walk stays sequential (headers and
    compression-header blocks are small and inflate inline)."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"CRAM":
            raise CramError(f"{path}: not a CRAM file")
        major, minor = f.read(1)[0], f.read(1)[0]
        if major not in (2, 3):
            raise CramUnsupported(f"CRAM version {major}.{minor}")
        v3 = major >= 3
        f.read(20)  # file id

        # SAM header container
        hdr = read_container_header(f, v3)
        if hdr is None:
            raise CramError("missing CRAM header container")
        hdr_end = f.tell() + hdr.length
        blk = read_block(f, v3)
        if blk.content_type != CT_FILE_HEADER:
            raise CramError("first block is not the SAM header")
        (hlen,) = struct.unpack("<i", blk.data[:4])
        sam_header = blk.data[4: 4 + hlen].decode("latin-1")
        for _ in range(1, hdr.n_blocks):
            read_block(f, v3)  # blank/pad companion blocks
        # htslib's v2 writer computes the header container's length BEFORE
        # padding grows the block's ITF8 size fields, so the declared
        # length can be a couple bytes SHORT of the actual data
        # (cram_io.c:4257-4265 vs its reader, which only skips
        # length-consumed when positive). Mirror the reader: never seek
        # backward from where the blocks actually ended.
        f.seek(max(hdr_end, f.tell()))
        ref = Reference(_sq_names_from_header(sam_header))

        while True:
            ch_hdr = read_container_header(f, v3)
            if ch_hdr is None:
                return  # clean EOF (v2.0 files have no EOF container)
            end = f.tell() + ch_hdr.length
            if ch_hdr.n_records == 0:
                if ch_hdr.ref_id == -1 and ch_hdr.n_blocks <= 1:
                    return  # EOF container (v2.1+)
                f.seek(end)
                continue
            blk = read_block(f, v3)
            if blk.content_type != CT_COMPRESSION_HEADER:
                raise CramError("expected compression header block")
            comp = parse_compression_header(blk.data)
            while f.tell() < end:
                sblk = read_block(f, v3)
                if sblk.content_type not in (CT_MAPPED_SLICE,
                                             CT_UNMAPPED_SLICE):
                    raise CramError("expected slice header block")
                sh = parse_slice_header(
                    sblk.data, v3, sblk.content_type == CT_MAPPED_SLICE)
                blocks = [read_block_raw(f, v3)
                          for _ in range(sh.n_blocks)]
                yield comp, sh, blocks, ref
            f.seek(end)


def _inflate_slice(sh, blocks):
    """(core, external {cid: bytes}, embedded) from a slice's raw
    blocks."""
    core = b""
    external: Dict[int, bytes] = {}
    embedded = None
    for b in blocks:
        raw = inflate_block(b)
        if b.content_type == CT_CORE:
            core = raw
        elif b.content_type == CT_EXTERNAL:
            if b.content_id == sh.embedded_ref_id:
                embedded = raw
            external[b.content_id] = raw
        else:
            raise CramError("unexpected block in slice")
    return core, external, embedded


def _iter_slices(path: str):
    """_iter_slices_raw with payloads inflated (the sequential API:
    yields (comp, sh, core, external, embedded, ref) and installs each
    slice's embedded reference on `ref`)."""
    for comp, sh, blocks, ref in _iter_slices_raw(path):
        core, external, embedded = _inflate_slice(sh, blocks)
        ref.set_embedded(sh.ref_id, sh.start, embedded)
        yield comp, sh, core, external, embedded, ref


def iter_cram_records(path: str) -> Iterator[Tuple[int, bytes]]:
    """Yield (bam_flags, SEQ) for every record of a CRAM 2.x/3.x file."""
    for comp, sh, core, external, _emb, ref in _iter_slices(path):
        dec = SliceDecoder(BitReader(core),
                           {cid: ByteReader(d)
                            for cid, d in external.items()})
        yield from _decode_slice_records(comp, sh, dec, ref.get)


# ---------------------------------------------------------------------------
# Native (C) slice decoding — the record walk of _decode_slice_records in
# fastk_native.c:fk_cram_slice, with per-slice Python fallback
# ---------------------------------------------------------------------------

# series slot order — MUST match fastk_native.c's S_* enum
_SERIES_ORDER = [b"BF", b"CF", b"RI", b"RL", b"AP", b"RG", b"RN", b"MF",
                 b"NS", b"NP", b"TS", b"NF", b"TL", b"FN", b"FC", b"FP",
                 b"BS", b"SC", b"IN", b"BA", b"BB", b"QS", b"QQ", b"DL",
                 b"RS", b"PD", b"HC", b"MQ"]


class _EncPack:
    """Flatten an encoding-tuple tree into the C decoder's tables."""

    def __init__(self, extmap: Dict[int, int]):
        self.rows: List[List[int]] = []
        self.htab: List[int] = []
        self.hsym: List[int] = []
        self.extmap = extmap
        self.ok = True

    def add(self, enc: tuple) -> int:
        kind = enc[0]
        if kind == "external":
            row = [0, self.extmap.get(enc[1], -1), 0, 0]
        elif kind == "huffman":
            symbols, lengths = enc[1], enc[2]
            items = sorted(range(len(symbols)),
                           key=lambda i: (lengths[i], symbols[i]))
            syms_sorted = [symbols[i] for i in items]
            lens_sorted = [lengths[i] for i in items]
            pool0 = len(self.hsym)
            groups = []
            code = prev = 0
            gi = 0
            while gi < len(items):
                ln = lens_sorted[gi]
                code <<= (ln - prev)
                prev = ln
                start_code, start_idx = code, gi
                while gi < len(items) and lens_sorted[gi] == ln:
                    gi += 1
                    code += 1
                groups.append((ln, start_code, start_idx, gi - start_idx))
            hoff = len(self.htab)
            for g in groups:
                self.htab.extend(g)
            self.hsym.extend(syms_sorted)
            row = [1, hoff, len(groups), pool0]
        elif kind == "beta":
            row = [2, enc[1], enc[2], 0]
        elif kind == "gamma":
            row = [3, enc[1], 0, 0]
        elif kind == "subexp":
            row = [4, enc[1], enc[2], 0]
        elif kind == "byte_array_stop":
            row = [5, enc[1], self.extmap.get(enc[2], -1), 0]
        elif kind == "byte_array_len":
            li = self.add(enc[1])
            vi = self.add(enc[2])
            row = [6, li, vi, 0]
        else:  # null / unsupported: errors only if actually read
            row = [7, 0, 0, 0]
        self.rows.append(row)
        return len(self.rows) - 1


def _pack_comp(comp: CompressionHeader, external: Dict[int, bytes]):
    """(encs, htab, hsym, series, tag_off, tag_enc, cids, subs) for the C
    decoder, or None when a needed tag encoding is absent. Cached on the
    CompressionHeader (one per container) keyed by the external-id set."""
    import numpy as np

    cids = sorted(external.keys())
    key = tuple(cids)
    cache = getattr(comp, "_native_pack", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    extmap = {cid: i for i, cid in enumerate(cids)}
    pack = _EncPack(extmap)
    series = []
    for skey in _SERIES_ORDER:
        e = comp.series.get(skey)
        series.append(-1 if e is None or e[0] == "null" else pack.add(e))
    tag_off = [0]
    tag_enc: List[int] = []
    result = None
    ok = True
    for line in comp.tag_dict:
        for tkey in line:
            te = comp.tags.get(tkey)
            if te is None:
                ok = False
                break
            tag_enc.append(pack.add(te))
        if not ok:
            break
        tag_off.append(len(tag_enc))
    if ok:
        subs = bytes(_sub_decode_table(comp.sub_matrix)[(ri, c)]
                     for ri in range(5) for c in range(4))
        result = (
            np.array(pack.rows, dtype=np.int32).reshape(-1, 4),
            np.array(pack.htab or [0], dtype=np.int64),
            np.array(pack.hsym or [0], dtype=np.int32),
            np.array(series, dtype=np.int32),
            np.array(tag_off, dtype=np.int32),
            np.array(tag_enc or [0], dtype=np.int32),
            cids, subs)
    comp._native_pack = (key, result)
    return result


def _native_slice_piece(comp, sh, core: bytes, external: Dict[int, bytes],
                        embedded, ref, hc: bool, bc: int):
    """Decode one slice natively -> (codes, boff, rlen), or None (caller
    falls back to the Python record walk)."""
    from fastk_tpu_torch import native

    if native.load() is None:
        return None
    packed = _pack_comp(comp, external)
    if packed is None:
        return None
    encs, htab, hsym, series, tag_off, tag_enc, cids, subs = packed

    # reference window covering the slice span (+margin); any access the
    # window cannot serve makes C return -5 and the Python path decide.
    # The embedded window is passed EXPLICITLY (get_with) so concurrent
    # slice decodes never share mutable Reference state.
    embt = ((sh.ref_id, sh.start - 1, embedded)
            if embedded is not None else None)
    ref_win = None
    ref_start = sh.start
    if sh.span > 0 and sh.ref_id >= 0:
        for win_n in (sh.span + 64, sh.span):
            # an embedded block that cannot serve the whole window would
            # make ref.get read it all from FASTA, while the per-call
            # Python path may mix sources — only trust full coverage
            if embedded is not None and len(embedded) < win_n:
                continue
            try:
                ref_win = ref.get_with(embt, sh.ref_id, sh.start - 1,
                                       win_n)
                break
            except Exception:
                ref_win = None
    # multi-ref slices read RI per record: pass the full per-ref contig
    # table (already RAM-resident once the FASTA loads; embedded blocks
    # are slice-scoped single-ref and do not apply here)
    refs = None
    if sh.ref_id == -2:
        try:
            seqs = ref._load_fasta()
            refs = [seqs.get(nm, b"") for nm in ref.sq_names]
        except Exception:
            refs = None  # unmapped-only slices decode fine without it
    res = native.cram_slice(
        encs, htab, hsym, series, tag_off, tag_enc,
        [external[c] for c in cids], core, ref_win, ref_start, refs, subs,
        comp.rn_preserved, comp.ap_delta, sh.ref_id == -2, sh.start,
        sh.n_records, hc, bc)
    return res


def scan_cram_pieces(path: str, hc: bool = False, bc: int = 0):
    """Streamed CRAM ingest as (codes, boff, rlen) pieces, one per slice:
    the sequential walk hands COMPRESSED slice blocks to the shared
    worker pool, which inflates (rANS/gzip) and runs the C record walk
    (with per-slice Python fallback) concurrently — the reference decodes
    CRAM with threaded htslib the same way (io.c:1821-1990). Features
    outside the native decoder's gate divert the REST of the stream to
    the io.cram fallback chain (read-count cursor, like
    iter_cram_reads)."""
    from fastk_tpu_torch.io.reader import _pooled, pack_reads

    def parse_one(item):
        comp, sh, blocks, ref = item
        core, external, embedded = _inflate_slice(sh, blocks)
        piece = _native_slice_piece(comp, sh, core, external, embedded,
                                    ref, hc, bc)
        if piece is None:
            embt = ((sh.ref_id, sh.start - 1, embedded)
                    if embedded is not None else None)
            dec = SliceDecoder(BitReader(core),
                               {cid: ByteReader(d)
                                for cid, d in external.items()})
            seqs = [s for fl, s in _decode_slice_records(
                        comp, sh, dec,
                        lambda rid, o, n: ref.get_with(embt, rid, o, n))
                    if not (fl & _BAM_SECSUP) and s]
            b = pack_reads(seqs, hc=hc, bc=bc)
            piece = (b.codes, b.boff, b.rlen)
        return piece

    nyielded = 0
    try:
        for piece in _pooled(_iter_slices_raw(path), parse_one):
            nyielded += len(piece[2])
            yield piece
    except CramUnsupported:
        from fastk_tpu_torch.io.cram import iter_cram_reads

        # restart through the full gated chain, skipping what we yielded
        chunk: List[bytes] = []
        bases = 0
        for i, seq in enumerate(iter_cram_reads(path)):
            if i < nyielded:
                continue
            chunk.append(seq)
            bases += len(seq) + 1
            if bases >= (32 << 20):
                b = pack_reads(chunk, hc=hc, bc=bc)
                yield b.codes, b.boff, b.rlen
                chunk, bases = [], 0
        if chunk:
            b = pack_reads(chunk, hc=hc, bc=bc)
            yield b.codes, b.boff, b.rlen


def iter_cram_reads_native(path: str) -> Iterator[bytes]:
    """SEQs of primary records (secondary/supplementary skipped, matching
    the SAM/BAM readers and reference io.c:1357,1466)."""
    for flags, seq in iter_cram_records(path):
        if flags & _BAM_SECSUP or not seq:
            # empty SEQs skip like the SAM/BAM/htslib readers — keeping
            # all four paths' record streams aligned also lets the gated
            # fallback resume at an exact record count (io/cram.py)
            continue
        yield seq
