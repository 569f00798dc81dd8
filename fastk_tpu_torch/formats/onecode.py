"""ONE-code (1-code) writers for the `-1` tool exports: binary and ASCII.

The reference links ONElib (Durbin/Myers, ONElib.c:1-4194) and writes the
BINARY 1-code form; `OneBinaryWriter` reproduces that container so any
ONElib-based consumer (ONEview etc.) reads our exports directly. The ASCII
form (`OneAsciiWriter`) remains available — every ONE-code consumer reads
both. ASCII layout (ONElib.c oneWriteLine ASCII branch + writeHeader):

    1 <len> <filetype> 2 1
    ! 4 <len> <prog> <len> <version> <len> <command> <len> <date>
    .
    ~ <schema line>            (one per D/O schema row)
    .
    <data lines>: TYPE then fields; INTs bare, STRING/DNA/INT_LIST prefixed
    by their length.

Binary layout (ONElib.c writeHeader/oneWriteLine binary branch/
oneWriteFooter, ONElib.c:2203-2663):

    ASCII prolog: the "1" line, provenance, '.' spacer, '~' schema rows,
      then "$ <isBig>" and a newline — data starts right after it.
    data lines: 1 code byte ((idx<<1)|0x80, bit0 = list-compressed; we
      always write uncompressed so bit0 is clear), then the fields — CHAR
      raw byte, REAL 8 raw bytes, INT and list lengths as ltf varints
      (ONElib.c intPut) — then the list payload: STRING/DNA raw bytes;
      INT_LIST as ltf(first), one byte-width byte, then fixed-width
      little-endian deltas (ONElib.c compactIntList).
    end-of-data: one '\n'.
    footer: per line type in schema order, ASCII "# t n"/"@ t max"/
      "+ t total" counts, "% o x t v" per-object stats, and for object
      types a binary '&' line carrying the byte index (count+1 offsets);
      then "^\n" and the footer byte offset as 8 little-endian bytes.
"""

from __future__ import annotations

import struct
import sys
import time
from typing import Iterable, Sequence, TextIO

ONE_MAJOR, ONE_MINOR = 2, 1

KHIST_SCHEMA = [
    "D N 1 6 STRING          the name of the FastK .hist file this came from",
    "D R 2 3 INT 3 INT       the frequency range [low,hgh] covered",
    "O H 1 8 INT_LIST        a (hgh-low)+1 element list of the counts",
]

KMR_SCHEMA = [
    "D K 4 3 INT 3 INT 3 INT 3 INT k-mer size, prefix length, min. count, & 1st prefix for table",
    "O S 1 3 DNA                   concatentation of the suffixes of the k-mers with given prefix",
    "D C 1 8 INT_LIST              counts of the suffixes with the given prefix (in lex order)",
]

PRF_SCHEMA = [
    "O P 1 8 INT_LIST      The profile count vector for the next read",
]


class OneAsciiWriter:
    def __init__(self, filetype: str, schema: Sequence[str], prog: str,
                 command: str, out: TextIO | None = None):
        self.out = out if out is not None else sys.stdout
        w = self.out.write
        w(f"1 {len(filetype)} {filetype} {ONE_MAJOR} {ONE_MINOR}\n")
        date = time.strftime("%Y-%m-%d_%H:%M:%S")
        w("! 4" + "".join(
            f" {len(s)} {s}" for s in (prog, "1.0", command, date)) + "\n")
        w(".\n")
        for line in schema:
            w(f"~ {line}\n")
        w(".\n")

    def line(self, t: str, *fields) -> None:
        """Write one data line. A str field is STRING/DNA (length-prefixed);
        a list/array field is an INT_LIST (length-prefixed); ints are bare."""
        parts = [t]
        for f in fields:
            if isinstance(f, str):
                parts.append(f"{len(f)} {f}")
            elif isinstance(f, (int,)):
                parts.append(str(f))
            else:  # iterable of ints
                vals = [str(int(v)) for v in f]
                parts.append(str(len(vals)))
                parts.extend(vals)
        self.out.write(" ".join(parts) + "\n")


def _ltf(val: int) -> bytes:
    """ONElib's length-tagged varint (intPut, ONElib.c:3790-3825).

    1 byte 0x40|v for |v| < 64; 2 bytes 0x20|(v>>8), v&0xff for
    0 <= v < 0x2000; else a tag byte k (0x80|k if negative) followed by the
    k+1 low little-endian bytes of the two's-complement value."""
    if val >= 0:
        if val < 0x40:
            return bytes([0x40 | val])
        if val < 0x2000:
            return bytes([0x20 | (val >> 8), val & 0xFF])
        nb = 2
        while nb < 9 and val >= 1 << (8 * nb):
            nb += 1
        return bytes([nb - 1]) + val.to_bytes(8, "little")[:nb]
    if val >= -0x40:
        return bytes([(val | 0x40) & 0xFF])
    nb = 2
    while nb < 9 and -val - 1 >= 1 << (8 * nb):
        nb += 1
    return bytes([0x80 | (nb - 1)]) + (val & ((1 << 64) - 1)).to_bytes(
        8, "little")[:nb]


def _pack_code(t: str) -> int:
    """Binary line-code byte for type char t (ONElib.c:193-198)."""
    if "A" <= t <= "Z":
        c = ord(t) - ord("A")
    elif "a" <= t <= "z":
        c = 26 + ord(t) - ord("a")
    else:
        c = {";": 52, "&": 53, "/": 54, ".": 55}[t]
    return 0x80 | (c << 1)


def _int_list_parts(vals):
    """INT_LIST binary form, split at the compression boundary: the head is
    ltf(first) plus (if len > 1) the byte-width byte; the body is the
    fixed-width little-endian deltas — the part the list codec compresses
    (compactIntList + oneWriteLine, ONElib.c:902-958, 2424-2448)."""
    vals = [int(v) for v in vals]
    head = bytearray(_ltf(vals[0]))
    if len(vals) == 1:
        return bytes(head), b""
    diffs = [b - a for a, b in zip(vals, vals[1:])]
    mask = 0
    for d in diffs:
        mask |= d if d >= 0 else -(d + 1)
    mask >>= 7
    nb = 1
    while mask and nb < 8:
        nb += 1
        mask >>= 8
    head.append(nb)
    lim = (1 << (8 * nb)) - 1
    body = bytearray()
    for d in diffs:
        body += (d & lim).to_bytes(nb, "little")
    return bytes(head), bytes(body)


def _int_list_payload(vals) -> bytes:
    """Uncompressed INT_LIST binary payload (head + delta body)."""
    head, body = _int_list_parts(vals)
    return head + body


class _VcCodec:
    """ONElib "vc" list compressor (ONElib.c:2860-3410): per-line-type
    adaptive byte-Huffman. Bytes of uncompressed payloads accumulate in a
    histogram; past ~100KB a length-limited (<=12 bit) prefix code is
    built — with an ESCAPE code for bytes unseen in training — and later
    payloads are bit-packed with vcEncode's exact stream layout:

      2 header bits [0, isbig], then per input byte its code (or escape
      code + 8 raw bits); complete 64-bit words are stored little-endian,
      the final partial word as the big-endian top bytes, and if the
      stream reaches 64 bits bytes 0 and 7 are swapped (vcEncode,
      ONElib.c:3466-3560). If compression would exceed the raw size the
      stored-block fallback (0xff + raw bytes, nBits = 8*len+8) applies.

    The serialized form trusted by vcDeserialize is [isbig u8, esc_code
    i32, esc_len i32, then per byte: len u8 (+ code u16 if len>0 or
    escape)] — any valid prefix code works, so this uses plain canonical
    Huffman with an iterative Kraft repair to cap lengths at 12."""

    TRAIN = 100000

    def __init__(self):
        self.hist = [0] * 256
        self.tack = 0
        self.lens = None      # per-byte code lengths (0 = escape needed)
        self.bits = None
        self.esc_code = -1
        self.esc_len = 0

    def train(self, payload: bytes) -> None:
        for b in payload:
            self.hist[b] += 1
        self.tack += len(payload)
        if self.tack > self.TRAIN:
            self._build()

    @property
    def ready(self) -> bool:
        return self.lens is not None

    def _build(self) -> None:
        import heapq

        syms = [i for i in range(256) if self.hist[i]]
        esc = next((i for i in range(256) if not self.hist[i]), -1)
        if esc >= 0:
            syms.append(esc)
        if len(syms) == 1:  # degenerate: give the lone symbol a 1-bit code
            self.lens = [0] * 256
            self.bits = [0] * 256
            self.lens[syms[0]] = 1
            self.esc_code = -1
            return
        # Huffman lengths (weight 1 for the escape), capped at 12 with a
        # Kraft repair: overlong codes clamp, then the deepest still-valid
        # codes deepen until sum(2^-len) <= 1
        heap = [(max(self.hist[s], 1), i, (s,)) for i, s in enumerate(syms)]
        heapq.heapify(heap)
        nxt = len(syms)
        depth = {s: 0 for s in syms}
        while len(heap) > 1:
            w1, _, g1 = heapq.heappop(heap)
            w2, _, g2 = heapq.heappop(heap)
            for s in g1 + g2:
                depth[s] += 1
            heapq.heappush(heap, (w1 + w2, nxt, g1 + g2))
            nxt += 1
        L = {s: min(d, 12) for s, d in depth.items()}
        while sum(2.0 ** -l for l in L.values()) > 1.0:
            # deepen the longest code still shy of the cap
            s = max((s for s in L if L[s] < 12),
                    key=lambda s: (L[s], -max(self.hist[s], 1)))
            L[s] += 1
        # canonical assignment: (length, symbol) order
        lens = [0] * 256
        bits = [0] * 256
        code = 0
        prev = 0
        for s in sorted(L, key=lambda s: (L[s], s)):
            code <<= L[s] - prev
            prev = L[s]
            lens[s] = L[s]
            bits[s] = code
            code += 1
        self.lens, self.bits = lens, bits
        if esc >= 0:
            self.esc_code = esc
            self.esc_len = lens[esc]
            lens[esc] = 0  # serialized as len 0 + code (vcSerialize)

    def encode(self, payload: bytes):
        """-> (nBits, bytes) in vcEncode's layout."""
        lens, bits = self.lens, self.bits
        esc_bits = bits[self.esc_code] if self.esc_code >= 0 else 0
        out = bytearray()
        acc = 0        # pending bits (MSB-first), flushed per 64-bit word
        accn = 2       # header bits 00 (little-endian encoder)
        nbits = 2
        raw_bits = 8 * len(payload)
        for b in payload:
            n = lens[b]
            if n == 0:  # unseen in training: escape code + 8 raw bits
                if self.esc_code < 0:
                    raise ValueError(f"byte {b} without code or escape")
                acc = (acc << (self.esc_len + 8)) | (esc_bits << 8) | b
                accn += self.esc_len + 8
                nbits += self.esc_len + 8
            else:
                acc = (acc << n) | bits[b]
                accn += n
                nbits += n
            if nbits > raw_bits:  # stored-block fallback, like vcEncode
                return raw_bits + 8, b"\xff" + payload
            while accn >= 64:
                out += struct.pack(
                    "<Q", (acc >> (accn - 64)) & ((1 << 64) - 1))
                accn -= 64
                acc &= (1 << accn) - 1
        if accn:
            out += (acc << (64 - accn)).to_bytes(8, "big")[: (accn + 7) // 8]
        if nbits >= 64:
            out[0], out[7] = out[7], out[0]
        return nbits, bytes(out)

    def serialize(self) -> bytes:
        out = bytearray([0])  # isbig = 0 (little-endian)
        out += struct.pack("<ii", self.esc_code, self.esc_len)
        for i in range(256):
            out.append(self.lens[i])
            if self.lens[i] > 0 or i == self.esc_code:
                out += struct.pack("<H", self.bits[i])
        return bytes(out)


def _pack_dna(data: bytes) -> bytes:
    """ONElib DNAcodec: 2 bits per base, base i at bits 2i of byte i//4
    (Compress_DNA, ONElib.c:3436-3461); a/A=0 c/C=1 g/G=2 t/T=3, anything
    else 0. Decompression delivers lowercase."""
    import numpy as np

    num = np.zeros(256, dtype=np.uint8)
    for i, ch in enumerate(b"acgt"):
        num[ch] = i
        num[ch - 32] = i
    c = num[np.frombuffer(data, dtype=np.uint8)]
    pad = (-len(c)) % 4
    c = np.concatenate([c, np.zeros(pad, np.uint8)]).reshape(-1, 4)
    return (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
            ).astype(np.uint8).tobytes()


class _TypeInfo:
    __slots__ = ("ftypes", "is_object", "list_field", "contains",
                 "count", "total", "max", "index", "snap", "stat", "codec")

    def __init__(self, ftypes, is_object):
        self.ftypes = ftypes
        self.is_object = is_object
        self.list_field = next(
            (i for i, ft in enumerate(ftypes)
             if ft in ("STRING", "DNA", "INT_LIST")), None)
        self.contains: list[str] = []   # D types following this O row
        self.count = self.total = self.max = 0
        self.index: list[int] = []      # byte offsets (object types)
        self.snap: dict | None = None   # open instance: counts at start
        self.stat: dict = {}            # contained t -> [maxCount, maxTotal]
        lt = ftypes[self.list_field] if self.list_field is not None else None
        self.codec = _VcCodec() if lt in ("INT_LIST", "STRING") else None


class OneBinaryWriter:
    """Binary ONE-code writer with the same `.line()` API as the ASCII
    writer. Always writes lists uncompressed (the per-line flag bit makes
    that a valid encoding for every ONElib reader, ONElib.c:1194-1215);
    `close()` MUST be called to emit the footer."""

    def __init__(self, filetype: str, schema: Sequence[str], prog: str,
                 command: str, out=None):
        self.f = out if out is not None else sys.stdout.buffer
        self.schema_order: list[str] = []
        self.infos: dict[str, _TypeInfo] = {}
        cur_obj = None
        for row in schema:
            tok = row.split()
            kind, t, n = tok[0], tok[1], int(tok[2])
            ftypes = [tok[3 + 2 * i + 1] for i in range(n)]
            info = _TypeInfo(ftypes, kind == "O")
            self.infos[t] = info
            self.schema_order.append(t)
            if kind == "O":
                cur_obj = info
            elif cur_obj is not None:
                cur_obj.contains.append(t)
        self._open: list[str] = []  # stack of open object types

        date = time.strftime("%Y-%m-%d_%H:%M:%S")
        prolog = (f"1 {len(filetype)} {filetype} {ONE_MAJOR} {ONE_MINOR}"
                  + "\n! 4" + "".join(
                      f" {len(s)} {s}" for s in (prog, "1.0", command, date))
                  + "\n."
                  + "".join(f"\n~ {row}" for row in schema)
                  + "\n$ 0\n").encode()
        self.f.write(prolog)
        self._byte = len(prolog)
        for info in self.infos.values():
            if info.is_object:
                info.index.append(self._byte)  # index[0] = start of data

    def _close_instance(self, t: str) -> None:
        info = self.infos[t]
        for c in info.contains:
            ci = self.infos[c]
            st = info.stat.setdefault(c, [0, 0])
            st[0] = max(st[0], ci.count - info.snap[c][0])
            st[1] = max(st[1], ci.total - info.snap[c][1])
        info.snap = None

    def line(self, t: str, *fields) -> None:
        info = self.infos[t]
        while self._open and t not in self.infos[self._open[-1]].contains:
            self._close_instance(self._open.pop())
        info.count += 1
        if info.is_object:
            info.index.append(self._byte)
            info.snap = {c: (self.infos[c].count, self.infos[c].total)
                         for c in info.contains}
            self._open.append(t)

        is_dna = (info.list_field is not None
                  and info.ftypes[info.list_field] == "DNA")
        # DNA lists always ride the DNAcodec, like the reference; other
        # lists switch to their trained Huffman codec past the training
        # volume (bit 0 of the code byte = list-compressed)
        compress = is_dna or (info.codec is not None and info.codec.ready)
        buf = bytearray([_pack_code(t) | (1 if compress else 0)])
        list_val = None
        for ft, v in zip(info.ftypes, fields):
            if ft == "CHAR":
                buf.append(ord(v))
            elif ft == "REAL":
                buf += struct.pack("<d", v)
            elif ft == "INT":
                buf += _ltf(int(v))
            else:  # STRING / DNA / INT_LIST: the field holds the length
                list_val = v
                buf += _ltf(len(v))
        if list_val is not None and len(list_val) > 0:
            n = len(list_val)
            info.total += n
            info.max = max(info.max, n)
            if info.ftypes[info.list_field] == "INT_LIST":
                head, body = _int_list_parts(list_val)
                buf += head
                if compress and body:
                    nbits, enc = info.codec.encode(body)
                    buf += _ltf(nbits) + enc
                else:
                    buf += body
                    if info.codec is not None:
                        info.codec.train(body)
            elif is_dna:  # nBits varint then the 2-bit packed payload
                raw = (list_val.encode() if isinstance(list_val, str)
                       else bytes(list_val))
                buf += _ltf(2 * n) + _pack_dna(raw)
            else:  # STRING
                raw = (list_val.encode() if isinstance(list_val, str)
                       else bytes(list_val))
                if compress:
                    nbits, enc = info.codec.encode(raw)
                    buf += _ltf(nbits) + enc
                else:
                    buf += raw
                    if info.codec is not None:
                        info.codec.train(raw)
        self.f.write(buf)
        self._byte += len(buf)

    def close(self) -> None:
        while self._open:
            self._close_instance(self._open.pop())
        self.f.write(b"\n")       # end-of-data marker (last line is binary)
        self._byte += 1
        foot_off = self._byte
        for t in self.schema_order:
            info = self.infos[t]
            if info.count == 0:
                continue
            counts = f"# {t} {info.count}\n"
            if info.max > 0:
                counts += f"@ {t} {info.max}\n"
            if info.total > 0:
                counts += f"+ {t} {info.total}\n"
            if info.is_object:
                for c, (mc, mt) in sorted(info.stat.items()):
                    if mc:
                        counts += f"% {t} # {c} {mc}\n"
                    if mt:
                        counts += f"% {t} + {c} {mt}\n"
            b = counts.encode()
            self.f.write(b)
            self._byte += len(b)
            if info.is_object:   # '&' byte-index line: CHAR t, INT_LIST
                amp = bytearray([_pack_code("&"), ord(t)])
                amp += _ltf(len(info.index))
                amp += _int_list_payload(info.index)
                self.f.write(amp)
                self._byte += len(amp)
            if info.codec is not None and info.codec.ready:
                # ';' codec line: CHAR t, STRING = serialized compressor
                ser = info.codec.serialize()
                semi = bytearray([_pack_code(";"), ord(t)])
                semi += _ltf(len(ser)) + ser
                self.f.write(semi)
                self._byte += len(semi)
        self.f.write(b"^\n" + struct.pack("<q", foot_off))
        self.f.flush()


def _writer(binary: bool, filetype: str, schema, prog: str, command: str,
            out):
    if binary:
        return OneBinaryWriter(filetype, schema, prog, command, out)
    return OneAsciiWriter(filetype, schema, prog, command, out)


def write_khist(hist, source_name: str, low: int, high: int,
                command: str, out=None, binary: bool = True) -> None:
    """`Histex -1` export (reference: Histex.c:183-198)."""
    f1 = _writer(binary, "khist", KHIST_SCHEMA, "histex", command, out)
    f1.line("N", source_name)
    f1.line("R", low, high)
    f1.line("H", hist)
    if binary:
        f1.close()


def write_kmr(stream, cut: int, command: str, out=None,
              binary: bool = True) -> None:
    """`Tabex -1` export: per-prefix suffix/count groups (Tabex.c:86-143)."""
    from fastk_tpu_torch.formats.ktab import kmer_to_string

    f1 = _writer(binary, "kmr", KMR_SCHEMA, "tabex", command, out)
    gmer = 4 * stream.ibyte
    f1.line("K", stream.kmer, gmer, stream.minval, stream._prefix_of(0))
    CHUNK = 1 << 15
    cur_pre, sufs, cnts = None, [], []
    for lo in range(0, stream.nels, CHUNK):
        hi = min(lo + CHUNK, stream.nels)
        packed, counts = stream.read_range(lo, hi)
        import numpy as np

        ords = np.arange(lo, hi, dtype=np.int64)
        pvals = np.searchsorted(stream._pindex, ords, side="right")
        for j in range(hi - lo):
            pre = int(pvals[j])
            if pre != cur_pre:
                if sufs:  # groups fully below the cut emit nothing
                    f1.line("S", "".join(sufs))
                    f1.line("C", cnts)
                cur_pre, sufs, cnts = pre, [], []
            c = int(counts[j])
            if c >= cut:
                sufs.append(
                    kmer_to_string(packed[j], stream.kmer)[gmer:])
                cnts.append(c)
    if sufs:
        f1.line("S", "".join(sufs))
        f1.line("C", cnts)
    if binary:
        f1.close()


def write_prf(profiles: Iterable, command: str, out=None,
              binary: bool = True) -> None:
    """`Profex -1` export (reference: Profex.c:112-180)."""
    f1 = _writer(binary, "prf", PRF_SCHEMA, "profex", command, out)
    for prof in profiles:
        f1.line("P", prof)
    if binary:
        f1.close()
