"""BGZF block-parallel decompression (host side).

BGZF (the SAM spec's blocked-gzip framing used by BAM and most genomics
.gz files) is a sequence of independent gzip members of <= 64KB whose
compressed size is recorded in a 'BC' extra subfield — so blocks can be
located without inflating and decompressed in parallel. The reference
decodes the same framing serially with libdeflate (io.c:858-1078); here a
bounded thread pool inflates blocks concurrently (zlib releases the GIL),
which both parallelizes on multi-core hosts and strips the per-member
overhead of the stdlib gzip layer.

Plain (non-BGZF) gzip files fall back to gzip.open transparently.
"""

from __future__ import annotations

import gzip
import io
import struct
import zlib
from typing import Iterator, List


def _ingest_threads() -> int:
    import os

    v = os.environ.get("FASTK_TPU_INGEST_THREADS")
    if v:
        return max(1, int(v))
    return min(4, os.cpu_count() or 1)


def sniff_bgzf(head: bytes) -> bool:
    """True when `head` (>= 18 bytes) starts a BGZF member: gzip magic,
    FEXTRA set, and a BC subfield in the extra area."""
    if len(head) < 18 or head[:2] != b"\x1f\x8b" or head[2] != 8:
        return False
    if not head[3] & 4:  # FEXTRA
        return False
    (xlen,) = struct.unpack_from("<H", head, 10)
    extra = head[12: 12 + xlen]
    off = 0
    while off + 4 <= len(extra):
        si1, si2, slen = extra[off], extra[off + 1], struct.unpack_from(
            "<H", extra, off + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:
            return True
        off += 4 + slen
    return False


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as f:
        return sniff_bgzf(f.read(64))


def _bsize(buf: bytes, off: int) -> int:
    """Total compressed size of the BGZF member starting at `off` (raises
    on malformed headers)."""
    if buf[off: off + 2] != b"\x1f\x8b" or not buf[off + 3] & 4:
        raise ValueError("corrupt BGZF member header")
    (xlen,) = struct.unpack_from("<H", buf, off + 10)
    p = off + 12
    end = p + xlen
    while p + 4 <= end:
        si1, si2, slen = buf[p], buf[p + 1], struct.unpack_from(
            "<H", buf, p + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:
            return struct.unpack_from("<H", buf, p + 4)[0] + 1
        p += 4 + slen
    raise ValueError("BGZF member without BC subfield")


_READ_CHUNK = 8 << 20
_GROUP = 32  # members inflated per pool task (amortizes dispatch)


def _iter_member_groups(path: str) -> Iterator[List[bytes]]:
    buf = b""
    off = 0  # cursor into buf: members are sliced, never the remainder
    group: List[bytes] = []
    with open(path, "rb") as f:
        while True:
            if len(buf) - off < 18:
                more = f.read(_READ_CHUNK)
                if not more:
                    break
                buf = buf[off:] + more
                off = 0
                continue
            size = _bsize(buf, off)
            while len(buf) - off < size:
                more = f.read(_READ_CHUNK)
                if not more:
                    raise ValueError(f"{path}: truncated BGZF member")
                buf = buf[off:] + more
                off = 0
            group.append(buf[off: off + size])
            off += size
            if len(group) >= _GROUP:
                yield group
                group = []
    if len(buf) - off:
        raise ValueError(f"{path}: trailing garbage after last BGZF member")
    if group:
        yield group


def _inflate_group(group: List[bytes]) -> bytes:
    out = []
    for m in group:
        d = zlib.decompressobj(wbits=31)
        out.append(d.decompress(m))
    return b"".join(out)


def iter_bgzf_chunks(path: str) -> Iterator[bytes]:
    """Decompressed chunks of a BGZF file, in order; members are inflated
    by a bounded worker pool (at most workers+1 groups in flight)."""
    nw = _ingest_threads()
    if nw <= 1:
        for g in _iter_member_groups(path):
            yield _inflate_group(g)
        return
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=nw) as pool:
        pending = deque()
        for g in _iter_member_groups(path):
            pending.append(pool.submit(_inflate_group, g))
            while len(pending) > nw:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


class _ChunkStream(io.RawIOBase):
    def __init__(self, it: Iterator[bytes]):
        self._it = it
        self._buf = b""
        self._pos = 0

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        while self._pos >= len(self._buf):
            nxt = next(self._it, None)
            if nxt is None:
                return 0
            self._buf = nxt
            self._pos = 0
        n = min(len(b), len(self._buf) - self._pos)
        b[:n] = self._buf[self._pos: self._pos + n]
        self._pos += n
        return n


def open_gz(path: str):
    """File-like over a .gz/.bam path: block-parallel for BGZF framing,
    stdlib gzip otherwise."""
    try:
        bg = is_bgzf(path)
    except OSError:
        bg = False
    if bg:
        return io.BufferedReader(_ChunkStream(iter_bgzf_chunks(path)),
                                 buffer_size=1 << 20)
    return gzip.open(path, "rb")
