"""Dazzler DB/DAM sequence ingestion (host side).

A Dazzler database is a text stub ``root.db`` (or ``.dam``) plus hidden
binary files ``.root.idx`` (DAZZ_DB header + DAZZ_READ records) and
``.root.bps`` (2-bit packed bases, big-endian within each byte). The
reference reads the stub's trim parameters (cutoff / all) and skips reads
that a trimmed DB would exclude: rlen < cutoff, or not the BEST subread of
its well when all=0 (read_DB_stub io.c:1992-2032, get_dazz_lengths
io.c:2053-2075, uncompress_read io.c:2107-2129).

On-disk struct layouts (C alignment, x86-64):
  DAZZ_DB   112 bytes; ureads at offset 0, cutoff at 8, allarr at 12
  DAZZ_READ  40 bytes; rlen at +4, boff at +16, flags at +32
"""

from __future__ import annotations

import os
import re
import struct
from typing import Iterator, Tuple

import numpy as np

DB_BEST = 0x0800
_DB_HEADER_SIZE = 112
_READ_SIZE = 40

_LETTER = np.frombuffer(b"acgt", dtype=np.uint8)


def _hidden(path: str, ext: str) -> str:
    d, b = os.path.split(path)
    root = re.sub(r"\.(db|dam)$", "", b)
    return os.path.join(d, f".{root}{ext}")


def read_stub(path: str) -> Tuple[int, int]:
    """Parse trim parameters (cutoff, all) from the text stub."""
    with open(path, "r") as f:
        txt = f.read()
    m = re.search(r"size =\s*(\d+)\s+cutoff =\s*(\d+)\s+all =\s*(\d)", txt)
    if m is None:
        raise ValueError(
            f"{path}: DB has not been split or its stub file is junk")
    return int(m.group(2)), int(m.group(3))


def iter_dazz_reads(path: str) -> Iterator[bytes]:
    """Yield the trimmed DB's read sequences as lowercase acgt bytes."""
    cutoff, db_all = read_stub(path)
    allflag = 0 if db_all else DB_BEST

    idx_path = _hidden(path, ".idx")
    bps_path = _hidden(path, ".bps")
    with open(idx_path, "rb") as f:
        hdr = f.read(_DB_HEADER_SIZE)
        if len(hdr) < _DB_HEADER_SIZE:
            raise ValueError(f"{idx_path}: truncated .idx header")
        (ureads,) = struct.unpack_from("<i", hdr, 0)
        recs = np.frombuffer(f.read(ureads * _READ_SIZE), dtype=np.uint8
                             ).reshape(ureads, _READ_SIZE)
    rlen = recs[:, 4:8].copy().view("<i4").ravel()
    boff = recs[:, 16:24].copy().view("<i8").ravel()
    flags = recs[:, 32:36].copy().view("<i4").ravel()

    keep = (rlen >= cutoff) & ((flags & DB_BEST) >= allflag)
    with open(bps_path, "rb") as bps:
        for r in np.flatnonzero(keep):
            n = int(rlen[r])
            bps.seek(int(boff[r]))
            packed = np.frombuffer(bps.read((n + 3) // 4), dtype=np.uint8)
            codes = np.empty(len(packed) * 4, dtype=np.uint8)
            codes[0::4] = (packed >> 6) & 3
            codes[1::4] = (packed >> 4) & 3
            codes[2::4] = (packed >> 2) & 3
            codes[3::4] = packed & 3
            yield _LETTER[codes[:n]].tobytes()
