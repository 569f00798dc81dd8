"""Optional ctypes binding to a system htslib for CRAM (and BAM/SAM) input.

The reference vendors all of htslib to decode CRAM (io.c:1821-1990). We
bind to an installed ``libhts.so`` at runtime instead (set ``LIBHTS`` to a
specific path; otherwise the system loader finds it). The bam1_t layout
below is htslib >= 1.10; a round-trip SELF-TEST on a generated in-memory
BAM gates the binding, so a layout mismatch degrades to "htslib
unavailable" rather than bad data.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import Iterator, Optional

import numpy as np

_NIB = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
_NIB_HI = _NIB[np.arange(256) >> 4]
_NIB_LO = _NIB[np.arange(256) & 0xF]

_SKIP_FLAGS = 0x900


class _Bam1Core(ctypes.Structure):
    _fields_ = [
        ("pos", ctypes.c_int64),
        ("tid", ctypes.c_int32),
        ("bin", ctypes.c_uint16),
        ("qual", ctypes.c_uint8),
        ("l_extranul", ctypes.c_uint8),
        ("flag", ctypes.c_uint16),
        ("l_qname", ctypes.c_uint16),
        ("n_cigar", ctypes.c_uint32),
        ("l_qseq", ctypes.c_int32),
        ("mtid", ctypes.c_int32),
        ("mpos", ctypes.c_int64),
        ("isize", ctypes.c_int64),
    ]


class _Bam1(ctypes.Structure):
    _fields_ = [
        ("core", _Bam1Core),
        ("id", ctypes.c_uint64),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("l_data", ctypes.c_int),
        ("m_data", ctypes.c_uint32),
        ("mempolicy", ctypes.c_uint32),
    ]


_lib = None
_tried = False


def _find() -> Optional[str]:
    p = os.environ.get("LIBHTS")
    if p:
        return p
    return ctypes.util.find_library("hts")


def load() -> Optional[ctypes.CDLL]:
    """Load + self-test libhts; None if unavailable or layout-incompatible."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _find()
    if not path:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.hts_open.restype = ctypes.c_void_p
        lib.hts_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.sam_hdr_read.restype = ctypes.c_void_p
        lib.sam_hdr_read.argtypes = [ctypes.c_void_p]
        lib.bam_init1.restype = ctypes.POINTER(_Bam1)
        lib.sam_read1.restype = ctypes.c_int
        lib.sam_read1.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.POINTER(_Bam1)]
        lib.bam_destroy1.argtypes = [ctypes.POINTER(_Bam1)]
        lib.hts_close.argtypes = [ctypes.c_void_p]
        lib.hts_set_fai_filename.restype = ctypes.c_int
        lib.hts_set_fai_filename.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    except (OSError, AttributeError):
        return None
    if not _self_test(lib):
        return None
    _lib = lib
    return _lib


def _records(lib, path: str, ref: Optional[str]):
    fp = lib.hts_open(path.encode(), b"r")
    if not fp:
        raise OSError(f"htslib cannot open {path}")
    try:
        if ref:
            lib.hts_set_fai_filename(fp, ref.encode())
        hdr = lib.sam_hdr_read(fp)
        if not hdr:
            raise OSError(f"htslib cannot read header of {path}")
        b = lib.bam_init1()
        try:
            while lib.sam_read1(fp, hdr, b) >= 0:
                core = b.contents.core
                if core.flag & _SKIP_FLAGS or core.l_qseq <= 0:
                    continue
                off = core.l_qname + 4 * core.n_cigar
                nb = (core.l_qseq + 1) // 2
                raw = ctypes.string_at(
                    ctypes.addressof(b.contents.data.contents) + off, nb)
                packed = np.frombuffer(raw, dtype=np.uint8)
                seq = np.empty(2 * nb, dtype=np.uint8)
                seq[0::2] = _NIB_HI[packed]
                seq[1::2] = _NIB_LO[packed]
                yield seq[: core.l_qseq].tobytes()
        finally:
            lib.bam_destroy1(b)
    finally:
        lib.hts_close(fp)


def _self_test(lib) -> bool:
    """Decode a generated BAM and check the bytes (gates layout mismatches)."""
    import gzip
    import struct
    import tempfile

    want = b"ACGTNACGTTT"
    hdr_text = b"@HD\tVN:1.6\n"
    out = b"BAM\x01" + struct.pack("<i", len(hdr_text)) + hdr_text
    out += struct.pack("<i", 0)
    nibm = {c: i for i, c in enumerate(b"=ACMGRSVTWYHKDBN")}
    nib = [nibm[c] for c in want]
    if len(nib) % 2:
        nib.append(0)
    packed = bytes((nib[i] << 4) | nib[i + 1] for i in range(0, len(nib), 2))
    body = struct.pack("<iiBBHHHiiii", -1, -1, 3, 0, 4680, 0, 4,
                       len(want), -1, -1, 0) + b"st\x00" + packed + \
        b"\xff" * len(want)
    out += struct.pack("<i", len(body)) + body
    try:
        with tempfile.NamedTemporaryFile(suffix=".bam", delete=False) as f:
            tmp = f.name
            with gzip.open(f, "wb") as g:
                g.write(out)
        got = list(_records(lib, tmp, None))
        return got == [want]
    except Exception:
        return False
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def iter_hts_reads(path: str, ref: Optional[str] = None) -> Iterator[bytes]:
    lib = load()
    if lib is None:
        raise NotImplementedError(
            f"{path}: no usable htslib (set LIBHTS=/path/to/libhts.so, or "
            "install pysam, or convert with `samtools view -b`)")
    yield from _records(lib, path, ref)
