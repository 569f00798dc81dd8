"""Read the generated inputs back as base codes, in NumPy.

Only what the generator writes is read: one-line FASTA records and
four-line FASTQ records, plain or gzipped, over the bases ACGT.
"""

from __future__ import annotations

import gzip

import numpy as np

CODES = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    CODES[_b] = _i


def _lines(buf: np.ndarray):
    """(start, end) byte offsets of each line, newline excluded."""
    ends = np.flatnonzero(buf == ord("\n"))
    starts = np.concatenate([[0], ends[:-1] + 1])
    return starts, ends


def read_sequences(path: str):
    """(codes uint8 [total bases], rlen int64 [nreads]) of a FASTA or FASTQ
    file: the reads' bases back to back, in file order."""
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            buf = np.frombuffer(f.read(), dtype=np.uint8)
    else:
        buf = np.fromfile(path, dtype=np.uint8)
    starts, ends = _lines(buf)
    fastq = ".fastq" in path or ".fq" in path
    step = 4 if fastq else 2
    if len(starts) % step:
        raise ValueError(f"{path}: {len(starts)} lines, not records of "
                         f"{step}")
    s, e = starts[1::step], ends[1::step]
    rlen = (e - s).astype(np.int64)
    keep = np.zeros(len(buf) + 1, dtype=np.int8)
    keep[s] += 1  # the starts, and the ends, are each distinct
    keep[e] -= 1
    mask = np.cumsum(keep[:-1]).astype(bool)
    codes = CODES[buf[mask]]
    if (codes > 3).any():
        raise ValueError(f"{path}: a base outside ACGT")
    return codes, rlen
