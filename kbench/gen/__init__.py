"""The one general generator: a random genome from the seed, reads sampled
from it, and the job's inputs written as FASTA or gzipped FASTQ, in one file
or in several.

The sampling is ``fastk_tpu_torch.bench.synth_hifi``'s method, copied and
not imported: read starts uniform over the genome, point substitutions at a
fixed rate (a substituted base is one of the three others), and a fixed share
of reads reverse-complemented. Every seed gives the same number of reads of
the same length; only their content differs.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
# independent gzip members of this many bytes of text, compressed in threads
GZ_MEMBER = 16 << 20


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named stream of one seed: the genome, the reads
    and the qualities draw from their own streams, so adding one never
    changes another."""
    key = [int(b) for b in stream.encode()]
    return np.random.default_rng([seed & ((1 << 64) - 1), *key])


def genome(seed: int, length: int) -> np.ndarray:
    """uint8 codes 0..3 of a random genome."""
    return rng_for(seed, "genome").integers(0, 4, length, dtype=np.uint8)


def nreads(sample: dict) -> int:
    return int(round(sample["genome_length"] * sample["coverage"]
                     / sample["read_length"]))


def reads(seed: int, g: np.ndarray, sample: dict) -> np.ndarray:
    """uint8 codes [nreads, read_length]: reads sampled from g with
    substitutions, a share of them reverse-complemented."""
    rng = rng_for(seed, "reads")
    n, L = nreads(sample), int(sample["read_length"])
    starts = rng.integers(0, len(g) - L + 1, n)
    out = np.lib.stride_tricks.sliding_window_view(g, L)[starts]
    flat = out.reshape(-1)
    nerr = int(rng.binomial(flat.size, sample["substitution_rate"]))
    pos = rng.integers(0, flat.size, nerr)
    bump = rng.integers(1, 4, nerr, dtype=np.uint8)
    flat[pos] = (flat[pos] + bump) % 4
    flip = np.flatnonzero(rng.random(n) < sample["revcomp_fraction"])
    out[flip] = (3 - out[flip])[:, ::-1]
    return out


def _names(prefix: bytes, n: int) -> np.ndarray:
    """uint8 [n, len(prefix) + width]: prefix then the zero-padded index."""
    width = max(1, len(str(max(n - 1, 0))))
    idx = np.arange(n, dtype=np.int64)
    digits = np.empty((n, width), dtype=np.uint8)
    for j in range(width):
        digits[:, width - 1 - j] = ord("0") + (idx // 10 ** j) % 10
    pre = np.broadcast_to(np.frombuffer(prefix, dtype=np.uint8),
                          (n, len(prefix)))
    return np.concatenate([pre, digits], axis=1)


def _col(n: int, byte: bytes) -> np.ndarray:
    return np.full((n, 1), byte[0], dtype=np.uint8)


def fasta_text(codes: np.ndarray, name: bytes) -> np.ndarray:
    """uint8 text of one-line FASTA records, one a row of codes."""
    n = codes.shape[0]
    rows = np.concatenate([_names(b">" + name, n), _col(n, b"\n"),
                           ACGT[codes], _col(n, b"\n")], axis=1)
    return rows.reshape(-1)


def fastq_text(codes: np.ndarray, name: bytes, seed: int,
               sample: dict) -> np.ndarray:
    """uint8 text of FASTQ records with binned qualities drawn from the
    seed: each base takes sample["quality_bins"][i] with the weight
    sample["quality_weights"][i] (in percent)."""
    n, L = codes.shape
    bins = sample["quality_bins"].encode()
    table = np.repeat(np.frombuffer(bins, dtype=np.uint8),
                      sample["quality_weights"])
    if len(table) != 100:
        raise ValueError("quality_weights must sum to 100")
    qual = table[rng_for(seed, "qualities").integers(0, 100, (n, L),
                                                     dtype=np.uint8)]
    rows = np.concatenate([_names(b"@" + name, n), _col(n, b"\n"),
                           ACGT[codes], _col(n, b"\n"), _col(n, b"+"),
                           _col(n, b"\n"), qual, _col(n, b"\n")], axis=1)
    return rows.reshape(-1)


def _gz_member(chunk: memoryview, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, 31)
    return c.compress(chunk) + c.flush()


def write_gz(path: str, text: np.ndarray, level: int,
             threads: int = 4) -> None:
    """A gzip file of independent members, compressed in threads (zlib
    drops the interpreter lock); any gzip reader reads it as one stream."""
    mv = memoryview(np.ascontiguousarray(text))
    chunks = [mv[o: o + GZ_MEMBER] for o in range(0, len(mv), GZ_MEMBER)]
    with ThreadPoolExecutor(threads) as pool, open(path, "wb") as f:
        for blob in pool.map(lambda c: _gz_member(c, level), chunks):
            f.write(blob)


def read_text(codes: np.ndarray, seed: int, sample: dict) -> np.ndarray:
    """uint8 text of the reads in the sample's format: "fasta" or
    "fastq.gz" (the text before compression). Every record has the same
    length."""
    fmt = sample["format"]
    if fmt == "fasta":
        return fasta_text(codes, b"read")
    if fmt == "fastq.gz":
        return fastq_text(codes, b"read", seed, sample)
    raise ValueError(f"unknown read format {fmt!r}")


def _write_text(path: str, text: np.ndarray, sample: dict) -> None:
    if sample["format"].endswith(".gz"):
        write_gz(path, text, int(sample["gzip_level"]))
    else:
        text.tofile(path)


def write_reads(path: str, codes: np.ndarray, seed: int,
                sample: dict) -> None:
    """The reads in the sample's format, as one file."""
    _write_text(path, read_text(codes, seed, sample), sample)


def write_read_files(work: str, codes: np.ndarray, seed: int,
                     sample: dict) -> list:
    """The reads as sample["files"] files (1 when absent) in `work`, in
    contiguous blocks of reads, the way a sample comes as several SMRT cells
    or lanes; returns their paths in read order. One file is reads.<format>;
    several are reads.<i>.<format>, whose records are those of the one file,
    split: the same names, bases and qualities."""
    fmt, nfiles = sample["format"], int(sample.get("files", 1))
    records = read_text(codes, seed, sample).reshape(len(codes), -1)
    paths = []
    for i, block in enumerate(np.array_split(records, nfiles)):
        name = f"reads.{fmt}" if nfiles == 1 else f"reads.{i}.{fmt}"
        paths.append(os.path.join(work, name))
        _write_text(paths[-1], block.reshape(-1), sample)
    return paths
