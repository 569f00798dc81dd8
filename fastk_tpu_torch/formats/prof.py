"""The ``.prof``/``.pidx`` per-read compressed count-profile format.

A profile set is a stub ``<source>.prof`` holding just (int32 kmer,
int32 nparts), plus per part a hidden data file ``.<base>.prof.<i>`` of
concatenated compressed profiles and an index file ``.<base>.pidx.<i>``:

    int32   kmer size k
    int64   ordinal of the first read whose profile is in this part (b)
    int64   number of profiles in this part (n)
    int64 x n  offsets; offset[i] is the byte offset one past profile b+i

(reference: README.md "K-mer Profile Files"; Open_Profiles/Fetch_Profile
libfastk.c:1510-1805; writer merge.c:761-1006.)

Codec (per profile, counts are 15-bit, <= 32767):

    first count:  0x          one byte, value in [0,127]
                  1x,y        two bytes, big-endian 15-bit value
    each forward difference d to the previous count:
                  00x         x in [1,63]: repeat previous count x times
                  01x         one byte, 6-bit two's complement d, |d| in [1,31]
                  1x,y        two bytes, 15-bit value v = d mod 32768;
                              count' = (count + v) & 0x7fff

The encoder is deterministic (one-byte forms whenever possible, zero runs
chunked greedily at 63), so re-encoding a decoded profile reproduces the
reference's bytes exactly.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Sequence

import numpy as np

from fastk_tpu_torch.formats.paths import part_path, stub_path


# ----------------------------------------------------------------------------
# Codec
# ----------------------------------------------------------------------------

def encode_profile(counts: np.ndarray) -> bytes:
    """Compress one profile. Vectorized (no per-count Python loop).

    Matches the reference encoder byte-for-byte (fragment encoder
    count.c:868-947 as spliced by merge.c:394-733; decoder
    libfastk.c:1710-1805 is the inverse).
    """
    counts = np.asarray(counts, dtype=np.int64)
    n = counts.shape[0]
    if n == 0:
        return b""
    first = int(counts[0])
    head = bytes([first]) if first < 128 else bytes([0x80 | (first >> 8), first & 0xFF])
    if n == 1:
        return head

    d = np.diff(counts)  # length n-1
    zero = d == 0
    small = (~zero) & (np.abs(d) < 32)
    large = (~zero) & ~small

    # --- zero-run chunking: greedy chunks of 63 ---
    # position within its run for each zero diff
    run_start = zero & ~np.concatenate(([False], zero[:-1]))
    run_id = np.cumsum(run_start) - 1  # valid where zero
    zpos = np.arange(n - 1) - np.concatenate(([0], np.flatnonzero(run_start)))[
        run_id + 1
    ] if run_start.any() else np.zeros(n - 1, dtype=np.int64)
    # a zero emits 63 when it completes a 63-chunk; the run's last zero emits
    # the remainder (if any)
    completes = zero & ((zpos % 63) == 62)
    run_end = zero & ~np.concatenate((zero[1:], [False]))
    remainder = (zpos % 63) + 1
    emits_rem = run_end & ((remainder != 63) | ~completes)
    # bytes per diff position
    nb = np.zeros(n - 1, dtype=np.int64)
    nb[small] = 1
    nb[large] = 2
    nb[completes] += 1
    nb[emits_rem & ~completes] += 1
    # note: a position can both complete a chunk and end the run with rem 63 ->
    # handled above (emits only the 63 byte)

    off = np.zeros(n, dtype=np.int64)
    np.cumsum(nb, out=off[1:])
    total = int(off[-1])
    out = np.zeros(total, dtype=np.uint8)

    # small one-byte tokens
    out[off[:-1][small]] = (0x40 | (d[small] & 0x3F)).astype(np.uint8)
    # large two-byte tokens
    v = (d[large] & 0x7FFF).astype(np.int64)
    out[off[:-1][large]] = (0x80 | (v >> 8)).astype(np.uint8)
    out[off[:-1][large] + 1] = (v & 0xFF).astype(np.uint8)
    # zero-run bytes
    out[off[:-1][completes]] = 63
    rem_only = emits_rem & ~completes
    out[off[:-1][rem_only]] = remainder[rem_only].astype(np.uint8)

    return head + out.tobytes()


def decode_profile(buf: bytes | np.ndarray) -> np.ndarray:
    """Decompress one profile to uint16 counts (reference: Fetch_Profile
    decode loop, libfastk.c:1710-1805). Native decoder when available,
    vectorized token scan otherwise."""
    b = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    if b.size:
        from fastk_tpu_torch import native

        if native.load() is not None:
            # every token byte decodes to at most 63 counts
            return native.prof_decode(b, 63 * b.size + 2)
    if b.size == 0:
        return np.zeros(0, dtype=np.uint16)
    if b[0] & 0x80:
        first = ((int(b[0]) & 0x7F) << 8) | int(b[1])
        body = b[2:]
    else:
        first = int(b[0])
        body = b[1:]
    if body.size == 0:
        return np.array([first], dtype=np.uint16)

    # Token starts: s[0]=True; s[i] = not (s[i-1] and body[i-1] has high bit).
    # Within a maximal run of high-bit bytes, starts alternate.
    h = (body & 0x80) != 0
    m = body.size
    starts = np.ones(m, dtype=bool)
    hrun_start = h & ~np.concatenate(([False], h[:-1]))
    if hrun_start.any():
        # position within the high-bit run
        idx = np.arange(m)
        rs_idx = np.flatnonzero(hrun_start)
        run_of = np.cumsum(hrun_start) - 1
        pos_in_run = np.where(h, idx - rs_idx[np.maximum(run_of, 0)], 0)
        # a run starting at r: if byte r-1 is a non-high token byte or r==0,
        # byte r starts a token. Bytes alternate start/second within the run.
        # Since a high-bit run is always entered at a token start (a second
        # byte can only follow a high-bit start, extending the run backwards),
        # parity within the run decides.
        starts = np.where(h, (pos_in_run % 2) == 0, True)
        # bytes immediately after a run: if run length is odd, the last run
        # byte was a start, so the following byte is its second byte.
        run_end_idx = np.flatnonzero(h & ~np.concatenate((h[1:], [False])))
        odd_after = run_end_idx[starts[run_end_idx]] + 1
        odd_after = odd_after[odd_after < m]
        starts[odd_after] = False

    tok = np.flatnonzero(starts)
    tb = body[tok].astype(np.int64)
    is_run = (tb & 0xC0) == 0
    is_two = (tb & 0x80) != 0
    is_one = ~is_run & ~is_two

    delta = np.zeros(tok.size, dtype=np.int64)
    second = np.zeros(tok.size, dtype=np.int64)
    if is_two.any():
        second[is_two] = body[np.minimum(tok[is_two] + 1, m - 1)]
    v = ((tb & 0x7F) << 8) | second
    # 15-bit two's complement
    v = np.where(v >= 0x4000, v - 0x8000, v)
    delta[is_two] = v[is_two]
    one = tb & 0x3F
    one = np.where(one >= 0x20, one - 0x40, one)
    delta[is_one] = one[is_one]

    vals = (first + np.cumsum(delta)) % 0x8000
    reps = np.where(is_run, tb, 1).astype(np.int64)
    out = np.empty(1 + int(reps.sum()), dtype=np.uint16)
    out[0] = first
    out[1:] = np.repeat(vals, reps).astype(np.uint16)
    return out


def encode_profiles_bulk(cnts: np.ndarray, boff: np.ndarray,
                         plen: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Encode many profiles from a flat counts array in one pass ->
    (concatenated blob uint8, per-read end offsets int64). Read r's profile
    is cnts[boff[r] : boff[r] + plen[r]] (plen <= 0 -> empty blob).

    Native C when available (one call for the whole batch — the per-read
    Python loop is a real wall at 1e7+ reads), numpy fallback otherwise."""
    from fastk_tpu_torch import native

    res = native.prof_encode_bulk(cnts, boff, plen)
    if res is not None:
        return res
    blobs = []
    for o, n in zip(boff, plen):
        blobs.append(encode_profile(cnts[int(o): int(o) + int(n)])
                     if n > 0 else b"")
    offs = np.cumsum(np.array([len(b) for b in blobs], dtype=np.int64))
    return np.frombuffer(b"".join(blobs), dtype=np.uint8), offs


# ----------------------------------------------------------------------------
# File set
# ----------------------------------------------------------------------------

class ProfWriter:
    """Streaming .prof/.pidx writer: profiles arrive in read order and are
    appended to part files as they come — nothing is buffered, so memory
    stays bounded no matter how many reads (the reference writes .prof.<t>
    incrementally the same way, merge.c:761-1006).

    total_reads and nparts fix the equal part cuts up front, so the output
    is byte-identical to the buffered ``write_prof``."""

    def __init__(self, path: str, kmer: int, total_reads: int,
                 nparts: int = 1):
        if path.endswith(".prof"):
            path = path[: -len(".prof")]
        self.path = path
        self.kmer = kmer
        self.total = total_reads
        self.nparts = max(1, min(nparts, max(total_reads, 1)))
        self.cuts = [total_reads * i // self.nparts
                     for i in range(self.nparts + 1)]
        self.r = 0  # next read ordinal
        self._p = -1  # current part index
        self._df = self._xf = None
        self._off = 0  # bytes written into the current part
        with open(stub_path(path, ".prof"), "wb") as f:
            f.write(struct.pack("<ii", kmer, self.nparts))

    def _roll(self) -> None:
        if self._df is not None:
            self._df.close()
            self._xf.close()
        self._p += 1
        lo, hi = self.cuts[self._p], self.cuts[self._p + 1]
        self._df = open(part_path(self.path, ".prof", self._p + 1), "wb")
        self._xf = open(part_path(self.path, ".pidx", self._p + 1), "wb")
        self._xf.write(struct.pack("<iqq", self.kmer, lo, hi - lo))
        self._off = 0

    def add(self, prof: np.ndarray | bytes) -> None:
        """Append one read's profile (count array or pre-encoded bytes)."""
        blob = (bytes(prof) if isinstance(prof, (bytes, bytearray))
                else encode_profile(prof))
        self.add_block(np.frombuffer(blob, dtype=np.uint8),
                       np.array([len(blob)], dtype=np.int64))

    def add_block(self, blob: np.ndarray, end_offs: np.ndarray) -> None:
        """Append many reads' pre-encoded profiles: ``blob`` is their
        concatenation, ``end_offs[i]`` the byte offset one past read i's
        blob (as produced by encode_profiles_bulk)."""
        n = len(end_offs)
        i = 0
        prev_end = 0
        mv = memoryview(np.ascontiguousarray(blob, dtype=np.uint8))
        while i < n:
            if self._p < 0 or self.r >= self.cuts[self._p + 1]:
                self._roll()
            take = min(n - i, self.cuts[self._p + 1] - self.r)
            hi = int(end_offs[i + take - 1])
            self._df.write(mv[prev_end:hi])
            rel = end_offs[i: i + take] - prev_end + self._off
            rel.astype("<i8").tofile(self._xf)
            self._off += hi - prev_end
            prev_end = hi
            self.r += take
            i += take

    def close(self) -> None:
        if self.r != self.total:
            # close handles and remove the partial file-set BEFORE
            # raising: a truncated .prof/.pidx set must never remain on
            # disk for ProfileIndex to mis-read
            self.abort()
            raise ValueError(
                f"ProfWriter: {self.r} profiles added, expected {self.total}")
        while self._p + 1 < self.nparts or self._p < 0:
            self._roll()  # trailing (possibly empty) parts
        self._df.close()
        self._xf.close()

    def abort(self) -> None:
        """Close handles and remove every file written so far (the stub
        and all .prof/.pidx parts)."""
        for h in (getattr(self, "_df", None), getattr(self, "_xf", None)):
            try:
                if h is not None:
                    h.close()
            except OSError:
                pass
        for p in range(self.nparts):
            for suff in (".prof", ".pidx"):
                try:
                    os.unlink(part_path(self.path, suff, p + 1))
                except OSError:
                    pass
        try:
            os.unlink(stub_path(self.path, ".prof"))
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.close()
        else:
            self.abort()


def write_prof(
    path: str,
    kmer: int,
    profiles: Sequence[np.ndarray] | Sequence[bytes],
    nparts: int = 1,
) -> None:
    """Write a profile file-set. ``profiles`` holds per-read count arrays (or
    pre-encoded byte strings), in read order; reads are split into ``nparts``
    equal contiguous groups (the reference groups by its input threads)."""
    w = ProfWriter(path, kmer, len(profiles), nparts=nparts)
    for p in profiles:
        w.add(p)
    w.close()


class ProfileIndex:
    """Random access to compressed profiles (reference: Profile_Index,
    libfastk.h:99-119, libfastk.c:1510-1805)."""

    def __init__(self, path: str):
        if path.endswith(".prof"):
            path = path[: -len(".prof")]
        self.path = path
        with open(stub_path(path, ".prof"), "rb") as f:
            self.kmer, self.nparts = struct.unpack("<ii", f.read(8))
        self._index = [np.zeros(1, dtype=np.int64)]
        self.nbase: List[int] = []
        nreads = 0
        for p in range(self.nparts):
            with open(part_path(path, ".pidx", p + 1), "rb") as f:
                k2, _b, n = struct.unpack("<iqq", f.read(20))
                if k2 != self.kmer:
                    raise ValueError("pidx kmer mismatch")
                self._index.append(np.fromfile(f, dtype="<i8", count=n))
            nreads += n
            self.nbase.append(nreads)
        self.nreads = nreads
        self.index = np.concatenate(self._index)  # index[0] = 0 sentinel
        self._data: List[np.ndarray | None] = [None] * self.nparts

    def _part_data(self, p: int) -> np.ndarray:
        if self._data[p] is None:
            self._data[p] = np.fromfile(part_path(self.path, ".prof", p + 1),
                                        dtype=np.uint8)
        return self._data[p]

    def fetch(self, rid: int) -> np.ndarray:
        """Decode the profile of read ``rid`` (0-based)."""
        if not 0 <= rid < self.nreads:
            raise IndexError(rid)
        p = int(np.searchsorted(np.asarray(self.nbase), rid, side="right"))
        base = 0 if p == 0 else self.nbase[p - 1]
        data = self._part_data(p)
        lo = 0 if rid == base else int(self.index[rid])
        hi = int(self.index[rid + 1])
        return decode_profile(data[lo:hi])

    def __iter__(self) -> Iterator[np.ndarray]:
        for rid in range(self.nreads):
            yield self.fetch(rid)


def read_profiles(path: str) -> List[np.ndarray]:
    return list(ProfileIndex(path))
