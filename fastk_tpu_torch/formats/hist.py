"""The ``.hist`` k-mer frequency histogram format.

Layout (reference: README.md "K-mer Histogram File"; writer count.c:1893-1910;
reader libfastk.c:51-126):

    int32   kmer size k
    int32   first frequency l   (FastK always writes 1)
    int32   last  frequency h   (FastK always writes 0x7fff = 32767)
    int64   instance count at the low  boundary, I(l)
    int64   instance count at the high boundary, I(h)
    int64 x (h-l+1)  unique k-mer counts U(l..h)

Bin ``h`` holds the number of unique k-mers occurring h-or-more times and,
when l > 1, bin ``l`` holds the count of k-mers occurring l-or-fewer times, so
that sum(f*U(f)) equals the number of k-mer instances. Because I(f) = f*U(f)
only holds strictly inside (l, h), the true boundary instance counts are
carried in the header.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from fastk_tpu_torch.formats.paths import stub_path

HIST_LOW = 1
HIST_HIGH = 0x7FFF
_HEADER = struct.Struct("<iiiqq")


@dataclass
class Histogram:
    """In-memory histogram (reference: Histogram class, libfastk.h:30-44)."""

    kmer: int
    low: int
    high: int
    counts: np.ndarray  # int64[(high-low)+1]; counts[i] = count at freq low+i
    ilowcnt: int  # instance count at the low boundary (I(l))
    ihighcnt: int  # instance count at the high boundary (I(h))
    unique: bool = True  # True: counts are U(f); False: counts are I(f)

    def __post_init__(self) -> None:
        self.counts = np.asarray(self.counts, dtype=np.int64)
        assert self.counts.shape == (self.high - self.low + 1,)

    def __getitem__(self, freq: int) -> int:
        return int(self.counts[freq - self.low])

    @property
    def nbins(self) -> int:
        return self.high - self.low + 1

    def total_instances(self) -> int:
        """Sum f*U(f) with exact boundary instance counts."""
        u = self.as_unique()
        f = np.arange(u.low, u.high + 1, dtype=np.int64)
        inner = int((f[1:-1] * u.counts[1:-1]).sum()) if u.nbins > 2 else 0
        return inner + u.ilowcnt + u.ihighcnt

    def as_unique(self) -> "Histogram":
        return self._toggled(True)

    def as_instance(self) -> "Histogram":
        return self._toggled(False)

    def _toggled(self, want_unique: bool) -> "Histogram":
        """Convert between unique- and instance-count views.

        Mirrors toggle_histogram (reference: libfastk.c:20-48): interior bins
        are multiplied/divided by their frequency; boundary bins swap with the
        exact instance counts carried in the header.
        """
        if self.unique == want_unique:
            return self
        c = self.counts.copy()
        f = np.arange(self.low, self.high + 1, dtype=np.int64)
        if want_unique:  # instance -> unique
            new_ilow, new_ihigh = int(c[0]), int(c[-1])
            c = c // np.maximum(f, 1)
            c[0], c[-1] = self.ilowcnt, self.ihighcnt
        else:  # unique -> instance
            new_ilow, new_ihigh = int(c[0]), int(c[-1])
            c = c * f
            c[0], c[-1] = self.ilowcnt, self.ihighcnt
        return Histogram(self.kmer, self.low, self.high, c, new_ilow, new_ihigh,
                         unique=want_unique)

    def modified(self, low: int, high: int, unique: bool = True) -> "Histogram":
        """Sub-range view with boundary accumulation.

        Mirrors Modify_Histogram (reference: libfastk.c:136-185): the new
        boundary bins absorb everything outside [low, high], in the current
        counting mode; header instance counts absorb the same tails.
        """
        if low < self.low or high > self.high:
            raise ValueError("can only narrow a histogram")
        if (low, high) == (self.low, self.high):
            h = self
        else:
            c = self.counts
            under = int(c[: low - self.low + 1].sum())
            over = int(c[high - self.low:].sum())
            f = np.arange(self.low, self.high + 1, dtype=np.int64)
            if self.unique:
                tail_lo = int((c[1: low - self.low + 1] * f[1: low - self.low + 1]).sum())
                tail_hi = int((c[high - self.low: -1] * f[high - self.low: -1]).sum())
            else:
                tail_lo = int((c[1: low - self.low + 1] // np.maximum(f[1: low - self.low + 1], 1)).sum())
                tail_hi = int((c[high - self.low: -1] // np.maximum(f[high - self.low: -1], 1)).sum())
            nc = c[low - self.low: high - self.low + 1].copy()
            nc[0] = under
            nc[-1] = over
            h = Histogram(self.kmer, low, high, nc,
                          self.ilowcnt + tail_lo, self.ihighcnt + tail_hi,
                          unique=self.unique)
        return h._toggled(unique)

    @staticmethod
    def from_clipped_counts(kmer: int, counts: np.ndarray,
                            instance_overflow: int = 0) -> "Histogram":
        """Build the canonical FastK full-range histogram from per-unique-kmer
        counts that are already clipped at 0x7fff.

        ``counts`` is one entry per unique k-mer (any integer dtype);
        ``instance_overflow`` is the number of true instances lost to clipping
        (reference: hist_kmers MSDsort.c:491-509 tracks this in max_inst, plus
        the super-mer multiplicity overflow of count.c:455-458).
        """
        counts = np.asarray(counts)
        bins = np.bincount(np.clip(counts, 0, HIST_HIGH).astype(np.int64),
                           minlength=HIST_HIGH + 1)[1:].astype(np.int64)
        ilow = int(bins[0])  # I(1) == U(1)
        ihigh = int(bins[-1]) * HIST_HIGH + int(instance_overflow)
        return Histogram(kmer, HIST_LOW, HIST_HIGH, bins, ilow, ihigh)

    @staticmethod
    def from_bins(kmer: int, bins: np.ndarray,
                  instance_overflow: int = 0) -> "Histogram":
        """Build the full-range histogram from already-binned clipped counts.

        ``bins`` has 32768 entries; bins[c] = number of unique k-mers whose
        clipped count is c (bins[0] is ignored). This is the device-histogram
        entry point: the TPU pipeline bins counts on device and only the
        32768-bin array crosses to host."""
        bins = np.asarray(bins, dtype=np.int64)
        assert bins.shape == (HIST_HIGH + 1,)
        counts = bins[1:].copy()
        ilow = int(counts[0])
        ihigh = int(counts[-1]) * HIST_HIGH + int(instance_overflow)
        return Histogram(kmer, HIST_LOW, HIST_HIGH, counts, ilow, ihigh)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Histogram):
            return NotImplemented
        return (self.kmer, self.low, self.high, self.ilowcnt, self.ihighcnt,
                self.unique) == (other.kmer, other.low, other.high,
                                 other.ilowcnt, other.ihighcnt, other.unique) \
            and bool(np.array_equal(self.counts, other.counts))


def read_histogram(path: str) -> Histogram:
    """Load a ``.hist`` file (reference: Load_Histogram libfastk.c:51-97)."""
    with open(stub_path(path, ".hist"), "rb") as f:
        kmer, low, high, ilow, ihigh = _HEADER.unpack(f.read(_HEADER.size))
        counts = np.fromfile(f, dtype="<i8", count=high - low + 1)
    return Histogram(kmer, low, high, counts, ilow, ihigh)


def write_histogram(path: str, h: Histogram) -> None:
    """Write a ``.hist`` file (reference: Write_Histogram libfastk.c:189-225)."""
    u = h.as_unique()
    with open(stub_path(path, ".hist"), "wb") as f:
        f.write(_HEADER.pack(u.kmer, u.low, u.high, u.ilowcnt, u.ihighcnt))
        u.counts.astype("<i8").tofile(f)
