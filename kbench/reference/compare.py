"""What decides ``correct``: the reference's outputs against what a job wrote.

Every number compared counts entries that differ, so each limit is 0:
``hist_off`` the header fields and bins of a ``.hist`` (the worst job of the
window), ``ktab_off`` the ``.ktab`` entries (k-mer or count) and its header,
``prof_off`` the profile values and the profiles' lengths. A file that cannot
be read counts every entry it should hold.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from kbench.reference import count as ref
from kbench.reference.formats import (hist_from_bytes, packed_to_words,
                                      read_ktab, read_prof)
from kbench.reference.parse import read_sequences

LIMITS = {"hist_off": 0, "ktab_off": 0, "prof_off": 0}
UNREADABLE = (OSError, ValueError, RuntimeError, IndexError, struct.error)


def expected(traffic: dict, k: int, inputs: dict, device) -> dict:
    """The reference's outputs for one job of this traffic on these inputs:
    'hist' (header, bins), 'ktab' (minimum count, words, counts) and 'prof'
    (lengths, values), as the traffic's outputs ask."""
    want = traffic["outputs"]
    codes, rlen = load_reads(inputs[traffic["query"]], device)
    lengths = torch.clamp(rlen - k + 1, min=0)
    words = ref.canonical_words(codes, rlen, k)
    del codes
    out = {}
    if "relative_table_min" in traffic:
        t_words, t_counts = reads_table(inputs["reads"], k,
                                        traffic["relative_table_min"], device)
        out["prof"] = lengths, ref.relative_profiles(t_words, t_counts, words)
        return out
    uniq, counts, inverse = ref.count(words)
    del words
    if "hist" in want:
        out["hist"] = ref.histogram(counts)
    if "ktab" in want:
        tmin = traffic["table_min"]
        out["ktab"] = (tmin, *ref.table(uniq, counts, tmin))
    if "prof" in want:
        out["prof"] = lengths, ref.own_profiles(counts, inverse)
    return out


def reads_table(paths, k: int, tmin: int, device):
    """The -t<tmin> table of the reads in the files `paths`: (words,
    counts)."""
    codes, rlen = load_reads(paths, device)
    uniq, counts, _ = ref.count(ref.canonical_words(codes, rlen, k))
    return ref.table(uniq, counts, tmin)


def load_reads(paths, device):
    """(codes, read lengths) of a generated input, its files read as one
    sample in their order, as tensors on `device`."""
    parts = [read_sequences(p) for p in paths]
    codes = np.concatenate([c for c, _ in parts])
    rlen = np.concatenate([r for _, r in parts])
    del parts
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(rlen).to(device))


def judge(k: int, want: dict, out_base: str, hist_blobs, device) -> dict:
    """Each number compared: the job's files at out_base (and every job's
    .hist bytes) against the reference's outputs `want`."""
    got = {}
    if "hist" in want:
        got["hist"] = []
        for blob in hist_blobs:
            try:
                got["hist"].append(hist_from_bytes(blob))
            except UNREADABLE:
                got["hist"].append(None)
    if "ktab" in want:
        try:
            kk, tmin, packed, counts = read_ktab(out_base)
            got["ktab"] = (kk, tmin, packed_to_words(packed, kk, device),
                           torch.from_numpy(counts.astype(np.int64))
                           .to(device))
        except UNREADABLE:
            got["ktab"] = None
    if "prof" in want:
        try:
            kk, lengths, values = read_prof(out_base, device)
            got["prof"] = (kk, lengths, values)
        except UNREADABLE:
            got["prof"] = None
    return compare(k, want, got)


def compare(k: int, want: dict, got: dict) -> dict:
    """Entries that differ, by output. `got` holds 'hist': a list of (k,
    header, bins), one a job; 'ktab': (k, minimum count, words, counts);
    'prof': (k, lengths, values); None where a file could not be read."""
    out = {}
    if "hist" in want:
        header, bins = want["hist"]
        worst = 0
        for h in got["hist"] or [None]:
            if h is None or len(h[2]) != len(bins):
                off = len(bins) + len(header) + 1
            else:
                off = int(h[0] != k) + sum(
                    int(a != b) for a, b in zip(h[1], header)) + int(
                    (np.asarray(h[2]) != bins).sum())
            worst = max(worst, off)
        out["hist_off"] = worst
    if "ktab" in want:
        tmin, words, counts = want["ktab"]
        g = got["ktab"]
        if g is None:
            out["ktab_off"] = len(counts) + 2
        else:
            gk, gmin, gwords, gcounts = g
            out["ktab_off"] = int(gk != k) + int(gmin != tmin) + \
                _rows_off(words + (counts,), gwords + (gcounts,))
    if "prof" in want:
        lengths, values = want["prof"]
        g = got["prof"]
        if g is None:
            out["prof_off"] = int(lengths.sum()) + 1
        else:
            gk, glengths, gvalues = g
            out["prof_off"] = int(gk != k) + _profiles_off(
                lengths, values, glengths, gvalues)
    return out


def _rows_off(a, b) -> int:
    """Rows that differ in any column, a missing row differing."""
    na, nb = len(a[0]), len(b[0])
    n = min(na, nb)
    diff = torch.zeros(n, dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        diff |= x[:n] != y[:n].to(x.device)
    return int(diff.sum()) + abs(na - nb)


def _profiles_off(lengths, values, glengths, gvalues) -> int:
    """Profile values that differ: compared profile by profile over their
    common length, every value past it differing, and a missing profile
    differing in every value."""
    glengths, gvalues = glengths.to(values.device), gvalues.to(values.device)
    n = min(len(lengths), len(glengths))
    if n == len(lengths) == len(glengths) and bool(
            (lengths == glengths).all()):
        return int((values != gvalues).sum())
    a, b = lengths[:n], glengths[:n]
    m = torch.minimum(a, b)
    prof = torch.repeat_interleave(torch.arange(n, device=m.device), m)
    at = torch.arange(len(prof), device=m.device) - (torch.cumsum(m, 0)
                                                     - m)[prof]
    starts = torch.cumsum(lengths, 0) - lengths
    gstarts = torch.cumsum(glengths, 0) - glengths
    same = values[starts[prof] + at] == gvalues[gstarts[prof] + at]
    return (int(lengths[n:].sum()) + int(glengths[n:].sum())
            + int((a - b).abs().sum()) + int((~same).sum()))
