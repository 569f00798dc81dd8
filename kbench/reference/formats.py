"""Frozen readers of FastK's ``.hist``, ``.ktab`` and ``.prof`` file-sets, and
a ``.ktab`` writer, after FastK's README ("K-mer Histogram File", "K-mer
Table Files", "K-mer Profile Files").

A file-set is a stub ``<dir>/<base>.<ext>`` and hidden parts
``<dir>/.<base>.<ext>.<i>`` (1-based). The profile decoder runs in torch on
whatever device its tensors are on, over all profiles at once.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from kbench.reference.count import word_spans


def stub(path: str, ext: str) -> str:
    return path if path.endswith(ext) else path + ext


def part(path: str, ext: str, i: int) -> str:
    d, b = os.path.split(path[: -len(ext)] if path.endswith(ext) else path)
    return os.path.join(d, f".{b}{ext}.{i}")


# --- .hist ------------------------------------------------------------------

def hist_from_bytes(blob: bytes):
    """(k, (low, high, I(low), I(high)), U(low..high) int64 numpy) of a
    .hist file's bytes."""
    k, low, high, ilow, ihigh = struct.unpack_from("<iiiqq", blob)
    counts = np.frombuffer(blob, dtype="<i8", offset=28, count=high - low + 1)
    return k, (low, high, ilow, ihigh), counts


# --- .ktab and the word form of k-mers --------------------------------------

def read_ktab(path: str):
    """(k, minimum count, packed uint8 [n, ceil(k/4)], counts uint16 [n])."""
    with open(stub(path, ".ktab"), "rb") as f:
        k, nparts, minval, ibyte = struct.unpack("<iiii", f.read(16))
        index = np.fromfile(f, dtype="<i8", count=1 << (8 * ibyte))
    kb = (k + 3) // 4
    n = int(index[-1])
    packed = np.empty((n, kb), dtype=np.uint8)
    counts = np.empty(n, dtype=np.uint16)
    # an entry's first ibyte bytes are the prefix whose cumulative count
    # first passes its ordinal
    prefix = np.searchsorted(index, np.arange(n), side="right")
    for j in range(ibyte):
        packed[:, j] = (prefix >> (8 * (ibyte - 1 - j))) & 0xFF
    off = 0
    for p in range(nparts):
        with open(part(path, ".ktab", p + 1), "rb") as f:
            (k2,) = struct.unpack("<i", f.read(4))
            (m,) = struct.unpack("<q", f.read(8))
            if k2 != k or off + m > n:
                raise ValueError(f"{path}: part {p + 1} does not fit its stub")
            rec = np.fromfile(f, dtype=np.uint8, count=m * (kb - ibyte + 2))
        rec = rec.reshape(m, kb - ibyte + 2)
        packed[off: off + m, ibyte:] = rec[:, : kb - ibyte]
        counts[off: off + m] = rec[:, kb - ibyte:].copy().view("<u2")[:, 0]
        off += m
    if off != n:
        raise ValueError(f"{path}: parts hold {off} entries, stub {n}")
    return k, minval, packed, counts


def packed_to_words(packed: np.ndarray, k: int, device):
    """.ktab bytes (two bits a base, high bits first) -> the reference's
    word tuple, on `device`."""
    p = torch.from_numpy(np.ascontiguousarray(packed)).to(device)
    p = p.to(torch.int64)
    words = []
    for a, b in word_spans(k):
        w = torch.zeros(p.shape[0], dtype=torch.int64, device=device)
        for j in range(a, b):
            w.mul_(4).add_((p[:, j // 4] >> (6 - 2 * (j % 4))) & 3)
        words.append(w)
    return tuple(words)


def words_to_packed(words, k: int) -> np.ndarray:
    """The reference's word tuple -> .ktab bytes, uint8 [n, ceil(k/4)]."""
    n = words[0].shape[0]
    codes = torch.zeros((n, 4 * ((k + 3) // 4)), dtype=torch.int64,
                        device=words[0].device)
    for w, (a, b) in zip(words, word_spans(k)):
        for j in range(a, b):
            codes[:, j] = (w >> (2 * (b - 1 - j))) & 3
    c = codes.view(n, -1, 4)
    packed = (c[:, :, 0] << 6) | (c[:, :, 1] << 4) | (c[:, :, 2] << 2) \
        | c[:, :, 3]
    return packed.to(torch.uint8).cpu().numpy()


def write_ktab(path: str, k: int, minval: int, packed: np.ndarray,
               counts: np.ndarray, nparts: int = 4) -> None:
    """A .ktab file-set of sorted entries, in nparts parts cut where the
    index prefix changes."""
    n, kb = packed.shape
    ibyte = 3 if n > 0x4000000 and k >= 12 else (
        2 if n >= 0x40000 and k >= 8 else 1)
    prefix = np.zeros(n, dtype=np.int64)
    for j in range(ibyte):
        prefix = (prefix << 8) | packed[:, j]
    index = np.cumsum(np.bincount(prefix, minlength=1 << (8 * ibyte)))
    firsts = np.flatnonzero(np.diff(prefix, prepend=-1))
    cuts = [0]
    for t in range(1, nparts):
        j = int(np.searchsorted(firsts, n * t // nparts))
        cuts.append(int(firsts[j]) if j < len(firsts) else n)
    cuts.append(n)
    cuts = np.maximum.accumulate(cuts)
    with open(stub(path, ".ktab"), "wb") as f:
        f.write(struct.pack("<iiii", k, nparts, minval, ibyte))
        index.astype("<i8").tofile(f)
    rows = np.empty((n, kb - ibyte + 2), dtype=np.uint8)
    rows[:, : kb - ibyte] = packed[:, ibyte:]
    rows[:, kb - ibyte:] = np.ascontiguousarray(
        counts, dtype="<u2").view(np.uint8).reshape(n, 2)
    for p in range(nparts):
        lo, hi = int(cuts[p]), int(cuts[p + 1])
        with open(part(path, ".ktab", p + 1), "wb") as f:
            f.write(struct.pack("<iq", k, hi - lo))
            rows[lo:hi].tofile(f)


# --- .prof ------------------------------------------------------------------

def read_prof(path: str, device):
    """(k, lengths int64 [nreads], values int64 [sum of lengths]) of a
    profile file-set, the profiles decoded back to back in read order."""
    with open(stub(path, ".prof"), "rb") as f:
        k, nparts = struct.unpack("<ii", f.read(8))
    blobs, ends = [], []
    base = 0
    for p in range(nparts):
        with open(part(path, ".pidx", p + 1), "rb") as f:
            k2, _first, n = struct.unpack("<iqq", f.read(20))
            off = np.fromfile(f, dtype="<i8", count=n)
        if k2 != k or len(off) != n:
            raise ValueError(f"{path}: index part {p + 1} is malformed")
        data = np.fromfile(part(path, ".prof", p + 1), dtype=np.uint8)
        blobs.append(data)
        ends.append(off + base)
        base += len(data)
    blob = torch.from_numpy(np.concatenate(blobs) if blobs else
                            np.zeros(0, np.uint8)).to(device)
    end = torch.from_numpy(np.concatenate(ends) if ends else
                           np.zeros(0, np.int64)).to(device)
    start = torch.cat([end.new_zeros(1), end[:-1]])
    lengths, values = decode_profiles(blob, start, end)
    return k, lengths, values


def decode_profiles(blob: torch.Tensor, start: torch.Tensor,
                    end: torch.Tensor):
    """Decode every profile of a blob: profile i is blob[start[i]:end[i]].

    The codec (FastK's README): a profile's first count is one byte 0x
    (0..127) or two bytes 1x,y (15 bits); each later token is 00x (repeat the
    last count x times), 01x (add the 6-bit two's-complement x) or 1x,y (add
    the 15-bit y, modulo 2^15). A byte with the high bit set begins a
    two-byte token, so tokens are found without a scan: the first byte of a
    run of high-bit bytes begins a token, starts alternate inside the run,
    and a byte after a high-bit start is its second byte."""
    dev = blob.device
    nprof = len(start)
    b = blob.to(torch.int64)
    m = len(b)
    if m == 0:
        return torch.zeros(nprof, dtype=torch.int64, device=dev), b
    high = (b & 0x80) != 0
    first = high.clone()
    first[1:] &= ~high[:-1]
    run = torch.cumsum(first.to(torch.int64), 0) - 1
    first_at = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.nonzero(first).flatten()])
    in_run = torch.arange(m, device=dev) - first_at[run + 1]
    high_start = high & (in_run % 2 == 0)
    is_start = high_start.clone()
    low = ~high
    after_high_start = torch.zeros_like(high)
    after_high_start[1:] = high_start[:-1]
    is_start |= low & ~after_high_start
    tok = torch.nonzero(is_start).flatten()
    tb = b[tok]
    two = (tb & 0x80) != 0
    second = b[torch.clamp(tok + 1, max=m - 1)]
    v15 = ((tb & 0x7F) << 8) | second
    nonempty = end > start
    is_head = torch.zeros(m, dtype=torch.bool, device=dev)
    is_head[start[nonempty]] = True
    is_head = is_head[tok]
    head_val = torch.where(two, v15, tb)
    six = tb & 0x3F
    one = torch.where(six >= 32, six - 64, six)
    kind = tb & 0xC0
    is_run = ~two & (kind == 0) & ~is_head
    delta = torch.where(is_head, head_val,
                        torch.where(two, v15,
                                    torch.where(kind == 0x40, one, 0)))
    cs = torch.cumsum(delta, 0)
    prof = torch.cumsum(is_head.to(torch.int64), 0) - 1
    heads = torch.nonzero(is_head).flatten()
    base = cs[heads] - head_val[heads]
    value = torch.remainder(cs - base[prof], 1 << 15)
    reps = torch.where(is_run, six, 1)
    values = torch.repeat_interleave(value, reps)
    per_head = torch.zeros(len(heads), dtype=torch.int64, device=dev)
    per_head.scatter_add_(0, prof, reps)
    lengths = torch.zeros(nprof, dtype=torch.int64, device=dev)
    lengths[nonempty] = per_head
    return lengths, values
