"""`homex` — homopolymer error-rate statistics from a k-mer table
(reference: Homex.c, deprecated). For every homopolymer run centered on the
k-mer midpoint it aligns the table entries whose run lengths differ by one
(same flanking context) and, when the middle length is "good" (-g) and its
neighbours are rare (-e), tallies correct/−1/+1 instances per (symbol, run
length); the report sums a/t and c/g (Homex.c:146-368,476-488).

Faithful to the reference's mechanics, including its finger walk over the
first..last span of each run-length group (Homex.c:318-339): on c/g centers
the groups nest, and the walk visits nested longer-run entries unless the
exact `fing == fbeg[b+1]` jump fires — we reproduce that walk rather than a
clean groupby so output is byte-identical.
"""

from __future__ import annotations

import sys

import numpy as np

from fastk_tpu_torch.formats.ktab import read_ktab, unpack_codes
from fastk_tpu_torch.tools._cli import die

USAGE = "Usage: homex -e<int> -g<int>:<int> <source_root>[.ktab]"

MAX_HOMO_LEN = 10  # Homex.c:25
SLAB = 1 << 20  # entries unpacked per slab (snapped to block boundaries)


def _block_stats(codes: np.ndarray, counts: np.ndarray, k: int,
                 error: int, glo: int, ghi: int) -> np.ndarray:
    """profile[sym][hlen] = (lessone, correct, plusone), Homex.c:146-368."""
    n = len(codes)
    khalf = k // 2
    klong = khalf - MAX_HOMO_LEN // 2 - 1  # Homex.c:186-191
    profile = np.zeros((4, MAX_HOMO_LEN + 1, 3), np.int64)
    if n == 0:
        return profile

    # khalf-prefix blocks (the stream is sorted, so blocks are contiguous)
    pb = np.ascontiguousarray(codes[:, :khalf]).view(f"S{khalf}").ravel()
    starts = np.ones(n, bool)
    starts[1:] = pb[1:] != pb[:-1]
    block_first = np.flatnonzero(starts)
    block_last = np.append(block_first[1:], n)

    # center run: hsym at khalf-1; scan left down to klong-1 (Homex.c:200-205)
    hsym = codes[block_first, khalf - 1].astype(np.int64)
    span = codes[block_first, klong - 1: khalf - 1]  # columns klong-1..khalf-2
    neq = span != hsym[:, None]
    # hlen = 1 + last mismatching position (or klong-1 if none): mimic the
    # C loop that breaks at the first mismatch walking LEFT from khalf-2
    rev = neq[:, ::-1]  # index 0 == position khalf-2
    any_neq = rev.any(axis=1)
    first_neq = rev.argmax(axis=1)  # offset from khalf-2 going left
    hlen_pos = np.where(any_neq, khalf - 1 - first_neq, klong - 1)
    qualify = hlen_pos > klong  # Homex.c:207 ("hlen <= klong" skips)
    L = khalf - hlen_pos  # center run length, 1..MAX_HOMO_LEN/2

    # per-entry run extension j past khalf (exact symbol count)
    inv = codes[:, khalf:] != codes[:, khalf - 1][:, None]
    j_ext = np.where(inv.any(axis=1), inv.argmax(axis=1), k - khalf)

    cnt = counts.astype(np.int64)

    for b in np.flatnonzero(qualify):
        lo, hi = int(block_first[b]), int(block_last[b])
        hl = int(L[b])
        sym = int(hsym[b])
        kbase = khalf + hl - 1
        kextn = k - kbase

        # finger ranges: first/last entry per x = j-(hl-1) in 0..3
        x = j_ext[lo:hi] - (hl - 1)
        fbeg = np.zeros(5, np.int64)  # fbeg[4] = 0 sentinel (Homex.c:194)
        fend = np.full(4, -1, np.int64)
        for e in range(hi - lo):
            xe = int(x[e])
            if 0 <= xe <= 3:
                if fend[xe] < 0:
                    fbeg[xe] = e + 1  # 1-based so absent-group 0 ≠ real 0
                fend[xe] = e + 1
        if fend[1] < 0 and fend[2] < 0:  # Homex.c:289
            continue
        fing = np.zeros(4, np.int64)
        for i in range(3, -1, -1):  # Homex.c:292-297
            if fend[i] < 0:
                fing[i] = fend[i] = fbeg[i] = 0
            else:
                fing[i] = fbeg[i]
                fend[i] += 1

        counter = profile[sym]
        hlen2 = hl << 1

        while True:
            first = -1
            for i in range(4):
                if fing[i] < fend[i]:
                    first = i
                    break
            if first < 0:
                break
            bsel = first
            advn = [first]
            for i in range(first + 1, 4):
                if fing[i] < fend[i]:
                    # mybpcmp over kextn-i symbols from kbase+b / kbase+i
                    nsym = kextn - i
                    eb = lo + int(fing[bsel]) - 1
                    ei = lo + int(fing[i]) - 1
                    a_ = codes[eb, kbase + bsel: kbase + bsel + nsym]
                    b_ = codes[ei, kbase + i: kbase + i + nsym]
                    d = np.flatnonzero(a_ != b_)
                    v = 0 if len(d) == 0 else (
                        1 if a_[d[0]] < b_[d[0]] else -1)
                    if v == 0:
                        advn.append(i)
                    elif v < 0:
                        bsel = i
                        advn = [i]
            cn = [0, 0, 0, 0]
            for g in advn:
                cn[g] = int(cnt[lo + int(fing[g]) - 1])
                fing[g] += 1
                if fing[g] == fbeg[g + 1]:  # nested-range jump Homex.c:337
                    fing[g] = fend[g + 1] if g + 1 < 4 else fing[g]
            if glo <= cn[1] <= ghi and cn[0] <= error and cn[2] <= error:
                counter[hlen2] += (cn[0], cn[1], cn[2])
            elif glo <= cn[2] <= ghi and cn[1] <= error and cn[3] <= error:
                if hlen2 < MAX_HOMO_LEN:
                    counter[hlen2 + 1] += (cn[1], cn[2], cn[3])
    return profile


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    error = None
    glo = ghi = None
    pos = []
    for a in argv:
        if a.startswith("-e"):
            try:
                error = int(a[2:])
            except ValueError:
                die("homex: Syntax of -e option invalid -e<int>")
            if not 1 <= error <= 0x7FFF:
                die(f"homex: Error threshold {error} is out of range")
        elif a.startswith("-g"):
            try:
                lo, hi = a[2:].split(":")
                glo, ghi = int(lo), int(hi)
            except ValueError:
                die("homex: Syntax of -g option invalid -g<int>:<int>")
            if not (1 <= glo <= 0x7FFF and 1 <= ghi <= 0x7FFF):
                die("homex: count is out of range")
            if glo > ghi:
                die("homex: Good count range is invalid")
        elif a.startswith("-"):
            die(f"homex: {a} is an illegal option\n{USAGE}")
        else:
            pos.append(a)
    if len(pos) != 1:
        die(USAGE)
    if error is None:
        die("homex: Must give error count threshold -e")
    if glo is None:
        die("homex: Must give good count range -g")

    try:
        t = read_ktab(pos[0])
    except FileNotFoundError:
        die(f"homex: Cannot open {pos[0]}")
    k = t.kmer
    if k // 2 - MAX_HOMO_LEN // 2 < 10:  # Homex.c:187-191
        die(f"homex: A k-mer length of at least {20 + MAX_HOMO_LEN} "
            "is needed")

    # stream in slabs aligned to khalf-prefix block boundaries so the n×k
    # unpacked codes array never materializes whole (the block walk itself
    # is per-entry Python — fine for a deprecated stats tool, but memory
    # should not be the wall)
    khalf = k // 2
    pby, rem = divmod(khalf, 4)
    packed = t.packed
    n = len(packed)
    new_block = np.ones(n, bool)
    if n > 1:
        eq = (packed[1:, :pby] == packed[:-1, :pby]).all(axis=1)
        if rem:
            m = (0xFF << (8 - 2 * rem)) & 0xFF
            eq &= (packed[1:, pby] & m) == (packed[:-1, pby] & m)
        new_block[1:] = ~eq
    bstarts = np.flatnonzero(new_block)

    profile = np.zeros((4, MAX_HOMO_LEN + 1, 3), np.int64)
    si = 0
    while si < len(bstarts):
        sj = min(np.searchsorted(bstarts, bstarts[si] + SLAB, "left"),
                 len(bstarts))
        lo = int(bstarts[si])
        hi = n if sj == len(bstarts) else int(bstarts[sj])
        codes = unpack_codes(packed[lo:hi], k)
        profile += _block_stats(codes, t.counts[lo:hi], k, error, glo, ghi)
        si = sj

    # report: a/t then c/g tables, rows h=2..MAX_HOMO_LEN (Homex.c:469-488)
    print("\n              -1      Good          +1      Error Rate\n")
    for rows, label in (((0, 3), "at"), ((1, 2), "cg")):
        for h in range(2, MAX_HOMO_LEN + 1):
            cl = int(profile[rows[0], h, 0] + profile[rows[1], h, 0])
            cc = int(profile[rows[0], h, 1] + profile[rows[1], h, 1])
            cp = int(profile[rows[0], h, 2] + profile[rows[1], h, 2])
            tot = cc + cl + cp
            # glibc prints "-nan" for 0/0 (x86 default quiet NaN is negative)
            rate = f"{100.0 * (cl + cp) / tot:.1f}" if tot else "-nan"
            print(f" {h:2d} {label}: {cl:10d} {cc:10d} {cp:10d} -> {rate}%")
        if label == "at":
            print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
