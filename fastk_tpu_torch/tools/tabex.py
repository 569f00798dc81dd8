"""`tabex` — list/query/validate .ktab files (reference: Tabex.c:274-408).

Addresses are entry ordinals or dna strings (a prefix selects the range of
all k-mers starting with it, reference: Interpret Tabex.c:224-271).
"""

from __future__ import annotations

import sys

import numpy as np

from fastk_tpu_torch.formats.ktab import KmerStream, kmer_to_string
from fastk_tpu_torch.tools._cli import die, print_number

USAGE = "Usage: tabex [-1[a]AC] [-t<int>] <source>[.ktab] [ <address>[-<address>] ]"

_SHIFTUP = {"a": "c", "c": "g", "g": "t"}


def _interpret(s: KmerStream, x: str, beg: bool) -> int:
    try:
        d = int(x)
        if d >= s.nels:
            die(f"tabex: Index {x} is out of bounds")
        return d if beg else d + 1
    except ValueError:
        pass
    if any(c not in "acgtACGT" for c in x):
        die(f"tabex: String {x} is not dna (acgt)")
    if len(x) > s.kmer:
        die(f"tabex: String {x} is longer than k-mer size ({s.kmer})")
    u = list(x.lower())
    if not beg:
        n = len(u) - 1
        while n >= 0 and u[n] == "t":
            n -= 1
        if n < 0:
            return s.nels
        u[n] = _SHIFTUP[u[n]]
        del u[n + 1:]
    q = "".join(u) + "a" * (s.kmer - len(u))
    s.goto_kmer(q)
    return s.idx


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    flags = {c: False for c in "1ACa"}
    cut = 0
    pos = []
    for a in argv:
        if a.startswith("-t"):
            cut = int(a[2:])
        elif a.startswith("-") and len(a) > 1 and all(c in flags for c in a[1:]):
            for c in a[1:]:
                flags[c] = True
        elif a.startswith("-"):
            die(f"tabex: {a} is an illegal option\n{USAGE}")
        else:
            pos.append(a)
    if not 1 <= len(pos) <= 2:
        die(USAGE)
    if flags["C"] and (flags["1"] or flags["A"] or cut > 0):
        die("tabex: -C option incompatible with all other options")

    try:
        s = KmerStream(pos[0])
    except FileNotFoundError:
        die(f"tabex: Cannot open {pos[0]}")

    if len(pos) == 1:
        bidx, eidx = 0, s.nels
    else:
        x = pos[1]
        if "-" in x:
            a, b = x.split("-", 1)
            bidx, eidx = _interpret(s, a, True), _interpret(s, b, False)
        else:
            bidx, eidx = _interpret(s, x, True), _interpret(s, x, False)

    if bidx == eidx:
        print("\nNothing found in range given !")
        return 0

    if flags["C"]:
        packed, _ = s.read_range(bidx, eidx)
        view = packed.view(f"S{packed.shape[1]}").ravel()
        bad = np.flatnonzero(~(view[:-1] < view[1:]))
        if len(bad):
            i = int(bad[0])
            print(f"\nOut of Order at {bidx + i}")
            return 1
        print("\nTable is OK")
        return 0

    if flags["1"]:
        from fastk_tpu_torch.formats.onecode import write_kmr

        cmd = "tabex " + " ".join(argv) + " >?.kmr"
        write_kmr(s, cut, cmd, binary=not flags["a"])
        return 0

    if not flags["A"]:
        msg = (f"Opening {s.kmer}-mer table with {print_number(s.nels)} entries")
        if s.minval > 1:
            msg += f" occuring {s.minval}-or-more times"
        print(msg)

    CHUNK = 1 << 16
    for lo in range(bidx, eidx, CHUNK):
        hi = min(lo + CHUNK, eidx)
        packed, counts = s.read_range(lo, hi)
        for j in range(hi - lo):
            c = int(counts[j])
            if c < cut:
                continue
            km = kmer_to_string(packed[j], s.kmer)
            if flags["A"]:
                print(f"{km}\t{c}")
            else:
                print(f" {lo+j:9d}: {km} = {c:5d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
