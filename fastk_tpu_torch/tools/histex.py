"""`histex` — display/convert .hist files (reference: Histex.c:27-274).

Output is byte-identical to the reference for the default, -k, -A, -G and
-h modes.
"""

from __future__ import annotations

import sys

from fastk_tpu_torch.formats.hist import read_histogram
from fastk_tpu_torch.tools._cli import die, print_number, root_name

USAGE = "Usage: histex [-1[a]] [-kAG] [-h[<int(1)>:]<int(-G?1000:100)>] <source_root>[.hist]"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    flags = {c: False for c in "kAG1a"}
    hist_set = False
    low, high = 1, 100
    pos = []
    for a in argv:
        if a.startswith("-h"):
            body = a[2:]
            try:
                if ":" in body:
                    lo, hi = body.split(":")
                    low, high = int(lo), int(hi)
                else:
                    low, high = 1, int(body)
            except ValueError:
                die("histex: Syntax of -h option invalid -h[<int(1)>:]<int>")
            if low < 1 or high < low:
                die("histex: Histogram range is invalid")
            hist_set = True
        elif a.startswith("-") and len(a) > 1 and all(c in flags for c in a[1:]):
            for c in a[1:]:
                flags[c] = True
        elif a.startswith("-"):
            die(f"histex: {a} is an illegal option\n{USAGE}")
        else:
            pos.append(a)
    if len(pos) != 1:
        die(USAGE)

    ascii_out = flags["A"]
    unique = not flags["k"]
    gscope = flags["G"]
    if high > 0x7FFF:
        high = 0x7FFF
    if gscope:
        ascii_out = True
        unique = True
        if hist_set:
            low = 1
            high = max(high, 1000)
        else:
            high = 1000
        hist_set = True

    try:
        h = read_histogram(pos[0])
    except FileNotFoundError:
        die(f"histex: Cannot open {pos[0]}")

    if hist_set:
        if low < h.low or high > h.high:
            die(f"histex: Range of histogram, [{h.low},{h.high}], does not"
                " superset requested range")
    else:
        low = max(low, h.low)
        high = min(high, h.high)

    if flags["1"]:
        from fastk_tpu_torch.formats.onecode import write_khist

        m = h.modified(low, high, True)
        cmd = "histex " + " ".join(argv) + " >?.khist"
        write_khist(m.counts, pos[0] if pos[0].endswith(".hist")
                    else pos[0] + ".hist", low, high, cmd,
                    binary=not flags["a"])
        return 0

    m = h.modified(low, high, unique)
    hist = m.counts

    if ascii_out:
        vals = hist.copy()
        if gscope:
            # pseudo-unique count for the top bin (reference: Histex.c:212)
            vals[-1] = m.ihighcnt // high
        for j in range(low, high + 1):
            if vals[j - low] > 0:
                print(f"{j}\t{vals[j - low]}")
        return 0

    root = root_name(pos[0], ".hist")
    if unique:
        print(f"\nHistogram of unique {m.kmer}-mers of {root}")
    else:
        print(f"\nHistogram of {m.kmer}-mer instances of {root}")

    stotal = int(hist.sum())
    print(f"\n  Input: {print_number(stotal)} ", end="")
    print(f"unique {m.kmer}-mers" if unique else f"{m.kmer}-mer instances")

    if stotal == 0:
        print("\n     Empty")
        return 0

    print("\n     Freq:        Count   Cum. %")
    ssum = int(hist[-1])
    if ssum > 0:
        print(f" >= {high:5d}: {ssum:12d}   {100.0*ssum/stotal:5.1f}%")
    for j in range(high - 1, low, -1):
        ssum += int(hist[j - low])
        if hist[j - low] > 0:
            print(f"    {j:5d}: {int(hist[j-low]):12d}   {100.0*ssum/stotal:5.1f}%")
    if high > 1 and hist[0] > 0:
        if low == 1:
            print(f"    {1:5d}: {int(hist[0]):12d}   100.0%")
        else:
            print(f" <= {low:5d}: {int(hist[0]):12d}   100.0%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
