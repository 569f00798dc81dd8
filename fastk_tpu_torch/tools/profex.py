"""`profex` — decode and print read profiles (reference: Profex.c:32-240)."""

from __future__ import annotations

import sys

from fastk_tpu_torch.formats.prof import ProfileIndex
from fastk_tpu_torch.tools._cli import die

USAGE = "Usage: profex [-1[a]Az] <source_root>[.prof] [ <read:int>[-(<read:int>|#)] ... ]"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    flags = {c: False for c in "1Aza"}
    pos = []
    for a in argv:
        if a.startswith("-") and len(a) > 1 and all(c in flags for c in a[1:]):
            for c in a[1:]:
                flags[c] = True
        elif a.startswith("-") and len(a) > 1 and not a[1:].isdigit():
            die(f"profex: {a} is an illegal option\n{USAGE}")
        else:
            pos.append(a)
    if len(pos) < 1:
        die(USAGE)

    try:
        pi = ProfileIndex(pos[0])
    except FileNotFoundError:
        die(f"profex: Cannot open {pos[0]}")
    nmax = pi.nreads

    ranges = []
    for x in pos[1:]:
        if "-" in x[1:]:
            a, b = x.split("-", 1)
            id1 = int(a)
            id2 = nmax if b == "#" else int(b)
        else:
            id1 = id2 = int(x)
        if id1 > id2:
            die(f"profex: range {x} is empty!")
        if id1 <= 0 or id2 > nmax:
            die(f"profex: Range {x} is out of range [1,{nmax}]")
        ranges.append((id1, id2))
    if not ranges:
        ranges = [(1, nmax)]

    if flags["1"]:
        from fastk_tpu_torch.formats.onecode import write_prf

        cmd = "profex " + " ".join(argv) + " >?.prf"
        write_prf((pi.fetch(p - 1) for id1, id2 in ranges
                   for p in range(id1, id2 + 1)), cmd,
                  binary=not flags["a"])
        return 0

    zflag, aflag = flags["z"], flags["A"]
    for id1, id2 in ranges:
        for p in range(id1, id2 + 1):
            prof = pi.fetch(p - 1)
            if aflag:
                print(f"Read\t{p}")
                if zflag:
                    _print_z(prof, ascii_out=True)
                else:
                    for v in prof:
                        print(v)
            else:
                print(f"\nRead {p}:")
                if zflag:
                    _print_z(prof, ascii_out=False)
                else:
                    for i, v in enumerate(prof):
                        print(f" {i:5d}: {v:5d}")
    return 0


def _print_z(prof, ascii_out):
    """Run-compressed display skipping zeros (reference: Profex.c:183-219)."""
    last = 0
    for i, v in enumerate(prof):
        if v != last:
            if last != 0:
                if ascii_out:
                    print(f"\t{i-1}\t{last}")
                else:
                    print(f" - {i-1:5d} ({last})")
            if v != 0:
                print(f"{i}" if ascii_out else f" {i:5d}", end="")
            last = int(v)
    if last != 0:
        n = len(prof)
        if ascii_out:
            print(f"\t{n-1}\t{last}")
        else:
            print(f" - {n-1:5d} ({last})")


if __name__ == "__main__":
    sys.exit(main())
