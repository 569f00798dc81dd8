"""`vennex` — per-region histograms of the Venn diagram of 2-4 tables
(reference: Vennex.c, deprecated). For each non-empty region, writes
<NAMES>.hist where each table's name is uppercased if the region includes it
and lowercased otherwise, joined by '_' (reference: Vennex.c:310-321). A
k-mer's count in a region is the minimum of its counts over the member
tables (reference: Venn2 Vennex.c:80-86).

Each region is exactly a logex expression — min over members, zero if any
non-member holds the key: ``(a &< b) - c``. All 2^n - 1 regions evaluate
in ONE streamed pass of the fused native per-key engine
(algebra.logex_apply_streamed, histogram-only), so tables larger than RAM
work in O(window) memory — unlike the reference Vennex, which loads
everything (and is deprecated because it crashes).
"""

from __future__ import annotations

import os
import struct
import sys

import numpy as np

from fastk_tpu_torch.tools._cli import die

USAGE = "Usage: vennex [-h[<int(1)>:]<int(100)>] <source_1>[.ktab] <source_2>[.ktab] ..."


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
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
                    high = int(body)
            except ValueError:
                die("vennex: invalid -h syntax")
        elif a.startswith("-"):
            die(f"vennex: {a} is an illegal option\n{USAGE}")
        else:
            pos.append(a)
    if len(pos) < 2 or len(pos) > 4:
        die(USAGE)

    from fastk_tpu_torch.algebra import logex_apply_streamed
    from fastk_tpu_torch.formats.ktab import KmerStream
    from fastk_tpu_torch.formats.paths import stub_path

    roots, names = [], []
    for s in pos:
        root = s[:-5] if s.endswith(".ktab") else s
        if not os.path.exists(stub_path(root, ".ktab")):
            die(f"vennex: Cannot open {s}")
        roots.append(root)
        names.append(os.path.basename(root).split(".")[0])
    kmer = KmerStream(roots[0]).kmer
    for r in roots[1:]:
        if KmerStream(r).kmer != kmer:
            die("vennex: K-mer tables do not involve the same K")

    nway = len(roots)
    assigns = []
    fnames = []
    for region in range(1, 1 << nway):
        mem = [chr(ord("a") + c) for c in range(nway) if region & (1 << c)]
        non = [chr(ord("a") + c) for c in range(nway)
               if not region & (1 << c)]
        e = "&<".join(mem)
        if len(mem) > 1:
            e = "(" + e + ")"
        for x in non:
            e += "-" + x
        fname = "_".join(
            names[c].upper() if region & (1 << c) else names[c].lower()
            for c in range(nway)) + ".hist"
        assigns.append((fname, e))
        fnames.append(fname)

    results = logex_apply_streamed(assigns, roots, hist_range=(low, high),
                                   do_table=False)
    for fname, h in results:
        bins = np.asarray(h.counts, dtype=np.int64)
        # deprecated-tool quirk: the boundary header fields duplicate the
        # boundary bins (Vennex.c:323-327) rather than holding instance sums
        with open(fname, "wb") as f:
            f.write(struct.pack("<iiiqq", kmer, low, high,
                                int(bins[0]), int(bins[-1])))
            bins.astype("<i8").tofile(f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
