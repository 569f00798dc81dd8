"""`haplex` — find haplotype (het-SNP) k-mer groups: k-mers identical except
at the middle base, all with counts in the -g range (reference: Haplex.c,
deprecated). Output: one line per k-mer, middle base uppercased, with its
count; groups separated by blank lines. `-H` switches to the numbered
site-tag listing of Find_Haplo_Pairs2 (Haplex.c:290-461)."""

from __future__ import annotations

import sys

import numpy as np

from fastk_tpu_torch.formats.ktab import read_ktab, unpack_codes
from fastk_tpu_torch.tools._cli import die

USAGE = "Usage: haplex [-H] [-g<int>:<int>] <source>[.ktab]"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    glo, ghi = 1, 0x7FFF
    haynes = False
    pos = []
    for a in argv:
        if a.startswith("-g"):
            try:
                lo, hi = a[2:].split(":")
                glo, ghi = int(lo), int(hi)
            except ValueError:
                die("haplex: Syntax of -g option invalid -g<int>:<int>")
        elif a == "-H":
            haynes = True
        elif a.startswith("-"):
            die(f"haplex: {a} is an illegal option\n{USAGE}")
        else:
            pos.append(a)
    if len(pos) != 1:
        die(USAGE)

    try:
        t = read_ktab(pos[0])
    except FileNotFoundError:
        die(f"haplex: Cannot open {pos[0]}")

    k = t.kmer
    mid = k // 2
    codes = unpack_codes(t.packed, k)
    good = (t.counts >= glo) & (t.counts <= ghi)
    if haynes:
        return _haynes_mode(codes, good, k, mid)
    codes = codes[good]
    counts = t.counts[good]

    # group by flanks: zero the middle base, sort, emit groups of size >= 2
    order, starts = _flank_groups(codes, k, mid)
    codes, counts = codes[order], counts[order]
    bounds = np.flatnonzero(starts).tolist() + [len(codes)]

    bases = "acgt"
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        if hi - lo < 2:
            continue
        for j in range(lo, hi):
            s = "".join(bases[c] for c in codes[j])
            s = s[:mid] + s[mid].upper() + s[mid + 1:]
            print(f"{s} {counts[j]}")
        print()
    return 0


def _flank_groups(codes: np.ndarray, k: int, mid: int):
    """Stable sort order over (flanks with middle base zeroed) plus the
    group-start mask in that order — the het-site grouping both listings
    share (Haplex.c's k-way suffix merge visits groups in this order)."""
    flank = codes.copy()
    flank[:, mid] = 0
    fb = np.ascontiguousarray(flank).view(f"S{k}").ravel()
    order = np.argsort(fb, kind="stable")
    fb_s = fb[order]
    starts = np.ones(len(fb_s), bool)
    if len(fb_s):
        starts[1:] = fb_s[1:] != fb_s[:-1]
    return order, starts


def _haynes_mode(codes, good, k: int, mid: int) -> int:
    """The -H listing (Haplex.c:Find_Haplo_Pairs2): het-site members are
    tagged site_no<<2 | variant_rank and printed in TABLE order as
    ` %6d: %c <kmer>` — variant_rank is the rank of the middle base among
    the distinct middle bases of the whole khalf-PREFIX group (good or
    not), the letter is dna[tag & 0x2] (sic — the reference masks with
    0x2, Haplex.c:448), and a total line follows."""
    n = len(codes)
    bases = "acgt"
    total = 0
    if n:
        # variant rank within each khalf-prefix group, over ALL entries
        midb = codes[:, mid].astype(np.int64)
        new_pref = np.ones(n, bool)
        if mid:
            pb = np.ascontiguousarray(codes[:, :mid]).view(f"S{mid}").ravel()
            new_pref[1:] = pb[1:] != pb[:-1]
        else:
            new_pref[1:] = False
        new_var = new_pref.copy()
        new_var[1:] |= midb[1:] != midb[:-1]
        vcum = np.cumsum(new_var)
        gstart = np.maximum.accumulate(
            np.where(new_pref, np.arange(n), 0))
        vrank = vcum - vcum[gstart]

        # het sites = flank groups with >=2 in-range members, numbered in
        # (prefix, suffix) discovery order
        order, starts = _flank_groups(codes, k, mid)
        gid = np.cumsum(starts) - 1
        ngood = np.bincount(gid, weights=good[order].astype(np.float64))
        qual = ngood >= 2
        site_no = np.cumsum(qual)  # 1-based for qualifying groups
        tag_s = np.where(qual[gid] & good[order],
                         site_no[gid].astype(np.int64) << 2, 0)
        tags = np.empty(n, np.int64)
        tags[order] = tag_s
        tags = np.where(tags > 0, tags | vrank, 0)
        total = int(qual.sum())

        for i in np.flatnonzero(tags):
            f = int(tags[i])
            s = "".join(bases[c] for c in codes[i])
            s = s[:mid] + s[mid].upper() + s[mid + 1:]
            print(f" {f >> 2:6d}: {bases[f & 0x2]} {s}")
    print(f"A total of {total} hetero-sites found")
    return 0


if __name__ == "__main__":
    sys.exit(main())
