"""`fastcat` — splice keyspace slices (tables/histograms) or read-partitioned
profiles into one result (reference: Fastcat.c:26-631):

    fastcat [-vk] [-htp] <target> <source>[.hist|.ktab|.prof] ...

Sources are consumed destructively unless -k is given.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from fastk_tpu_torch.formats.hist import Histogram, read_histogram, write_histogram
from fastk_tpu_torch.formats.prof import ProfileIndex
from fastk_tpu_torch.tools._cli import die

USAGE = "Usage: fastcat [-vk] [-htp] <target> <source>[.hist|.ktab|.prof] ..."


def cat_histograms(paths):
    hs = [read_histogram(p) for p in paths]
    k = hs[0].kmer
    total = hs[0].counts.astype(np.int64).copy()
    ilow, ihigh = hs[0].ilowcnt, hs[0].ihighcnt
    for h in hs[1:]:
        if h.kmer != k or h.low != hs[0].low or h.high != hs[0].high:
            die("fastcat: histograms are not compatible")
        total += h.counts
        ilow += h.ilowcnt
        ihigh += h.ihighcnt
    return Histogram(k, hs[0].low, hs[0].high, total, ilow, ihigh)


def _splice_part(src: str, dst: str, keep: bool) -> None:
    """Move one hidden part file into place. Hardlinking is only safe in
    the destructive path (sources are removed right after); with -k the
    reference COPIES (Fastcat.c keep path) precisely so the two tables
    never alias the same inode — a later in-place rewrite of one would
    silently corrupt the other."""
    import shutil

    if os.path.exists(dst):
        os.unlink(dst)
    if keep:
        shutil.copyfile(src, dst)
        return
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def cat_tables_spliced(paths, target: str, keep: bool = False) -> bool:
    """Reference Fastcat semantics (Fastcat.c:137-269): when every source
    shares the same prefix width (ibyte), part files are position
    independent — splice them VERBATIM (hardlink when destructive, copy
    with -k) and rebuild only the stub's merged prefix index. O(1) data
    movement. Returns False when sources disagree on ibyte (caller
    streams instead)."""
    import struct

    from fastk_tpu_torch.formats.ktab import KmerStream
    from fastk_tpu_torch.formats.paths import part_path, stub_path

    streams = [KmerStream(p) for p in paths]
    k = streams[0].kmer
    for s in streams[1:]:
        if s.kmer != k:
            die("fastcat: tables do not have a common k-mer size")
    ib = streams[0].ibyte
    if any(s.ibyte != ib for s in streams):
        return False
    kb = streams[0].kbyte
    minval = min(s.minval for s in streams)

    # seams: consecutive non-empty sources must be disjoint ordered slices
    prev_last = None
    for s in streams:
        if s.nels == 0:
            continue
        first = s.read_range(0, 1)[0].view(f"S{kb}").ravel()[0]
        if prev_last is not None and not prev_last < first:
            die("fastcat: sources are not disjoint ordered slices")
        prev_last = s.read_range(s.nels - 1, s.nels)[0].view(
            f"S{kb}").ravel()[0]

    pindex = np.zeros(1 << (8 * ib), dtype=np.int64)
    for s in streams:
        pindex += np.diff(s._pindex, prepend=0)
    np.cumsum(pindex, out=pindex)

    tot_parts = sum(s.nparts for s in streams)
    with open(stub_path(target, ".ktab"), "wb") as f:
        f.write(struct.pack("<iiii", k, tot_parts, minval, ib))
        pindex.astype("<i8").tofile(f)
    out = 0
    for s in streams:
        for p in range(s.nparts):
            out += 1
            _splice_part(part_path(s.path, ".ktab", p + 1),
                         part_path(target, ".ktab", out), keep)
    return True


def cat_tables_streamed(paths, target: str, nparts: int):
    """Splice keyspace table slices in O(window) memory: each source
    streams through KmerStream chunks into one KtabWriter. Sources are
    sorted by format invariant (Tabex -C checks that); only the SEAMS
    between consecutive sources need validating here."""
    from fastk_tpu_torch.formats.ktab import KmerStream, KtabWriter

    streams = [KmerStream(p) for p in paths]
    k = streams[0].kmer
    for s in streams[1:]:
        if s.kmer != k:
            die("fastcat: tables do not have a common k-mer size")
    kb = streams[0].kbyte
    minval = min(s.minval for s in streams)
    CHUNK = 1 << 20
    prev_last = None
    with KtabWriter(target, k, minval, nparts=nparts) as w:
        for s in streams:
            if s.nels == 0:
                continue
            first = s.read_range(0, 1)[0].view(f"S{kb}").ravel()[0]
            if prev_last is not None and not prev_last < first:
                die("fastcat: sources are not disjoint ordered slices")
            for lo in range(0, s.nels, CHUNK):
                hi = min(s.nels, lo + CHUNK)
                packed, counts = s.read_range(lo, hi)
                w.add(packed, counts)
            prev_last = s.read_range(s.nels - 1, s.nels)[0].view(
                f"S{kb}").ravel()[0]


def cat_profiles_spliced(paths, target: str, keep: bool = False) -> None:
    """Reference Fastcat semantics (Fastcat.c:330-430): .prof data parts
    are pure concatenations of encoded per-read blobs, so splice them
    VERBATIM (hardlink when destructive, copy with -k). Offsets in .pidx
    are part-local, so those copy through too — only each part's
    first-read ordinal in the .pidx header is rebased by the preceding
    sources' read totals."""
    import shutil
    import struct

    from fastk_tpu_torch.formats.paths import part_path, stub_path

    pis = [ProfileIndex(p) for p in paths]
    k = pis[0].kmer
    for p in pis[1:]:
        if p.kmer != k:
            die("fastcat: profiles do not have a common k-mer size")
    tot_parts = sum(pi.nparts for pi in pis)
    with open(stub_path(target, ".prof"), "wb") as f:
        f.write(struct.pack("<ii", k, tot_parts))
    out = base = 0
    for pi in pis:
        for p in range(pi.nparts):
            out += 1
            _splice_part(part_path(pi.path, ".prof", p + 1),
                         part_path(target, ".prof", out), keep)
            with open(part_path(pi.path, ".pidx", p + 1), "rb") as fin, \
                    open(part_path(target, ".pidx", out), "wb") as fout:
                k2, b, n = struct.unpack("<iqq", fin.read(20))
                fout.write(struct.pack("<iqq", k2, b + base, n))
                shutil.copyfileobj(fin, fout, 64 << 20)
        base += pi.nreads


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    verbose = keep = False
    do = set()
    pos = []
    for a in argv:
        if a.startswith("-") and len(a) > 1 and all(c in "vkhtp" for c in a[1:]):
            verbose |= "v" in a[1:]
            keep |= "k" in a[1:]
            do |= set(a[1:]) & set("htp")
        elif a.startswith("-"):
            die(f"fastcat: {a} is an illegal option\n{USAGE}")
        else:
            pos.append(a)
    if len(pos) < 2:
        die(USAGE)
    if not do:
        die("fastcat: at least one of -h, -t, -p must be set")
    target, sources = pos[0], pos[1:]

    roots = []
    for s in sources:
        r = s
        for ext in (".hist", ".ktab", ".prof"):
            if r.endswith(ext):
                r = r[: -len(ext)]
        roots.append(r)

    troot = target
    for ext in (".hist", ".ktab", ".prof"):
        if troot.endswith(ext):
            troot = troot[: -len(ext)]
    treal = os.path.realpath(troot)
    for r in roots:
        if os.path.realpath(r) == treal:
            die("fastcat: target must differ from every source")
    target = troot

    if "h" in do:
        write_histogram(target, cat_histograms([r + ".hist" for r in roots]))
    if "t" in do:
        if not cat_tables_spliced(roots, target, keep=keep):
            cat_tables_streamed(roots, target, nparts=max(1, len(roots)))
    if "p" in do:
        cat_profiles_spliced(roots, target, keep=keep)

    if not keep:
        from fastk_tpu_torch.tools.fastrm import main as fastrm_main

        exts = {"h": ".hist", "t": ".ktab", "p": ".prof"}
        for r in roots:
            for d in do:
                if os.path.exists(r + exts[d]):
                    fastrm_main(["-f", r + exts[d]])
    return 0


if __name__ == "__main__":
    sys.exit(main())
