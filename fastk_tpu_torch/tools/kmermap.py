"""The port's ``kmermap``: .bed intervals of a target covered by a table's
k-mers.

    python -m fastk_tpu_torch.tools.kmermap [-vm] [-T<int(4)>] [-P<dir>]
        <kmers>[.ktab] <target>[.fast[aq][.gz]] <out>

Port of ``fastk_tpu/tools/kmermap.py`` (reference: KmerMap.c): the target's
relative profiles against the table come from the port's own count_files
(``-p:<table>`` on the device). Writes <out>.<target root>.kmers.bed, one
row ``read beg end table`` per position whose k-mer is in the table, or with
-m <out>.<target root>.kmers.merge.bed, overlapping intervals merged. -T and
-P are accepted and unused, as in the JAX tool.
"""

from __future__ import annotations

import sys

import numpy as np

from fastk_tpu_torch.formats.ktab import read_ktab
from fastk_tpu_torch.tools._cli import die, root_name
from fastk_tpu_torch.pipeline.count import count_files

USAGE = ("Usage: kmermap [-vm] [-T<int(4)>] [-P<dir(/tmp)> <kmers>[.ktab]"
         " <target>[.\"dna\"] <out:bed>")


def _intervals(prof: np.ndarray, k: int, merge: bool):
    """(begin, end) of each bed row of one read's profile."""
    hits = np.flatnonzero(prof > 0)
    if not merge or len(hits) == 0:
        return hits, hits + k
    # a hit past the end of the interval before it starts a new one
    new = np.ones(len(hits), bool)
    new[1:] = hits[1:] > hits[:-1] + k
    first = np.flatnonzero(new)
    last = np.append(first[1:], len(hits)) - 1
    return hits[first], hits[last] + k


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    verbose = merge = False
    pos = []
    for a in argv:
        if a.startswith("-") and len(a) > 1 and all(c in "vm" for c in a[1:]):
            verbose |= "v" in a[1:]
            merge |= "m" in a[1:]
        elif a.startswith("-T") or a.startswith("-P"):
            pass
        elif a.startswith("-"):
            die(f"kmermap: {a} is an illegal option\n{USAGE}")
        else:
            pos.append(a)
    if len(pos) != 3:
        die(USAGE)
    ktab, target, outbed = pos

    try:
        table = read_ktab(ktab)
    except FileNotFoundError:
        die(f"kmermap: Cannot open {ktab}")
    k = table.kmer
    proot = root_name(ktab, ".ktab")
    troot = root_name(target, "")
    for ext in (".fasta", ".fa", ".fastq", ".fq", ".dna", ".gz"):
        if troot.endswith(ext):
            troot = troot[: -len(ext)]

    out = count_files([target], k, relative_table=table, profiles=True,
                      verbose=verbose, device=device)

    suffix = "kmers.merge.bed" if merge else "kmers.bed"
    path = f"{outbed}.{troot}.{suffix}"
    with open(path, "w") as f:
        for p, prof in enumerate(out.profiles):
            beg, end = _intervals(prof, k, merge)
            f.writelines(f"{p}\t{b}\t{e}\t{proot}\n"
                         for b, e in zip(beg.tolist(), end.tolist()))
    if verbose:
        print(f"  wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
