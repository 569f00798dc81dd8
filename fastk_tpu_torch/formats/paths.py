"""FastK file-set path conventions.

A FastK artifact is a *stub* file ``<dir>/<base>.<ext>`` plus hidden part
files ``<dir>/.<base>.<ext>.<i>`` (1-based part index). Profiles pair a
``.prof`` data part with a ``.pidx`` offset part per thread.
(reference: README.md:143-164, libfastk.c naming in Open_Kmer_Stream /
Open_Profiles.)
"""

from __future__ import annotations

import os
from typing import List


def split_root(path: str, ext: str) -> tuple[str, str]:
    """Return (dir, base) where ``path`` optionally carries ``ext``.

    Mirrors the reference's PathTo/Root helpers (reference: gene_core.h:77-84).
    """
    d = os.path.dirname(path) or "."
    b = os.path.basename(path)
    if ext and b.endswith(ext):
        b = b[: -len(ext)]
    return d, b


def stub_path(path: str, ext: str) -> str:
    d, b = split_root(path, ext)
    return os.path.join(d, b + ext)


def part_path(path: str, ext: str, part: int) -> str:
    """Hidden part file for 1-based part index ``part``."""
    d, b = split_root(path, ext)
    return os.path.join(d, f".{b}{ext}.{part}")


def list_parts(path: str, ext: str, nparts: int) -> List[str]:
    return [part_path(path, ext, i + 1) for i in range(nparts)]


def hidden_files_of(path: str) -> List[str]:
    """Hidden part files belonging to stub ``path``.

    Extension-aware, matching the reference exactly (Fastrm.c:90-124):
    ``root.ktab`` owns ``.root.ktab.*``; ``root.prof`` owns BOTH
    ``.root.prof.*`` and ``.root.pidx.*``; ``root.hist`` owns nothing; a
    bare ``root`` (no recognized extension) owns all of them. Used by the
    Fastrm/Fastmv/Fastcp analogs and the Clean_Exit path.
    """
    d = os.path.dirname(path) or "."
    b = os.path.basename(path)
    want = (".ktab.", ".prof.", ".pidx.")
    for ext in (".ktab", ".prof", ".pidx", ".hist"):
        if b.endswith(ext):
            b = b[: -len(ext)]
            want = {".ktab": (".ktab.",),
                    ".prof": (".prof.", ".pidx."),
                    ".pidx": (".pidx.",),
                    ".hist": ()}[ext]
            break
    out = []
    try:
        entries = os.listdir(d)
    except FileNotFoundError:
        return out
    for e in entries:
        if not e.startswith("." + b + "."):
            continue
        rest = e[len("." + b) :]
        for ext in want:
            if rest.startswith(ext) and rest[len(ext) :].isdigit():
                out.append(os.path.join(d, e))
    return sorted(out)
