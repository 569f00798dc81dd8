"""Shared CLI helpers mirroring the reference's hand-rolled arg conventions
(reference: gene_core.h:32-105 ARG_* macros, Print_Number)."""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Tuple


def print_number(n: int) -> str:
    """Comma-grouped integer (reference: Print_Number gene_core.h:104)."""
    return f"{n:,}"


def parse_args(argv: List[str], flag_chars: str, opt_prefixes: Tuple[str, ...] = ()):
    """Split argv into (flags, options, positionals).

    flag_chars: single-char flags that may be concatenated (e.g. "-kAG").
    opt_prefixes: option names that take a value glued on (e.g. "T", "P",
    "h", "bc"); longest match wins.
    """
    flags: Dict[str, bool] = {c: False for c in flag_chars}
    opts: Dict[str, str] = {}
    pos: List[str] = []
    for a in argv:
        if a.startswith("-") and len(a) > 1:
            body = a[1:]
            m = None
            for p in sorted(opt_prefixes, key=len, reverse=True):
                if body.startswith(p):
                    m = p
                    break
            if m is not None:
                opts[m] = body[len(m):]
                continue
            if all(c in flags for c in body):
                for c in body:
                    flags[c] = True
                continue
            die(f"{prog()}: -{body} is an illegal option")
        else:
            pos.append(a)
    return flags, opts, pos


def prog() -> str:
    return os.path.basename(sys.argv[0])


def die(msg: str, code: int = 1):
    print(msg, file=sys.stderr)
    sys.exit(code)


def root_name(path: str, ext: str) -> str:
    """Basename with ext stripped (reference: Root gene_core.h:80)."""
    b = os.path.basename(path)
    if ext and b.endswith(ext):
        b = b[: -len(ext)]
    return b


def source_root(path: str) -> str:
    """Input path minus any known sequence-file suffix (reference: FastK's
    <source> naming rule, README.md:76-83)."""
    for ext in (".cram", ".bam", ".sam", ".db", ".dam",
                ".fasta.gz", ".fastq.gz", ".fa.gz", ".fq.gz", ".fna.gz",
                ".fasta", ".fastq", ".fa", ".fq", ".fna", ".gz"):
        if path.endswith(ext):
            return path[: -len(ext)]
    return path
