"""`fastrm` — delete FastK stub + hidden part file-sets as one unit
(reference: Fastrm.c:26-167; semantics README.md:143-156)."""

from __future__ import annotations

import glob
import os
import sys

from fastk_tpu_torch.formats.paths import hidden_files_of
from fastk_tpu_torch.tools._cli import die

USAGE = "Usage: fastrm [-if] <source>[.hist|.ktab|.prof] ..."


def expand_targets(arg: str):
    """Stub files matching arg (with or without extension, glob-able)."""
    exts = (".hist", ".ktab", ".prof")
    if arg.endswith(exts):
        cands = glob.glob(arg) or [arg]
    else:
        cands = []
        for e in exts:
            cands.extend(glob.glob(arg + e))
        if not cands:
            cands = [arg + e for e in exts if os.path.exists(arg + e)]
    return cands


def files_of_set(stub: str) -> list:
    """Every file of a stub's file set: the stub plus its hidden parts
    (extension-aware — .prof owns the .pidx parts; see
    paths.hidden_files_of, matching Fastrm.c:90-124)."""
    return list(dict.fromkeys([stub] + hidden_files_of(stub)))


def remove_set(stub: str, force: bool = False) -> None:
    """Remove one stub file and its hidden parts (library entry; the
    Clean_Exit path uses this to drop partial outputs, FastK.c:181-221)."""
    for f in files_of_set(stub):
        try:
            os.unlink(f)
        except FileNotFoundError:
            if not force:
                raise


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    inter = force = False
    pos = []
    for a in argv:
        if a.startswith("-") and len(a) > 1 and all(c in "if" for c in a[1:]):
            inter |= "i" in a[1:]
            force |= "f" in a[1:]
        elif a.startswith("-"):
            die(f"fastrm: {a} is an illegal option\n{USAGE}")
        else:
            pos.append(a)
    if not pos:
        die(USAGE)

    status = 0
    for arg in pos:
        stubs = expand_targets(arg)
        if not stubs:
            if not force:
                print(f"fastrm: {arg}: No such file set", file=sys.stderr)
                status = 1
            continue
        for stub in stubs:
            if inter:
                ans = input(f"fastrm: remove {stub}? ")
                if not ans.lower().startswith("y"):
                    continue
            for f in files_of_set(stub):
                try:
                    os.unlink(f)
                except FileNotFoundError:
                    if not force:
                        print(f"fastrm: {f}: No such file", file=sys.stderr)
                        status = 1
    return status


if __name__ == "__main__":
    sys.exit(main())
