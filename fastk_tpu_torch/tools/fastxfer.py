"""Shared implementation of `fastmv`/`fastcp` — move/copy a FastK stub with
all its hidden parts as one unit (reference: Fastxfer.c:29-243, compiled
twice with/without -DMOVE, Makefile:31-35)."""

from __future__ import annotations

import os
import shutil
import sys

from fastk_tpu_torch.formats.paths import hidden_files_of
from fastk_tpu_torch.tools._cli import die
from fastk_tpu_torch.tools.fastrm import expand_targets


def xfer_main(argv, move: bool):
    name = "fastmv" if move else "fastcp"
    usage = f"Usage: {name} [-inf] <source>[.hist|.ktab|.prof] ... <dest>"
    inter = force = no_overwrite = False
    pos = []
    for a in argv:
        if a.startswith("-") and len(a) > 1 and all(c in "inf" for c in a[1:]):
            inter |= "i" in a[1:]
            no_overwrite |= "n" in a[1:]
            force |= "f" in a[1:]
        elif a.startswith("-"):
            die(f"{name}: {a} is an illegal option\n{usage}")
        else:
            pos.append(a)
    if len(pos) < 2:
        die(usage)
    dest = pos[-1]
    sources = pos[:-1]
    many = len(sources) > 1 or os.path.isdir(dest)
    if many and not os.path.isdir(dest):
        die(f"{name}: target {dest} is not a directory")

    status = 0
    for arg in sources:
        stubs = expand_targets(arg)
        if not stubs:
            if not force:
                print(f"{name}: {arg}: No such file set", file=sys.stderr)
                status = 1
            continue
        for stub in stubs:
            d = os.path.dirname(stub) or "."
            b = os.path.basename(stub)
            root, ext = os.path.splitext(b)
            if os.path.isdir(dest):
                new_stub = os.path.join(dest, b)
            else:
                nb = os.path.basename(dest)
                if not nb.endswith(ext):
                    nb += ext
                new_stub = os.path.join(os.path.dirname(dest) or ".", nb)
            if os.path.exists(new_stub):
                if no_overwrite:
                    continue
                if inter:
                    ans = input(f"{name}: overwrite {new_stub}? ")
                    if not ans.lower().startswith("y"):
                        continue
            pairs = [(stub, new_stub)]
            nd = os.path.dirname(new_stub) or "."
            nroot = os.path.basename(new_stub)[: -len(ext)] if ext else os.path.basename(new_stub)
            # hidden_files_of is extension-aware: .prof owns its .pidx
            # parts, .ktab only its own (Fastrm.c:90-124 semantics)
            for h in hidden_files_of(stub):
                hb = os.path.basename(h)  # .<root>.<ext2>.<i>
                rest = hb[len("." + root):]
                pairs.append((h, os.path.join(nd, "." + nroot + rest)))
            for src, dst in dict.fromkeys(pairs):
                if move:
                    shutil.move(src, dst)
                else:
                    shutil.copy2(src, dst)
    return status
