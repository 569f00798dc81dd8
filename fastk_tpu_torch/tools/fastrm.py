"""Removal of FastK file-sets: a stub and its hidden parts as one unit.

The port's copy of the library part of ``fastk_tpu/tools/fastrm.py``
(reference: Fastrm.c:26-167; semantics README.md:143-156). The ``fastrm``
command itself is not ported; the CLI's cleanup on failure and the chip
smoke run use ``remove_set``.
"""

from __future__ import annotations

import os

from fastk_tpu_torch.formats.paths import hidden_files_of


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
