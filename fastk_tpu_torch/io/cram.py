"""CRAM ingestion.

The reference vendors all of htslib (~61k LoC of C) solely to decode CRAM
containers (io.c:1821-1990). Here the primary path is the SELF-CONTAINED
decoder in io.cram_native (CRAM 2.0/2.1/3.0 containers — everything the
reference's vendored htslib 1.10.2 reads — rANS-4x8, reference-based
sequence reconstruction; no system dependencies). Files using features
outside its gate (CRAM 3.1 codecs, exotic encodings) fall back to a system
htslib (LIBHTS=...) or pysam when configured, else fail with guidance.
"""

from __future__ import annotations

import os
from typing import Iterator


def iter_cram_reads(path: str) -> Iterator[bytes]:
    from fastk_tpu_torch.io.cram_native import CramUnsupported, \
        iter_cram_reads_native

    # the native decoder can hit an unsupported feature MID-STREAM (a later
    # container using a gated codec); the fallback re-reads from the start,
    # so records already yielded must be skipped — both decoders walk the
    # same primary records in file order, making the count a valid cursor
    nyielded = 0
    try:
        for seq in iter_cram_reads_native(path):
            yield seq
            nyielded += 1
        return
    except CramUnsupported as e:
        reason = str(e)

    yielded_skip = nyielded

    def resume(it: Iterator[bytes]) -> Iterator[bytes]:
        for i, seq in enumerate(it):
            if i >= yielded_skip:
                yield seq

    from fastk_tpu_torch.io import htslib

    if htslib.load() is not None:
        ref = os.environ.get("FASTK_TPU_CRAM_REF")
        yield from resume(htslib.iter_hts_reads(path, ref))
        return
    try:
        import pysam  # optional, not in the base image
    except ImportError:
        raise NotImplementedError(
            f"{path}: CRAM feature outside the native decoder's gate "
            f"({reason}); set LIBHTS=/path/to/libhts.so or install pysam, "
            "or convert to BAM with `samtools view -b`.")

    def pysam_reads() -> Iterator[bytes]:
        with pysam.AlignmentFile(path, "rc", check_sq=False) as f:
            for rec in f.fetch(until_eof=True):
                if rec.flag & 0x900:
                    continue
                seq = rec.query_sequence
                if seq:
                    yield seq.encode()

    yield from resume(pysam_reads())
