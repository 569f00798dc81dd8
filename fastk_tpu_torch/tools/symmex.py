"""`symmex` — canonical table -> symmetric table (reference: Symmex.c:144-544;
README: every k-mer in both orientations, palindromes once, same count).

Streamed, bounded-memory, the reference's own shape vectorized: pass 1
streams the sorted table, reverse-complements each window and scatters the
RC records into 256 first-byte bucket spools (Symmex.c Double_Up writes
2-bit-prefix block files); pass 2 walks the buckets in key order, sorts
each bucket (Symmex.c LSD-sorts each block) and interleave-merges it with
the forward entries of the same first-byte range — which need no sort, the
input table is already sorted. Forward and RC streams are provably
disjoint (a canonical key equal to another entry's reverse complement
would force both to be palindromes, which are excluded), so the merge is a
pure interleave with no count combining.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import numpy as np

from fastk_tpu_torch.formats.ktab import KmerStream, KtabWriter
from fastk_tpu_torch.ops.canonical import revcomp_packed
from fastk_tpu_torch.tools._cli import die, print_number

USAGE = "Usage: symmex  [-v] [-T<int(4)>] [-P<dir(/tmp)] <source_root>[.ktab] <dest_root>[.ktab]"

_WINDOW = 1 << 20  # entries per streaming window


def _interleave(va, ca, vb, cb):
    """Merge two sorted key-disjoint (keys, counts) streams. The opposing
    searchsorted sides keep positions disjoint even if a key appears in
    both streams (non-canonical input): the duplicate is emitted twice, in
    order, rather than colliding into one slot."""
    pa = np.arange(len(va)) + np.searchsorted(vb, va, side="left")
    pb = np.arange(len(vb)) + np.searchsorted(va, vb, side="right")
    n = len(va) + len(vb)
    mv = np.empty(n, dtype=va.dtype)
    mc = np.empty(n, dtype=ca.dtype)
    mv[pa] = va
    mv[pb] = vb
    mc[pa] = ca
    mc[pb] = cb
    return mv, mc


def symmetric_streamed(src: str, dst: str, nparts: int, tmpdir: str,
                       verbose: bool) -> None:
    from fastk_tpu_torch import native
    from fastk_tpu_torch.formats.ktab import (
        KtabDirectWriter,
        idx_bytes_for,
        part_splits_from_pindex,
    )

    s = KmerStream(src)
    kmer, kb = s.kmer, s.kbyte
    rb = kb + 2
    d = tempfile.mkdtemp(prefix="symmex.", dir=tmpdir)
    spools = [None] * 256  # opened on first record
    npal = 0
    # exact output prefix histogram, accumulated during pass 1 (both the
    # forward and RC streams pass through it) — it fixes ibyte, the part
    # cut keys AND the stub index up front, so pass 2 streams the final
    # part files directly with every output byte written exactly once
    # (the reference writes once too; KtabWriter's spool would re-touch)
    hw = 3 if (2 * s.nels > 0x4000000 and kmer >= 12) else 2
    hist = np.zeros(1 << (8 * hw), dtype=np.int64)

    def _pv(packed):
        # keys narrower than the histogram width (kb == 1 at k <= 4) are
        # logically zero-padded, exactly like the cut-key comparison
        v = packed[:, 0].astype(np.int64)
        for j in range(1, hw):
            v <<= 8
            if j < kb:
                v |= packed[:, j]
        return v

    try:
        # pass 1: RC records into first-byte bucket spools
        for lo in range(0, s.nels, _WINDOW):
            hi = min(s.nels, lo + _WINDOW)
            packed, counts = s.read_range(lo, hi)
            rc = revcomp_packed(packed, kmer)
            pal = (rc == packed).all(axis=1)
            npal += int(pal.sum())
            rc, rcc = rc[~pal], counts[~pal]
            hist += np.bincount(_pv(packed), minlength=len(hist))
            hist += np.bincount(_pv(rc), minlength=len(hist))
            rec = np.empty((len(rc), rb), dtype=np.uint8)
            rec[:, :kb] = rc
            rec[:, kb:] = np.ascontiguousarray(
                rcc, dtype="<u2").view(np.uint8).reshape(-1, 2)
            order = np.argsort(rc[:, 0], kind="stable")
            rec = rec[order]
            ends = np.cumsum(np.bincount(rc[:, 0], minlength=256))
            b0 = 0
            for b in range(256):
                b1 = int(ends[b])
                if b1 > b0:
                    if spools[b] is None:
                        spools[b] = open(os.path.join(d, f"b{b:02x}"), "wb")
                    rec[b0:b1].tofile(spools[b])
                b0 = b1
        for f in spools:
            if f is not None:
                f.close()

        total = 2 * s.nels - npal
        ibyte = idx_bytes_for(total, kmer)
        # exact stub index at the output width + part cut keys at prefix
        # boundaries (all from the pass-1 histogram)
        if ibyte < hw:
            pind = hist.reshape(1 << (8 * ibyte), -1).sum(axis=1)
        else:
            pind = hist  # ibyte == hw by construction
        pcum = np.cumsum(pind)
        cut_keys = []
        for c in part_splits_from_pindex(pcum, nparts):
            if c >= total:
                cut_keys.append(b"\xff" * kb)
                continue
            p0 = int(np.searchsorted(pcum, c, side="left"))
            key = np.zeros(kb, np.uint8)
            for j in range(ibyte):
                key[j] = ((p0 + 1) >> (8 * (ibyte - 1 - j))) & 0xFF
            cut_keys.append(bytes(key))

        # per-first-byte forward ranges straight from the source stub
        # index (no on-disk binary search)
        step = 1 << (8 * (s.ibyte - 1))
        fwd_cuts = [0] + [int(s._pindex[(b + 1) * step - 1])
                          for b in range(256)]

        wr = KtabDirectWriter(dst, kmer, s.minval, ibyte, cut_keys)
        wr.skip_prefix = True
        try:
            use_native = native.load() is not None
            for b in range(256):
                fp, fc = s.read_range(fwd_cuts[b], fwd_cuts[b + 1])
                path = os.path.join(d, f"b{b:02x}")
                if os.path.exists(path):
                    rec = np.fromfile(path, dtype=np.uint8).reshape(-1, rb)
                    os.unlink(path)  # bound peak disk at ~one table
                    if use_native:
                        rows = native.symmex_bucket(fp, fc, rec, kb)
                        if len(rows):
                            wr.add_records(rows)
                        continue
                    rp = np.ascontiguousarray(rec[:, :kb])
                    rc2 = np.ascontiguousarray(
                        rec[:, kb:]).view("<u2").ravel()
                    rv = rp.view(f"S{kb}").ravel()
                    order = np.argsort(rv, kind="stable")
                    rv, rc2 = rv[order], rc2[order]
                    fv = np.ascontiguousarray(fp).view(f"S{kb}").ravel()
                    mv, mc = _interleave(fv, fc, rv, rc2)
                else:
                    mv, mc = (np.ascontiguousarray(fp).view(
                        f"S{kb}").ravel(), fc)
                if len(mv):
                    wr.add(mv.view(np.uint8).reshape(-1, kb), mc)
            wr.set_pindex(pind)
        except BaseException:
            wr.abort()
            raise
        wr.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)

    if verbose:
        print(f"  {print_number(s.nels)} canonical entries -> "
              f"{print_number(2 * s.nels - npal)} symmetric entries",
              file=sys.stderr)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    verbose = False
    nthreads = 4
    tmpdir = None
    pos = []
    for a in argv:
        if a == "-v":
            verbose = True
        elif a.startswith("-T"):
            nthreads = int(a[2:])
        elif a.startswith("-P"):
            tmpdir = a[2:] or None  # bucket-spool directory (Symmex block files)
        elif a.startswith("-"):
            die(f"symmex: {a} is an illegal option\n{USAGE}")
        else:
            pos.append(a)
    if len(pos) != 2:
        die(USAGE)

    try:
        symmetric_streamed(pos[0], pos[1], max(1, nthreads), tmpdir, verbose)
    except FileNotFoundError:
        die(f"symmex: Cannot open {pos[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
