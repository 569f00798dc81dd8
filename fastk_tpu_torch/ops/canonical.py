"""Host-side (numpy) canonical k-mer operations on 2-bit packed byte arrays.

The canonical form of a k-mer is the lexicographic minimum of the k-mer and
its reverse complement (reference semantics: count.c:439-510 compares forward
vs RC bytes on the fly; here we materialize both and take the row-wise min).
The device-side equivalent lives in fastk_tpu_torch.ops.kmers.
"""

from __future__ import annotations

import numpy as np

# byte -> byte with its four 2-bit codes reversed
_REV = np.zeros(256, dtype=np.uint8)
for _b in range(256):
    _c = [(_b >> 6) & 3, (_b >> 4) & 3, (_b >> 2) & 3, _b & 3]
    _REV[_b] = (_c[3] << 6) | (_c[2] << 4) | (_c[1] << 2) | _c[0]


def revcomp_packed(packed: np.ndarray, kmer: int) -> np.ndarray:
    """Reverse complement of (n, kb) packed k-mers, keeping the left-aligned,
    zero-padded layout."""
    packed = np.asarray(packed, dtype=np.uint8)
    n, kb = packed.shape
    # complement (3-x == ~x for 2-bit codes) then reverse base order
    r = _REV[packed ^ 0xFF][:, ::-1]
    pad = 4 * kb - kmer  # leading junk codes after reversal
    if pad:
        s = 2 * pad
        hi = (r << s).astype(np.uint8)
        lo = np.zeros_like(r)
        lo[:, :-1] = r[:, 1:] >> (8 - s)
        r = hi | lo
    # zero the unused low bits of the final byte
    rem = kmer % 4
    if rem:
        r[:, -1] &= 0xFF << (2 * (4 - rem)) & 0xFF
    return r


def canonical_packed(packed: np.ndarray, kmer: int) -> np.ndarray:
    """Row-wise min(kmer, revcomp(kmer)) in lexicographic byte order."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    rc = np.ascontiguousarray(revcomp_packed(packed, kmer))
    kb = packed.shape[1]
    fv = packed.view(f"S{kb}").ravel()
    rv = rc.view(f"S{kb}").ravel()
    take_rc = rv < fv
    out = packed.copy()
    out[take_rc] = rc[take_rc]
    return out
