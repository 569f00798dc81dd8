"""Canonical k-mer counting in plain PyTorch: what the ``.hist``, ``.ktab``
and ``.prof`` outputs of a ``fastk`` job must hold.

A k-mer is held as W = ceil(k/31) int64 words of at most 31 bases, two bits a
base (A, C, G, T = 0..3), the last word holding the last 31 bases and the
first the rest, so that the order of word tuples is the order of the k-mers'
strings. The canonical k-mer is the smaller of the k-mer and its reverse
complement. A window counts when it lies inside one read. Counts go into the
outputs clipped at 32767, as FastK's formats hold them.
"""

from __future__ import annotations

import numpy as np
import torch

CLIP = 32767
BASES_A_WORD = 31


def word_spans(k: int):
    """(first base, end base) of each word of a k-mer, first word first."""
    W = -(-k // BASES_A_WORD)
    first = k - BASES_A_WORD * (W - 1)
    return [(0, first)] + [(first + BASES_A_WORD * i,
                            first + BASES_A_WORD * (i + 1))
                           for i in range(W - 1)]


def valid_starts(rlen: torch.Tensor, k: int) -> torch.Tensor:
    """int64 offsets, in read order, of every window of k bases that lies
    inside one read of the concatenated reads."""
    dev = rlen.device
    starts = torch.cumsum(rlen, 0) - rlen
    nwin = torch.clamp(rlen - k + 1, min=0)
    total = int(nwin.sum())
    read = torch.repeat_interleave(torch.arange(len(rlen), device=dev), nwin,
                                   output_size=total)
    first = torch.cumsum(nwin, 0) - nwin
    return starts[read] + (torch.arange(total, device=dev) - first[read])


def canonical_words(codes: torch.Tensor, rlen: torch.Tensor, k: int):
    """Canonical k-mer words of every window inside a read, in read order:
    a tuple of W int64 tensors."""
    pos = valid_starts(rlen, k)
    c = codes.to(torch.int64)
    fwd, rc = [], []
    for a, b in word_spans(k):
        f = torch.zeros_like(pos)
        r = torch.zeros_like(pos)
        for j in range(a, b):
            f.mul_(4).add_(c[pos + j])
            r.mul_(4).add_(3 - c[pos + (k - 1 - j)])
        fwd.append(f)
        rc.append(r)
    del c, pos
    # take the reverse complement where it is the smaller word tuple
    take_rc = torch.zeros_like(fwd[0], dtype=torch.bool)
    undecided = torch.ones_like(take_rc)
    for f, r in zip(fwd, rc):
        take_rc |= undecided & (r < f)
        undecided &= r == f
    return tuple(torch.where(take_rc, r, f) for f, r in zip(fwd, rc))


def lex_order(words, last=None) -> torch.Tensor:
    """The permutation that sorts records by their word tuple, ties kept in
    input order (and by `last`, an int64 tensor, before input order)."""
    keys = list(words) + ([last] if last is not None else [])
    perm = torch.argsort(keys[-1], stable=True)
    for key in reversed(keys[:-1]):
        perm = perm[torch.argsort(key[perm], stable=True)]
    return perm


def _run_starts(s_words) -> torch.Tensor:
    starts = torch.zeros_like(s_words[0], dtype=torch.bool)
    starts[:1] = True
    for w in s_words:
        starts[1:] |= w[1:] != w[:-1]
    return starts


def count(words):
    """Distinct k-mers and their counts.

    Returns (uniq: tuple of W int64 [n] in k-mer order, counts int64 [n],
    inverse int64 [positions]: the distinct k-mer of each window)."""
    perm = lex_order(words)
    s_words = tuple(w[perm] for w in words)
    starts = _run_starts(s_words)
    run = torch.cumsum(starts.to(torch.int64), 0) - 1
    counts = torch.bincount(run)
    inverse = torch.empty_like(run)
    inverse[perm] = run
    return tuple(w[starts] for w in s_words), counts, inverse


def histogram(counts: torch.Tensor):
    """The .hist content of distinct k-mers with these counts: (header
    (low, high, I(low), I(high)), U(1..32767) int64 numpy)."""
    clipped = torch.clamp(counts, max=CLIP)
    bins = torch.bincount(clipped, minlength=CLIP + 1)[1:].cpu().numpy()
    overflow = int(torch.clamp(counts - CLIP, min=0).sum())
    bins = bins.astype(np.int64)
    return (1, CLIP, int(bins[0]), int(bins[-1]) * CLIP + overflow), bins


def table(uniq, counts: torch.Tensor, tmin: int):
    """The -t<tmin> table: k-mers seen at least tmin times, in k-mer order,
    with their clipped counts."""
    keep = counts >= tmin
    return tuple(w[keep] for w in uniq), torch.clamp(counts[keep], max=CLIP)


def own_profiles(counts: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """Each window's clipped count, in read order (-p)."""
    return torch.clamp(counts, max=CLIP)[inverse]


def relative_profiles(t_words, t_counts: torch.Tensor, q_words
                      ) -> torch.Tensor:
    """Each query window's count in the table, 0 where the table lacks its
    k-mer, in read order (-p:<table>)."""
    nt, nq = len(t_counts), len(q_words[0])
    dev = t_counts.device
    words = tuple(torch.cat([t, q]) for t, q in zip(t_words, q_words))
    side = torch.cat([torch.zeros(nt, dtype=torch.int64, device=dev),
                      torch.ones(nq, dtype=torch.int64, device=dev)])
    value = torch.cat([t_counts.to(torch.int64),
                       torch.zeros(nq, dtype=torch.int64, device=dev)])
    perm = lex_order(words, side)  # a table entry before its queries
    s_words = tuple(w[perm] for w in words)
    starts = _run_starts(s_words)
    run = torch.cumsum(starts.to(torch.int64), 0) - 1
    s_side, s_value = side[perm], value[perm]
    # each run's table count, or 0 where the run holds only queries
    head = torch.where(s_side[starts] == 0, s_value[starts], 0)
    is_q = s_side == 1
    out = torch.empty(nq, dtype=torch.int64, device=dev)
    out[perm[is_q] - nt] = head[run[is_q]]
    return out
