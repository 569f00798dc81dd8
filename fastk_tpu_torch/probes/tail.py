"""Each primitive of the histogram job after the key sort, flat and split
into rows; the port's counterpart of ``benchmarks/_r3tail.py``,
``benchmarks/_r3tail2.py`` and ``benchmarks/_prim.py``.

    python -m fastk_tpu_torch.probes.tail [prim ...]

``_r3tail.py``'s stages run on the bench's batch at the probe's size (2^26
positions unless main is given another; ``_r3tail*.py`` ran at bench.SIZE),
its keys sorted once and kept on the device, each stage on the resident
output of the one before, under the script's names:

  starts          run starts: words that differ from the word before
                  (torch.roll), position 0 always
  seglen cummin   the next start after each position, minus the position:
  seglen revarg   a reverse cummin. The script writes it twice, as
                  cummin(x[::-1])[::-1] and as cummin(x, reverse=True);
                  torch.cummin has no reverse, so both are torch.cummin over
                  a flipped copy, flipped back: one torch form, timed twice
  vals            the clipped run length at each valid start, 32768
                  elsewhere (the script's uint16, held as int32)
  sort u16        one torch.sort of vals
  searchsorted    the 32769 bin edges in the sorted vals, differenced

and beside them what the port runs in their place (ops/count.py):
``next_start_after`` (a cumsum, a scatter and a gather) minus the
position, and ``torch.bincount`` of vals.

``_r3tail2.py``'s row forms, each against its flat form (OK or MISMATCH):
``seglen rows R`` (R = 64, 256, 1024, 4096: a reverse cummin along each of
R rows, then across the rows' minima) and ``bincount rows R`` (R = 16, 64,
256, 1024: a row sort and a searchsorted a row, summed).

``_prim.py``'s nine primitives at the same size (the script's 2^26) on
numpy data (seed 0: lengths in
[0, 60), starts at a tenth of the positions, random keys for a permutation),
by its argv names (all nine unless named on the command line): roll,
cumsum, cummax, scatter32k, scatterperm, gatherperm, compact, sort1,
searchsorted. Each returns the whole array that the script reduced to one
value for its fetch; cumsum stays in int32, as the script's does.

Times: min of 4 runs (``_r3tail*.py``) and median of 3 (``_prim.py``,
without the script's 52 ms fetch subtraction), each run after a warm-up;
see probes/common.py. Runs on the card and raises without one;
``main(device="cpu")`` runs the same code on the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.formats.hist import HIST_HIGH
from fastk_tpu_torch.ops.count import next_start_after, sort_keys
from fastk_tpu_torch.probes.common import (
    bench_batch,
    bin_edges,
    bincount_by_sort,
    bincount_rows,
    card_name,
    folded_keys,
    median,
    run_ms,
    to_device,
)

TAIL_SIZE = 1 << 26  # _prim.py's size
SEG_ROWS = (64, 256, 1024, 4096)
BIN_ROWS = (16, 64, 256, 1024)
TAIL_REPS = 4
PRIM_REPS = 3
PRIMS = {  # argv name -> the script's line
    "roll": "roll-compare",
    "cumsum": "cumsum 64M",
    "cummax": "cummax 64M",
    "scatter32k": "scatter-add 64M->32k",
    "scatterperm": "scatter-set 64M perm",
    "gatherperm": "gather 64M perm",
    "compact": "compaction sort 1bit+idx",
    "sort1": "sort int32 1key",
    "searchsorted": "searchsorted 32k in 64M",
}


def sorted_batch(dev, size: int):
    """The bench's batch at `size`, its folded keys sorted on `dev`:
    (sorted words, ninv tensor)."""
    pw, exc, total = bench_batch(size)
    f, ninv = folded_keys(to_device(pw, dev), to_device(exc, dev), total,
                          size)
    return sort_keys(f)[0], ninv


def stage_starts(s_words) -> torch.Tensor:
    starts = torch.zeros(s_words[0].numel(), dtype=torch.bool,
                         device=s_words[0].device)
    for w in s_words:
        starts |= w != torch.roll(w, 1)
    starts[0] = True
    return starts


def _rev_cummin(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cummin(x.flip(dim), dim).values.flip(dim)


def _nxt(starts: torch.Tensor):
    n = starts.numel()
    idx = torch.arange(n, dtype=torch.int32, device=starts.device)
    return idx, torch.where(starts, idx, n)


def seglen_flat(starts: torch.Tensor) -> torch.Tensor:
    """Run length at each start: the next start after i, minus i."""
    idx, nxt = _nxt(starts)
    end = nxt.new_full((1,), starts.numel())
    return torch.cat([_rev_cummin(nxt)[1:], end]) - idx


def seglen_rows(starts: torch.Tensor, R: int) -> torch.Tensor:
    """seglen_flat as R rows' reverse cummins and a suffix min across the
    rows' minima."""
    n = starts.numel()
    idx, nxt = _nxt(starts)
    rm = _rev_cummin(nxt.view(R, n // R), 1)
    end = nxt.new_full((1,), n)
    suf = _rev_cummin(torch.cat([rm[1:, 0], end]))
    out = torch.minimum(rm, suf[:, None]).reshape(-1)
    return torch.cat([out[1:], end]) - idx


def stage_vals(starts, seg_len, ninv) -> torch.Tensor:
    n = starts.numel()
    idx = torch.arange(n, device=starts.device)
    use = starts & (idx < n - ninv)
    return torch.where(use, torch.clamp(seg_len, max=HIST_HIGH),
                       HIST_HIGH + 1).to(torch.int32)


def tail_cases(dev, size: int) -> list:
    """[(name, fn)]: ``_r3tail.py``'s stages, the port's two lines, and
    ``_r3tail2.py``'s flat and row forms on the bench's batch; each stage's
    input is the earlier stages' output, made once."""
    s_words, ninv = sorted_batch(dev, size)
    starts = stage_starts(s_words)
    seg_len = seglen_flat(starts)
    vals = stage_vals(starts, seg_len, ninv)
    sv = torch.sort(vals).values
    idx = torch.arange(size, device=dev)
    out = [
        ("starts", lambda: stage_starts(s_words)),
        ("seglen cummin", lambda: seglen_flat(starts)),
        ("seglen revarg", lambda: seglen_flat(starts)),
        ("vals", lambda: stage_vals(starts, seg_len, ninv)),
        ("sort u16", lambda: torch.sort(vals).values),
        ("searchsorted", lambda: bin_edges(sv, HIST_HIGH + 1)),
        ("next_start_after", lambda: next_start_after(starts) - idx),
        ("torch.bincount", lambda: torch.bincount(
            vals, minlength=HIST_HIGH + 2)[: HIST_HIGH + 1]),
        ("seglen flat", lambda: seglen_flat(starts)),
    ]
    out += [(f"seglen rows {R}", lambda R=R: seglen_rows(starts, R))
            for R in SEG_ROWS if size % R == 0]
    out.append(("bincount flat",
                lambda: bincount_by_sort(vals, HIST_HIGH + 1)))
    out += [(f"bincount rows {R}",
             lambda R=R: bincount_rows(vals, R, HIST_HIGH + 1))
            for R in BIN_ROWS if size % R == 0]
    return out


def prim_inputs(size: int) -> dict:
    rng = np.random.default_rng(0)
    return dict(lens=rng.integers(0, 60, size, dtype=np.int32),
                starts=rng.random(size) < 0.1,
                keys=rng.integers(0, 1 << 30, size, dtype=np.int32))


def prim_cases(dev, size: int, names=tuple(PRIMS)) -> list:
    """[(argv name, fn)] of ``_prim.py``'s primitives at `size`."""
    x = {k: torch.from_numpy(v).to(dev) for k, v in prim_inputs(size).items()}
    lens, starts = x["lens"], x["starts"]
    perm = torch.sort(x["keys"], stable=True).indices  # lax.sort is stable
    sl = torch.sort(lens).values
    ones = torch.ones_like(lens)

    def scatter_set():
        out = torch.zeros_like(lens)
        out[perm] = lens
        return out

    fns = {
        "roll": lambda: (lens != torch.roll(lens, 1)).to(torch.int32).sum(),
        "cumsum": lambda: torch.cumsum(lens, 0, dtype=torch.int32),
        "cummax": lambda: torch.cummax(lens, 0).values,
        "scatter32k": lambda: torch.zeros(
            32768, dtype=torch.int32, device=dev).scatter_add_(
                0, (lens & 32767).long(), ones),
        "scatterperm": scatter_set,
        "gatherperm": lambda: lens[perm],
        "compact": lambda: torch.sort((~starts).to(torch.uint8),
                                      stable=True).indices,
        "sort1": lambda: torch.sort(lens).values,
        "searchsorted": lambda: torch.searchsorted(
            sl, torch.arange(32768, dtype=sl.dtype, device=dev)),
    }
    return [(n, fns[n]) for n in names]


def cases(dev, size: int) -> list:
    """Every case: tail_cases, then prim_cases (keyed by the script's
    lines), at `size`."""
    return tail_cases(dev, size) + [
        (PRIMS[n], fn) for n, fn in prim_cases(dev, size)]


def main(device="cuda", size=TAIL_SIZE, prims=tuple(PRIMS)) -> dict:
    """Print every line, the tail's and the primitives' at `size`; returns
    dict(times={name: ms}, mismatches=[row forms that differ from their flat
    forms])."""
    dev = resolve_device(device)
    name = card_name(dev)
    times, mismatches = {}, []
    tail = tail_cases(dev, size)
    flat = {}
    for case, fn in tail:
        ms = min(run_ms(fn, dev, TAIL_REPS))
        times[case] = ms
        ok = ""
        if case in ("seglen flat", "bincount flat"):
            flat[case.split()[0]] = fn()
        elif " rows " in case:
            good = torch.equal(fn(), flat[case.split()[0]])
            ok = " OK" if good else " MISMATCH"
            if not good:
                mismatches.append(case)
            kind, _, R = case.split()
            case = f"{kind} rows {int(R):5d}"
        print(f"{case:16s} {ms:9.3f} ms{ok}   [{name}]", flush=True)
    del tail, flat
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for argv, fn in prim_cases(dev, size, prims):
        ms = median(run_ms(fn, dev, PRIM_REPS))
        times[PRIMS[argv]] = ms
        print(f"{PRIMS[argv]:42s} {ms:9.3f} ms   [{name}]", flush=True)
    return dict(times=times, mismatches=mismatches)


if __name__ == "__main__":
    res = main(prims=tuple(sys.argv[1:]) or tuple(PRIMS))
    sys.exit(1 if res["mismatches"] else 0)
