"""The headline step taken apart, and the A/B of its binning: the JAX
package's bincount path ("old") against the run-length kernel ("walk"),
resident and streamed; the port's counterpart of ``benchmarks/_r3decomp.py``,
``_r3walk_res.py`` and ``_walk_ab.py``.

    python -m fastk_tpu_torch.probes.decomp     # FASTK_BENCH_SIZE sets the batch

Both steps take the bench's batch (bench.SIZE positions, its packed words
and exceptions; the exceptions stay resident, as in the scripts):

  old   ``old_hist_batch``: JAX's XLA hist_batch (fastk_tpu/ops/count.py)
        in torch ops: keys, sort_keys, run starts, next_start_after, the
        clipped run length at each valid start (32768 elsewhere), binned as
        JAX bins them, by bincount_by_sort (a sort and the searchsorted bin
        edges, no scatter). ninv stays on the card, so the step does not
        wait for the host.
  walk  the port's hist_batch: start words and one launch of the
        run-length kernel (K1), which returns the histogram itself (the
        script's host ``_assemble`` has no counterpart). It waits once, for
        valid_end.

``_r3decomp.py``'s six lines, the min of 5 runs with every run listed: the
H2D of the packed words (upload_int32, upload_packed's pin by copy and copy;
the label keeps the script's 16.8MB, the bytes are bench.SIZE / 4), keys only
(H2D, unpack, canonical keys), the key sort alone on resident keys, the old
step with its H2D, the walk step with its H2D, the old step on resident
words. ``_r3walk_res.py``: 6 rounds, each the old then the walk step on
resident words. ``_walk_ab.py``: 6 rounds, each NB = 4 old steps then NB
walk steps, each step with its own H2D, the histograms of a block fetched
stacked; ms a batch. Every round holds the two steps' histograms equal and
raises if they differ. Times are CUDA events on the card (the scripts'
host clock with a one-element fetch is TPU-only), the host clock on the
CPU. Runs on the card and raises without one; ``main(device="cpu")`` runs
the same code on the CPU (K1's plain version).
"""

from __future__ import annotations

import numpy as np
import torch

from fastk_tpu_torch.bench import SIZE
from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.formats.hist import HIST_HIGH
from fastk_tpu_torch.ops.count import (
    fold_invalid,
    hist_batch,
    next_start_after,
    run_starts,
    sort_keys,
)
from fastk_tpu_torch.ops.kmers import canonical_kmers
from fastk_tpu_torch.convert import upload_int32
from fastk_tpu_torch.ops.pack import unpack_words
from fastk_tpu_torch.probes.common import (
    K,
    bench_batch,
    bincount_by_sort,
    card_name,
    folded_keys,
    run_ms,
    timed,
    to_device,
)

NB = 4
ROUNDS = 6
REPS = 5


def old_hist_batch(codes: torch.Tensor, k: int, size: int) -> dict:
    """JAX's hist_batch in torch ops: dict(hist int32 [32768], nvalid int64
    scalar tensor); no wait for the host."""
    words, invalid = canonical_kmers(codes, k, size)
    ninv = invalid.sum()
    s_words, _ = sort_keys(fold_invalid(words, invalid))
    del words, invalid
    starts = run_starts(s_words)
    idx = torch.arange(size, device=codes.device)
    seg_len = next_start_after(starts) - idx
    use = starts & (idx < size - ninv)
    vals = torch.where(use, torch.clamp(seg_len, max=HIST_HIGH),
                       HIST_HIGH + 1).to(torch.int32)
    return dict(hist=bincount_by_sort(vals, HIST_HIGH + 1),
                nvalid=size - ninv)


class Steps:
    """The two steps on the bench's batch at `size` on `dev`."""

    def __init__(self, dev, size: int):
        self.dev, self.size = dev, size
        self.pw, exc, self.total = bench_batch(size)
        self.pd, self.excd = to_device(self.pw, dev), to_device(exc, dev)

    def h2d(self) -> torch.Tensor:
        return upload_int32(self.pw, self.dev)

    def codes(self, words) -> torch.Tensor:
        return unpack_words(words, self.excd, self.total)

    def old(self, words) -> dict:
        return old_hist_batch(self.codes(words), K, self.size)

    def walk(self, words) -> dict:
        return hist_batch(self.codes(words), K, self.size)

    def streamed(self, step) -> torch.Tensor:
        """NB steps, each on its own H2D: the stacked histograms."""
        return torch.stack([step(self.h2d())["hist"] for _ in range(NB)])


def cases(dev, size: int) -> list:
    """[(name, fn)]: ``_r3decomp.py``'s six lines, then the old and walk
    steps resident and streamed; fn() returns the case's output."""
    st = Steps(dev, size)
    f, _ = folded_keys(st.pd, st.excd, st.total, size)
    return [
        ("h2d 16.8MB", st.h2d),
        ("keys only (h2d+unpack+canon)", lambda: folded_keys(
            st.h2d(), st.excd, st.total, size)),
        ("sort3 only (resident)", lambda: sort_keys(f)[0]),
        ("full step (h2d+all)", lambda: st.old(st.h2d())),
        ("walk step (h2d+all)", lambda: st.walk(st.h2d())),
        ("full step resident", lambda: st.old(st.pd)),
        ("old resident", lambda: st.old(st.pd)),
        ("walk resident", lambda: st.walk(st.pd)),
        ("old", lambda: st.streamed(st.old)),
        ("walk", lambda: st.streamed(st.walk)),
    ]


def _ms(ts) -> list:
    return [f"{t:.3f}" for t in ts]


def main(device="cuda", size=None) -> dict:
    """Print every line; returns dict of each line's runs in ms."""
    dev = resolve_device(device)
    name = card_name(dev)
    size = size or SIZE
    c = dict(cases(dev, size))
    out = {}
    for label in ("h2d 16.8MB", "keys only (h2d+unpack+canon)",
                  "sort3 only (resident)", "full step (h2d+all)",
                  "walk step (h2d+all)", "full step resident"):
        ts = run_ms(c[label], dev, REPS)
        out[label] = ts
        print(f"{label:34s} {min(ts):9.3f} ms  {_ms(ts)}   [{name}]",
              flush=True)

    def ab(old, walk, check):
        a, b = [], []
        old()
        walk()
        for r in range(ROUNDS):
            ta, x = timed(old, dev)
            tb, y = timed(walk, dev)
            a.append(ta)
            b.append(tb)
            if not check(x, y):
                raise AssertionError(f"round {r}: the old step's histogram "
                                     "differs from the walk step's")
        return a, b

    a, b = ab(c["old resident"], c["walk resident"],
              lambda x, y: torch.equal(x["hist"].long(), y["hist"].long())
              and int(x["nvalid"]) == y["nvalid"])
    out["old resident"], out["walk resident"] = a, b
    print(f"old  resident: {_ms(a)} min {min(a):.3f}   [{name}]", flush=True)
    print(f"walk resident: {_ms(b)} min {min(b):.3f}   [{name}]", flush=True)

    def fetched(key):
        def block():
            hists = c[key]().cpu().numpy()
            if not all(int(h[1:].sum()) > 0 for h in hists):
                raise AssertionError(f"{key}: an empty histogram")
            return hists
        return block

    a, b = ab(fetched("old"), fetched("walk"), np.array_equal)
    a, b = [t / NB for t in a], [t / NB for t in b]
    out["old"], out["walk"] = a, b
    print(f"old : {min(a):8.3f} ms/batch (all {_ms(a)})   [{name}]",
          flush=True)
    print(f"walk: {min(b):8.3f} ms/batch (all {_ms(b)})   [{name}]",
          flush=True)
    return out


if __name__ == "__main__":
    main()
