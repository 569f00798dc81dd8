"""Resident costs of the histogram job's sort and binning at several batch
sizes, raw and scaled to 2^26 elements; the port's counterpart of
``benchmarks/_r3size.py``.

    python -m fastk_tpu_torch.probes.sizes [--sizes 23-27]

At each size 2^lg (the script's 2^24, 2^25 and 2^26 by default), its cases,
by the script's names:

  sort3       sort_keys of three words, w0 and w1 < 2^30 and w2 < 2^16 (the
              script's 3-key lax.sort of (u32, u32, u16)); two torch.sort
              passes, as the port's key sort makes them
  u16         one torch.sort of w2 % 32769, 16-bit values held as int32
  hist_batch  the port's hist_batch on random codes: keys, sort, start
              words and one launch of the run-length kernel (K1)

The inputs come from numpy seed lg (the script draws them with jax.random):
w0, w1, w2 and 2^lg random codes, padded with pad_needed(40) codes of 0
(the script pads 48; the port's canonical_kmers reads k + 16 past the last
window). Each case's time is the min of 5 runs after a warm-up; see
probes/common.py for the timer. The line is the script's, its times with
three decimals and the device's name after it. Runs on the card and raises
without one; ``main(device="cpu")`` runs the same code on the CPU (K1's
plain version).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.formats.hist import HIST_HIGH
from fastk_tpu_torch.ops.count import hist_batch, sort_keys
from fastk_tpu_torch.ops.kmers import pad_needed
from fastk_tpu_torch.probes.common import K, card_name, run_ms

SIZES = (24, 25, 26)
REPS = 5
CASES = ("sort3", "u16", "hist_batch")


def inputs(size: int) -> dict:
    """The numpy inputs at `size` positions, from seed log2(size)."""
    rng = np.random.default_rng(size.bit_length() - 1)
    w0 = rng.integers(0, 1 << 30, size, dtype=np.int64)
    w1 = rng.integers(0, 1 << 30, size, dtype=np.int64)
    w2 = rng.integers(0, 1 << 16, size, dtype=np.int64)
    codes = np.concatenate([rng.integers(0, 4, size, dtype=np.uint8),
                            np.zeros(pad_needed(K), np.uint8)])
    return dict(w0=w0, w1=w1, w2=w2, u16=w2 % (HIST_HIGH + 2), codes=codes)


def cases(dev, size: int) -> list:
    """[(name, fn)]: fn() runs the case on `dev` and returns its output."""
    x = {k: torch.from_numpy(v).to(dev) for k, v in inputs(size).items()}
    u16 = x["u16"].to(torch.int32)
    return [
        ("sort3", lambda: sort_keys((x["w0"], x["w1"], x["w2"]))[0]),
        ("u16", lambda: torch.sort(u16).values),
        ("hist_batch", lambda: hist_batch(x["codes"], K, size)),
    ]


def parse_sizes(text: str) -> tuple:
    """'23-27' -> (23, ..., 27); '24,26' -> (24, 26)."""
    if "-" in text:
        lo, hi = text.split("-")
        return tuple(range(int(lo), int(hi) + 1))
    return tuple(int(t) for t in text.split(","))


def main(device="cuda", sizes=SIZES) -> list:
    """Time each case at each size 2^lg; returns [(lg, {case: ms})]."""
    dev = resolve_device(device)
    name = card_name(dev)
    out = []
    for lg in sizes:
        n = 1 << lg
        scale = (1 << 26) / n
        ms = {c: min(run_ms(fn, dev, REPS)) for c, fn in cases(dev, n)}
        print(f"2^{lg}: sort3 {ms['sort3']:9.3f}ms (x{scale:g}="
              f"{ms['sort3'] * scale:9.3f})  u16 {ms['u16']:8.3f}ms "
              f"(={ms['u16'] * scale:8.3f})  hist_batch "
              f"{ms['hist_batch']:9.3f}ms (={ms['hist_batch'] * scale:9.3f})"
              f"   [{name}]", flush=True)
        out.append((lg, ms))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="24-26",
                    help="log2 batch sizes, a range lo-hi or a list a,b")
    main(sizes=parse_sizes(ap.parse_args().sizes))
