"""Counterpart of ``benchmarks/_pallas_feas.py``: the scalar-loop histogram
(P1), the data-dependent while loop (P2), clz (P3) and the carry across a
sequential grid (P4), on the port's kernels."""

from __future__ import annotations

import numpy as np
import torch

from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.probes import (
    probe_bits,
    probe_carry,
    probe_hist,
    probe_loop,
)
from fastk_tpu_torch.probes import Probe


def hist16(x):
    """(8,128) values in [0, 16) -> (1, 16) bincount."""
    return probe_hist(x.reshape(-1), 16).reshape(1, 16)


def while_sum(x):
    """(1,1) trip count n -> (1,1) sum of 0..n-1."""
    return probe_loop(x, x.reshape(-1), "index").reshape(1, 1)


def clz(x):
    return probe_bits(x, "clz")


def carry(x):
    """(4,8,128) -> (4,1) running sums of the block sums."""
    return probe_carry(x).reshape(-1, 1)


LAUNCHES = [hist16, while_sum, clz, carry]


def main(device="cuda") -> list:
    dev = resolve_device(device)
    probe = Probe(44, 120)

    def run_hist():
        x = np.random.default_rng(0).integers(0, 16, (8, 128), np.int32)
        got = hist16(torch.from_numpy(x).to(dev)).cpu().numpy()[0]
        want = np.bincount(x.reshape(-1), minlength=16)
        assert np.array_equal(got, want), (got, want)
        return "hist matches"

    probe("scalar fori + dyn load + dyn accumulate", run_hist)

    def run_while():
        x = torch.full((1, 1), 37, dtype=torch.int32, device=dev)
        assert int(while_sum(x)[0, 0]) == 37 * 36 // 2
        return "while ok"

    probe("data-dependent while_loop", run_while)

    def run_clz():
        x = torch.full((1, 1), 1 << 20, dtype=torch.int32, device=dev)
        out = int(clz(x)[0, 0])
        assert out == 11, out
        return "clz ok"

    probe("scalar clz", run_clz)

    def run_carry():
        x = torch.arange(4 * 8 * 128, dtype=torch.int32,
                         device=dev).reshape(4, 8, 128)
        want = np.cumsum(np.arange(4 * 8 * 128).reshape(4, -1).sum(1))
        assert np.array_equal(carry(x).cpu().numpy().reshape(-1), want)
        return "carry ok"

    probe("sequential grid + SMEM carry", run_carry)
    return probe.results


if __name__ == "__main__":
    main()
