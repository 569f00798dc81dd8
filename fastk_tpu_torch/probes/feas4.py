"""Counterpart of ``benchmarks/_pallas_feas4.py``: five minimal scalar-loop
kernels (P14-A to E), on the port's kernels. The TPU script printed each
value unchecked; here each is checked against numpy.

P14-D differs on purpose. The TPU kernel added 1 at hist[i & 1023] for i <
1000 to a scratch it never zeroed and returned hist[0]: whatever the memory
held, plus 1 (interpret mode fills scratch with the int32 minimum and gives
-2147483647). The port's histogram starts from zero, so it returns 1: the
same single increment."""

from __future__ import annotations

import numpy as np
import torch

from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.probes import probe_bits, probe_hist, probe_loop
from fastk_tpu_torch.probes import Probe


def _trips(x, n):
    return torch.tensor([n], dtype=torch.int32, device=x.device)


def loop_static(x):
    """1000 steps of acc += x[0, 0]."""
    return probe_loop(x, _trips(x, 1000), "static")


def loop_global(x):
    """1000 steps of acc += x[i & 7, i & 127] from device memory."""
    return probe_loop(x, _trips(x, 1000), "global")


def loop_shared(x):
    """The same from a copy of x in shared memory."""
    return probe_loop(x, _trips(x, 1000), "shared")


def scratch_hist(x):
    """hist[i & 1023] += 1 for i < 1000 in a zeroed 1024-bin histogram ->
    (1,) hist[0]. (x, the script's input, is not read.)"""
    i = torch.arange(1000, dtype=torch.int32, device=x.device)
    return probe_hist(i & 1023, 1024)[:1]


def nested_walk(x):
    """The ctz walk over i | 1 for i < 100 -> (1,) sum of the set-bit
    indices. (x is not read.)"""
    i = torch.arange(100, dtype=torch.int32, device=x.device)
    return probe_bits(i | 1, "walk")


LAUNCHES = [loop_static, loop_global, loop_shared, scratch_hist, nested_walk]


def main(device="cuda") -> list:
    dev = resolve_device(device)
    probe = Probe(52, 100)
    x_np = np.ones((8, 128), np.int32)
    x = torch.from_numpy(x_np).to(dev)
    idx = np.arange(1000)
    dyn = int(x_np[idx & 7, idx & 127].sum())
    bits = np.unpackbits((np.arange(100) | 1).astype("<u4").view(np.uint8),
                         bitorder="little").reshape(100, 32)
    walk = int((bits * np.arange(32)).sum())

    def check(f, want):
        def run():
            got = int(f(x)[0])
            assert got == want, (got, want)
            return got

        return run

    probe("A while + static VMEM scalar read",
          check(loop_static, 1000 * int(x_np[0, 0])))
    probe("B while + dynamic VMEM scalar read", check(loop_global, dyn))
    probe("C while + dynamic SMEM scalar read", check(loop_shared, dyn))
    probe("D while + SMEM scratch accumulate", check(scratch_hist, 1))
    probe("E nested while + clz, pure scalar", check(nested_walk, walk))
    return probe.results


if __name__ == "__main__":
    main()
