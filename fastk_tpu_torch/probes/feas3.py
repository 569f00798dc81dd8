"""Counterpart of ``benchmarks/_pallas_feas3.py``: the shared-memory
histogram (P11), the scalar while loop's throughput (P12) and the ctz walk
over packed words (P13), on the port's kernels. (The TPU script built each
from while loops because its compiler unrolled static loops; a CUDA loop
needs no such care.)"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.probes import probe_bits
from fastk_tpu_torch.probes import Probe, loop_ms
from fastk_tpu_torch.probes.feas2 import loop_1m, smem_hist


def ctz_walk(w):
    """(8,128) words -> (1,) sum of the indices of their set bits."""
    return probe_bits(w, "walk")


LAUNCHES = [functools.partial(smem_hist, nbins=4096),
            functools.partial(smem_hist, nbins=32768), loop_1m, ctz_walk]


def main(device="cuda") -> list:
    dev = resolve_device(device)
    probe = Probe(46, 110)

    def hist_probe(nbins):
        def run():
            x = np.random.default_rng(0).integers(0, nbins, (8, 128),
                                                  np.int32)
            got = smem_hist(torch.from_numpy(x).to(dev), nbins).cpu().numpy()
            want = np.bincount(x.reshape(-1), minlength=nbins)
            assert np.array_equal(got, want)
            return f"{nbins} bins ok"

        return run

    probe("SMEM hist 4096 bins (while)", hist_probe(4096))
    probe("SMEM hist 32768 bins (while)", hist_probe(32768))

    def run_loop():
        x = torch.ones((8, 128), dtype=torch.int32, device=dev)
        assert int(loop_1m(x)[0]) == 1_000_000
        return f"1M iters: {loop_ms(lambda: loop_1m(x)):.1f} ms"

    probe("scalar while 1M iters (incl ~28ms sync)", run_loop)

    def run_ctz():
        rng = np.random.default_rng(3)
        w = rng.integers(0, 1 << 16, (8, 128), dtype=np.int32)
        out = int(ctz_walk(torch.from_numpy(w).to(dev))[0])
        want = sum(int(b) for x in w.reshape(-1)
                   for b in np.nonzero(np.unpackbits(
                       np.array([x], dtype=">i4").view(np.uint8))[::-1])[0])
        assert out == want, (out, want)
        return "ctz walk ok"

    probe("ctz bit-iteration", run_ctz)
    return probe.results


if __name__ == "__main__":
    main()
