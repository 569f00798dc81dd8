"""Counterpart of ``benchmarks/_pallas_feas2.py``: the histogram in shared
memory at 4096 and 32768 bins (P5, P6), the carry across blocks (P7), the
scalar loop's throughput (P8), packing a mask (P9, by ballot where the TPU
took a matrix product) and the store at dynamic indices (P10), on the
port's kernels."""

from __future__ import annotations

import functools

import numpy as np
import torch

from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.probes import (
    probe_bits,
    probe_carry,
    probe_hist,
    probe_loop,
)
from fastk_tpu_torch.probes import Probe, loop_ms


def smem_hist(x, nbins):
    """(8,128) values in [0, nbins) -> (nbins,) bincount."""
    return probe_hist(x.reshape(-1), nbins)


def carry_total(x):
    """(32,128), 4 blocks of (8,128) -> (1,) total, carried block to block."""
    return probe_carry(x.reshape(4, -1))[-1:]


def loop_1m(x):
    """(8,128) -> (1,) sum of x[i % 8, i % 128] over 1M steps."""
    return probe_loop(x, torch.tensor([1_000_000], dtype=torch.int32,
                                      device=x.device), "global")


def pack16(m, w=None):
    """(8,128) 0/1 mask -> (8,8) int32 words of 16 bits (bit b of word j
    of row r = m[r, 16j + b]). The TPU probe multiplied by w, (128,8)
    powers of two; the ballot needs no w."""
    return probe_bits(m != 0, "pack", 16).reshape(m.shape[0], -1)


def dynstore(x):
    """(1,16) distinct values in [0,128) -> (1,128): out[x[i]] = i."""
    return probe_hist(x.reshape(-1), 128, store=True).reshape(1, 128)


LAUNCHES = [functools.partial(smem_hist, nbins=4096),
            functools.partial(smem_hist, nbins=32768), carry_total, loop_1m,
            pack16, dynstore]


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

    probe("SMEM hist 4096 bins", hist_probe(4096))
    probe("SMEM hist 32768 bins", hist_probe(32768))

    def run_carry():
        x = torch.arange(4 * 8 * 128, dtype=torch.int32,
                         device=dev).reshape(4 * 8, 128)
        assert int(carry_total(x)[0]) == int(np.arange(4 * 8 * 128).sum())
        return "carry ok"

    probe("SMEM scratch across grid steps", run_carry)

    def run_loop():
        x = torch.ones((8, 128), dtype=torch.int32, device=dev)
        assert int(loop_1m(x)[0]) == 1_000_000
        return f"1M iters: {loop_ms(lambda: loop_1m(x)):.1f} ms"

    probe("scalar loop 1M iters (incl ~28ms sync)", run_loop)

    def run_pack():
        rng = np.random.default_rng(1)
        m = rng.integers(0, 2, (8, 128)).astype(np.float32)
        got = pack16(torch.from_numpy(m).to(dev)).cpu().numpy()
        want = (m.reshape(8, 8, 16).astype(np.int64)
                * (1 << np.arange(16))).sum(-1)
        assert np.array_equal(got.astype(np.int64), want)
        return "pack exact"

    probe("f32 matmul bit-pack", run_pack)

    def run_dynstore():
        xs = np.random.default_rng(2).permutation(128)[:16].astype(np.int32)
        got = dynstore(torch.from_numpy(xs[None, :]).to(dev)).cpu().numpy()
        assert all(got[0, xs[i]] == i for i in range(16))
        return "dyn store ok"

    probe("dynamic (1,)-store to VMEM", run_dynstore)
    return probe.results


if __name__ == "__main__":
    main()
