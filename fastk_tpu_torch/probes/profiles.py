"""Secondary benchmark: the fused `-t -p` job (table + per-read profiles) on
the card; the port's counterpart of ``benchmarks/bench_profiles.py``.

    python -m fastk_tpu_torch.probes.profiles   # FASTK_BENCH_SIZE: the batch

Measures the device path of one batch already on the device:
count_batch(codes, K, SIZE, True, True), the count, its unique extraction,
the per-position counts through the inverse sort and the histogram (one
launch of the run-length kernel). The nvalid scalar and an 8-element
pos_counts probe come back to the host; the bulk pos_counts D2H is left
out, as in the JAX script. The median of 3 runs after a warm-up, each
timed on the host clock and ended by those reads.

Prints one JSON line like bench.py's, with "device". Runs on the card and
raises without one; ``main(device="cpu")`` is for the tests.
"""

from __future__ import annotations

import json
import statistics
import time

import numpy as np
import torch

from fastk_tpu_torch import bench as B
from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.count import count_batch
from fastk_tpu_torch.ops.kmers import pad_needed

BASELINE = B.BASELINE_FUSED  # FastK -t -p runs ~half its histogram speed
METRIC = "bases/sec/chip: fused 40-mer count+table+profile join"


def batch_codes(size: int, genome: int, read_len: int) -> tuple:
    """(uint8 codes [size + pad_needed(K)], nreads): bench.synth_hifi's
    stream padded with sentinels."""
    total = size + pad_needed(B.K)
    block, nreads, _ = B.synth_hifi(size, genome, read_len)
    return np.concatenate([block, np.full(total - len(block), 4, np.uint8)]
                          ), nreads


def step(codes: torch.Tensor, size: int):
    """The fused single-batch -t -p count (pipeline._count_single_fused's
    kernel). Returns (nvalid, pos_counts, hist) on the device."""
    res = count_batch(codes, B.K, size, True, True)
    return res["nvalid"], res["pos_counts"], res["hist"]


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    codes_host, nreads = batch_codes(B.SIZE, B.GENOME, B.READ_LEN)
    codes = torch.from_numpy(codes_host).to(dev)

    def run():
        nvalid, pc, _hist = step(codes, B.SIZE)
        return int(nvalid), pc[:8].cpu().numpy()

    run()  # warm-up
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    value = nreads * B.READ_LEN / statistics.median(ts)
    line = {
        "metric": METRIC,
        "value": round(value),
        "unit": "bases/sec",
        "vs_baseline": round(value / BASELINE, 3),
        "batch_size": B.SIZE,
        "device": B.device_info(dev),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
