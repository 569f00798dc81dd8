"""Times of the count_batch stages on the card at 2^26 positions; the port's
counterpart of ``benchmarks/prof_stages.py``.

    python -m fastk_tpu_torch.probes.stages

The input is the JAX script's: random codes from numpy seed 0, a sentinel
every 20001 positions and after SIZE, packed by pack_stream. Each stage is
the port's counterpart of the script's stage of the same name:

  null (sync latency)               a one-element read to the host
  unpack_stream                     ops/pack.py unpack_stream
  canonical_kmers                   ops/kmers.py canonical_kmers
  sort_records (1+3 keys)           sort_keys(fold_invalid(...), (positions,))
  lax.sort 1 key (ref point)        one torch.sort of an int64 word column
  lax.sort 3 keys no values         sort_keys of the three words
  segmented_count(hist+compaction)  segmented_count(s_words, want_hist=True)
  seg hist only (no compaction)     start_words + run_hist (the kernel)
  count_batch full (hist)           count_batch(codes, K, SIZE, False, True)

A stage's time is the mean of 5 runs after a warm-up run, each run timed
by probes/common.py run_ms: CUDA events around it on the card, the host
clock on the CPU (the tests).
Prints one line a stage in the JAX script's format, the device's name
after it. Runs on the card and raises without one.
"""

from __future__ import annotations

import numpy as np
import torch

from fastk_tpu_torch.bench import device_info
from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.count import (
    count_batch,
    fold_invalid,
    segmented_count,
    sort_keys,
)
from fastk_tpu_torch.ops.histker import run_hist, start_words
from fastk_tpu_torch.ops.kmers import canonical_kmers, pad_needed
from fastk_tpu_torch.ops.pack import pack_stream, unpack_stream
from fastk_tpu_torch.probes.common import run_ms

K = 40
SIZE = 1 << 26
RUNS = 5


def stage_input(size: int):
    """prof_stages.py's input: (codes uint8 [size + pad_needed(K)], packed
    uint8, exceptions uint32)."""
    rng = np.random.default_rng(0)
    total = size + pad_needed(K)
    codes = rng.integers(0, 4, size=total, dtype=np.uint8)
    codes[::20001] = 4
    codes[size:] = 4
    packed, exc = pack_stream(codes)
    return codes, packed, exc


def stages(dev, size: int) -> list:
    """[(name, fn)]: fn() runs the stage on `dev` and returns its output.
    The inputs of each stage are made once, from the earlier stages."""
    codes_host, packed_host, exc_host = stage_input(size)
    total = len(codes_host)
    packed = torch.from_numpy(packed_host).to(dev)
    exc = torch.from_numpy(exc_host.view(np.int32)).to(dev)
    codes = unpack_stream(packed, exc, total)
    words, invalid = canonical_kmers(codes, K, size)
    pos = torch.arange(size, dtype=torch.int32, device=dev)
    s_words, _ = sort_keys(fold_invalid(words, invalid))
    valid_end = size - int(invalid.sum())
    return [
        ("null (sync latency)", lambda: packed[:1].cpu()),
        ("unpack_stream", lambda: unpack_stream(packed, exc, total)),
        ("canonical_kmers", lambda: canonical_kmers(codes, K, size)),
        ("sort_records (1+3 keys)",
         lambda: sort_keys(fold_invalid(words, invalid), (pos,))),
        ("lax.sort 1 key (ref point)", lambda: torch.sort(words[0])),
        ("lax.sort 3 keys no values", lambda: sort_keys(words)),
        ("segmented_count(hist+compaction)",
         lambda: segmented_count(s_words, want_hist=True)),
        ("seg hist only (no compaction)",
         lambda: run_hist(start_words(s_words, valid_end), valid_end)),
        ("count_batch full (hist)",
         lambda: count_batch(codes, K, size, False, True)),
    ]


def stage_ms(fn, dev) -> float:
    """ms of one fn(): the mean of RUNS timed runs after a warm-up run."""
    return sum(run_ms(fn, dev, RUNS)) / RUNS


def main(device="cuda") -> list:
    """Time every stage; returns [(name, ms)]."""
    dev = resolve_device(device)
    name = device_info(dev)["name"]
    out = []
    for stage, fn in stages(dev, SIZE):
        ms = stage_ms(fn, dev)
        print(f"{stage:38s} {ms:9.3f} ms   {SIZE / ms / 1e3:8.1f} Mpos/s"
              f"   [{name}]", flush=True)
        out.append((stage, ms))
    return out


if __name__ == "__main__":
    main()
