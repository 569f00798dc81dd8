"""Run-length histogram of a sorted key stream: the count histogram read
straight off the run starts.

Port of ``fastk_tpu/ops/histker.py``. ``hist_device_part`` turns a code
stream into the run starts of its sorted canonical keys, packed 32 to an
int32 word; ``run_hist`` bins the run lengths. On a CUDA tensor ``run_hist``
launches the kernel of ``csrc/run_hist.cu`` (or raises); on a CPU tensor it
runs ``run_hist_ref``, the plain torch version, which the tests and the chip
smoke run hold the kernel against.

The TPU kernel's workarounds for its SMEM limits (the 2047 cut, the side list,
the host-side merge and the fallback when the list overflowed) are gone: the
CUDA kernel bins short runs in registers and shared memory and the rare long
ones with global atomics, straight into the int64 histogram.
"""

from __future__ import annotations

import torch

from fastk_tpu_torch import trace
from fastk_tpu_torch.formats.hist import HIST_HIGH
from fastk_tpu_torch.ops.count import fold_invalid, run_starts, sort_keys
from fastk_tpu_torch.ops.kmers import canonical_kmers

NBINS = HIST_HIGH + 1


def pack_starts(starts: torch.Tensor) -> torch.Tensor:
    """bool [size] -> int32 [size/32]: bit b of word w = starts[32w + b]."""
    if starts.numel() % 32:
        raise ValueError(f"size {starts.numel()} is not a multiple of 32")
    shifts = torch.arange(32, dtype=torch.int64, device=starts.device)
    w = (starts.view(-1, 32).to(torch.int64) << shifts).sum(1)
    return w.to(torch.int32)  # wraps bit 31 into the sign, as wanted


def start_words(s_words, valid_end: int) -> torch.Tensor:
    """Sorted key words -> packed run starts, cleared at and after valid_end
    (the all-ones invalid tail is not a run to bin), padded with cleared
    bits to a whole word."""
    return pack_valid_starts(run_starts(s_words), valid_end)


def hist_device_part(codes: torch.Tensor, k: int, size: int):
    """Canonical keys -> sort -> packed run starts.

    Returns (start words int32 [size/32], valid_end), valid_end = size - the
    number of invalid windows."""
    words, invalid = canonical_kmers(codes, k, size)
    ninv = invalid.sum()
    s_words, _ = sort_keys(fold_invalid(words, invalid))
    del words, invalid
    with trace.wait("hist_ninv"):
        valid_end = size - int(ninv)
    return start_words(s_words, valid_end), valid_end


def pack_valid_starts(starts: torch.Tensor, valid_end: int) -> torch.Tensor:
    """bool run starts -> packed start words, the starts at and after
    valid_end cleared (in place) and the tail padded with cleared bits to a
    whole word."""
    starts[valid_end:] = False
    pad = -starts.numel() % 32
    if pad:
        starts = torch.cat([starts, starts.new_zeros(pad)])
    return pack_starts(starts)


def _check(start_words: torch.Tensor, valid_end: int) -> None:
    if (start_words.dtype != torch.int32 or start_words.dim() != 1
            or not start_words.is_contiguous()):
        raise ValueError("start_words must be a contiguous 1-D int32 tensor")
    if not 0 <= valid_end <= 32 * start_words.numel():
        raise ValueError(f"valid_end {valid_end} outside [0, "
                         f"{32 * start_words.numel()}]")


def run_hist_ref(start_words: torch.Tensor, valid_end: int):
    """Plain torch run-length histogram; see run_hist."""
    _check(start_words, valid_end)
    shifts = torch.arange(32, dtype=torch.int64, device=start_words.device)
    bits = (start_words.to(torch.int64).unsqueeze(1) >> shifts) & 1
    starts = bits.reshape(-1)[:valid_end].bool()
    del bits
    if valid_end:
        starts[0] = True
    pos = torch.nonzero(starts).flatten()
    ends = torch.cat([pos[1:], pos.new_tensor([valid_end])])[: pos.numel()]
    lens = torch.clamp(ends - pos, max=HIST_HIGH)
    return torch.bincount(lens, minlength=NBINS), valid_end


def run_hist(start_words: torch.Tensor, valid_end: int):
    """Histogram of run lengths from packed run starts.

    start_words: int32 [size/32], LSB-first (bit b of word w = a run starts
    at 32w + b); position 0 always starts a run, and bits at and after
    valid_end are ignored. Each run ends at the next start, the last at
    valid_end. Returns (hist int64 [32768], nvalid = valid_end): hist[c]
    counts the runs of length c clipped at 32767; hist[0] = 0.

    A CPU tensor takes run_hist_ref. A CUDA tensor launches the CUDA kernel
    on the current stream (it zeroes and fills the int64 histogram itself:
    one memset, one kernel), adds one to run_hist.launches, and raises if the
    launch fails."""
    _check(start_words, valid_end)
    if start_words.device.type == "cpu":
        return run_hist_ref(start_words, valid_end)
    if start_words.device.type != "cuda":
        raise ValueError(f"run_hist runs on cpu or cuda, not "
                         f"{start_words.device}")
    from fastk_tpu_torch import _kernels

    lib = _kernels.load()
    dev = start_words.device
    hist = torch.empty(NBINS, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.fk_run_hist(
            start_words.data_ptr(), start_words.numel(), valid_end,
            hist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, "run_hist kernel launch")
    run_hist.launches += 1
    return hist, valid_end


run_hist.launches = 0
