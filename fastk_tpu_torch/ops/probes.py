"""The run-end primitives, one CUDA kernel each: a histogram at dynamic
indices, a scalar loop, bit operations (clz, the ctz walk, packing a mask)
and a carry between blocks.

Port of the Mosaic feasibility probes ``benchmarks/_pallas_feas*.py`` (P1-P14
in PERF.md), each of which asked whether the TPU could do one of these. Each
function here launches its kernel of ``csrc/probes.cu`` on a CUDA tensor (or
raises) and adds one to its ``launches``; on a CPU tensor it runs its plain
torch version (``*_ref``), which the tests and the chip smoke run hold the
kernel against. Every function takes any length; ``fastk_tpu_torch.probes``
calls them at the probes' own shapes.
"""

from __future__ import annotations

import math

import torch

MAX_BINS = 232448 // 4      # a block's shared memory on the H100, in int32
MAX_SHARED_TABLE = 12288    # int32 entries the loop's shared mode copies
CARRY_TILE = 8 * 8 * 128    # values a tile of the carry's scan (kCarryTile)
LOOP_MODES = ("index", "static", "global", "shared")
BITS_MODES = ("clz", "walk", "pack")


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32, as the kernels' int32 arithmetic wraps."""
    return ((v + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _device(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return t.device.type


def _int32(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous int32 tensor")


def _launch(fn, what: str, dev: torch.device, *args) -> None:
    from fastk_tpu_torch import _kernels

    with torch.cuda.device(dev):
        err = getattr(_kernels.load(), f"fk_{fn.__name__}")(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(err, f"{what} kernel launch")
    fn.launches += 1


# ---- the histogram at dynamic indices (P1, P5, P6, P10, P11, P14-D) ----

def _check_hist(x: torch.Tensor, nbins: int, store: bool) -> None:
    _int32(x, "probe_hist's x")
    if not 1 <= nbins <= MAX_BINS:
        raise ValueError(f"nbins {nbins} outside [1, {MAX_BINS}]")
    if store and x.numel() >= 1 << 31:
        raise ValueError("store mode takes fewer than 2^31 values")


def probe_hist_ref(x: torch.Tensor, nbins: int, store: bool = False):
    """Plain torch version of probe_hist."""
    _check_hist(x, nbins, store)
    x = x.reshape(-1)
    keep = (x >= 0) & (x < nbins)
    if store:
        out = torch.zeros(nbins, dtype=torch.int64, device=x.device)
        idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device)
        out.scatter_reduce_(0, x[keep].long(), idx[keep], "amax")
        return out.to(torch.int32)
    return torch.bincount(x[keep], minlength=nbins).to(torch.int32)


def probe_hist(x: torch.Tensor, nbins: int, store: bool = False):
    """int32 [nbins] from the int32 values x (any shape, read in order).

    Add mode: out[v] counts the values equal to v; values outside [0,
    nbins) are skipped. Store mode: out[x[i]] = i (the largest i where
    several share a value, as a loop in order leaves it), 0 where no value
    lands. nbins is at most MAX_BINS, a block's shared memory. x may be any
    contiguous view: values before its first 16-byte boundary and after its
    last whole 16 bytes take scalar loads inside the kernel."""
    _check_hist(x, nbins, store)
    if _device(x, "probe_hist") == "cpu":
        return probe_hist_ref(x, nbins, store)
    out = torch.empty(nbins, dtype=torch.int32, device=x.device)
    _launch(probe_hist, "probe_hist", x.device, x.data_ptr(), x.numel(),
            nbins, int(store), out.data_ptr())
    return out


probe_hist.launches = 0


# ---- the scalar loop (P2, P8, P12, P14-A/B/C) ---------------------------

def _check_loop(table: torch.Tensor, trips: torch.Tensor, mode: str):
    _int32(table, "probe_loop's table")
    _int32(trips, "probe_loop's trips")
    if mode not in LOOP_MODES:
        raise ValueError(f"mode {mode!r} not in {LOOP_MODES}")
    if table.dim() != 2 or trips.numel() < 1:
        raise ValueError("probe_loop takes a 2-D table and a trip count")
    rows, cols = table.shape
    if rows < 1 or cols < 1 or rows & (rows - 1) or cols & (cols - 1):
        raise ValueError(f"table shape {tuple(table.shape)}: rows and cols "
                         "must be powers of two")
    if mode == "shared" and table.numel() > MAX_SHARED_TABLE:
        raise ValueError(f"shared mode copies at most {MAX_SHARED_TABLE} "
                         "values")
    if trips.device != table.device:
        raise ValueError("table and trips lie on different devices")
    return rows, cols


def probe_loop_ref(table: torch.Tensor, trips: torch.Tensor, mode: str):
    """Plain torch version of probe_loop, in closed form."""
    rows, cols = _check_loop(table, trips, mode)
    n = max(int(trips.reshape(-1)[0]), 0)
    if mode == "index":
        total = torch.tensor(n * (n - 1) // 2 if n else 0)
    elif mode == "static":
        total = n * table[0, 0].long()
    else:
        # (i & (rows-1), i & (cols-1)) repeats every max(rows, cols) steps
        period = max(rows, cols)
        i = torch.arange(period, device=table.device)
        one = table[i & (rows - 1), i & (cols - 1)].long()
        total = (n // period) * one.sum() + one[: n % period].sum()
    return _wrap32(total.reshape(1).to(table.device))


def probe_loop(table: torch.Tensor, trips: torch.Tensor, mode: str):
    """int32 [1]: the sum over the steps i of [0, trips[0]) (int32 [>=1],
    read by the kernel from device memory; none when it is 0 or less), as
    int32 arithmetic wraps, of:

    - "index": i;
    - "static": table[0, 0], loaded again each step;
    - "global": table[i & (rows-1), i & (cols-1)] from device memory;
    - "shared": the same from a copy of the table in shared memory.

    table is int32 [rows, cols], rows and cols powers of two. The kernel
    spreads the steps over the card (loop_threads), each step with its own
    load and add."""
    _check_loop(table, trips, mode)
    if _device(table, "probe_loop") == "cpu":
        return probe_loop_ref(table, trips, mode)
    out = torch.empty(1, dtype=torch.int32, device=table.device)
    rows, cols = table.shape
    _launch(probe_loop, "probe_loop", table.device, table.data_ptr(), rows,
            cols, trips.data_ptr(), LOOP_MODES.index(mode), out.data_ptr())
    return out


probe_loop.launches = 0


def loop_threads(table: torch.Tensor, mode: str) -> int:
    """The threads of probe_loop's grid for this CUDA table and mode (the
    CTAs the card holds at once): each takes one contiguous run of the
    steps, ceil(trips / threads) rounded up to a multiple of max(rows,
    cols, 8)."""
    import ctypes

    from fastk_tpu_torch import _kernels

    _check_loop(table, table.new_ones(1), mode)
    if table.device.type != "cuda":
        raise ValueError("loop_threads reads the grid of a CUDA table")
    threads = ctypes.c_int(0)
    with torch.cuda.device(table.device):
        err = _kernels.load().fk_probe_loop_threads(
            *table.shape, LOOP_MODES.index(mode), ctypes.byref(threads))
    _kernels.check(err, "probe_loop's grid")
    return threads.value


# ---- clz, the ctz walk and the pack (P3, P9, P13, P14-E) ----------------

def _check_bits(x: torch.Tensor, mode: str, width: int) -> None:
    if mode not in BITS_MODES:
        raise ValueError(f"mode {mode!r} not in {BITS_MODES}")
    if mode == "pack":
        if x.dtype != torch.bool or not x.is_contiguous():
            raise ValueError("pack takes a contiguous bool mask")
        if width not in (16, 32) or x.numel() % width:
            raise ValueError(f"pack: width {width} must be 16 or 32 and "
                             f"divide the mask's {x.numel()} bits")
    else:
        _int32(x, f"{mode}'s words")


def probe_bits_ref(x: torch.Tensor, mode: str, width: int = 32):
    """Plain torch version of probe_bits."""
    _check_bits(x, mode, width)
    if mode == "pack":
        shifts = torch.arange(width, dtype=torch.int64, device=x.device)
        return _wrap32((x.reshape(-1, width).long() << shifts).sum(1))
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    bits = (x.reshape(-1, 1).long() >> shifts) & 1   # bit 31 as index 31
    if mode == "walk":
        return (bits * shifts).sum().reshape(1)
    set_at = torch.where(bits.bool(), shifts, -1).amax(1)
    return (31 - set_at).to(torch.int32).reshape(x.shape)


def probe_bits(x: torch.Tensor, mode: str, width: int = 32):
    """Bit operations on int32 words, bit 31 taken as bit 31 (unsigned):

    - "clz": int32, x's shape: the leading zeros of each word (32 for 0);
    - "walk": int64 [1]: the sum over words of the indices of their set
      bits, walked by ctz (the run-end walk's shape);
    - "pack": x a bool mask of n bits -> int32 [n / width], bit b of word w
      = x[width * w + b] (width 16 or 32; bit 31 lands in the sign). The
      kernel reads a mask byte as set when it is not 0, so a bool view of
      uint8 bytes 2-255 packs as if they were 1.

    Any contiguous view goes: a mask that does not start on a 16-byte
    boundary, and its last bytes that do not fill 32, take scalar loads
    inside the kernel."""
    _check_bits(x, mode, width)
    if _device(x, "probe_bits") == "cpu":
        return probe_bits_ref(x, mode, width)
    n = x.numel()
    if mode == "clz":
        out = torch.empty_like(x)
    elif mode == "walk":
        out = torch.empty(1, dtype=torch.int64, device=x.device)
    else:
        out = torch.empty(n // width, dtype=torch.int32, device=x.device)
    _launch(probe_bits, "probe_bits", x.device, x.data_ptr(), n,
            BITS_MODES.index(mode), width, out.data_ptr())
    return out


probe_bits.launches = 0


# ---- the carry between blocks (P4, P7) -----------------------------------

def _check_carry(x: torch.Tensor) -> None:
    _int32(x, "probe_carry's x")
    if x.dim() < 1:
        raise ValueError("probe_carry takes [nblocks, ...] values")


def probe_carry_ref(x: torch.Tensor):
    """Plain torch version of probe_carry."""
    _check_carry(x)
    sums = x.reshape(x.shape[0], math.prod(x.shape[1:])).long().sum(1)
    return _wrap32(torch.cumsum(sums, 0))


def carry_scratch(n: int) -> int:
    """int64 words of the carry's scratch for n values: a status word for
    each tile of the flat stream (which starts at the 16-byte boundary at
    or before x, up to 3 values early) and the ticket."""
    return (n + 3 + CARRY_TILE - 1) // CARRY_TILE + 1


def probe_carry(x: torch.Tensor):
    """int32 [nblocks]: out[b] = the sum of x[0..b] (x int32 [nblocks,
    ...]; each block's values summed, then carried from block to block, as
    int32 arithmetic wraps).

    The kernel scans x as one flat stream in tiles of CARRY_TILE values,
    whatever the block's length, and reads out[b] at each block's end. Any
    contiguous view goes: values before its first 16-byte boundary and
    after its last whole share of a thread take scalar loads inside the
    kernel."""
    _check_carry(x)
    if _device(x, "probe_carry") == "cpu":
        return probe_carry_ref(x)
    nblocks = x.shape[0]
    blen = x.numel() // nblocks if nblocks else 0
    out = torch.empty(nblocks, dtype=torch.int32, device=x.device)
    scratch = torch.empty(carry_scratch(x.numel()), dtype=torch.int64,
                          device=x.device)
    _launch(probe_carry, "probe_carry", x.device, x.data_ptr(), nblocks,
            blen, scratch.data_ptr(), out.data_ptr())
    return out


probe_carry.launches = 0

KERNELS = (probe_hist, probe_loop, probe_bits, probe_carry)
