#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fastk_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile the CUDA kernels from ``fastk_tpu_torch/csrc``;
3. the run-length histogram kernel against its plain torch version on the
   card, on crafted start masks (the kernel's tile edges among them), on an
   unaligned view and on random ones up to 2^26 positions;
4. the histogram job on one batch of about 60 Mbp of 50X-HiFi-like reads
   (2^26 positions), through the CLI, with the kernel's launch count,
   exact instance accounting and a second computation that bins the same
   sorted keys with the plain version, and the kernel against the plain
   version on the batch's start words;
5. the job on about 200 Mbp in several batches, at two batch sizes that must
   give byte-identical histograms, and on 1 Mbp against a numpy count;
6. times on the card at 2^26 positions: the kernel (a launch in a CUDA
   graph of 20, and one call's window), its bound and its share of it, on
   the phase-4 batch and on a random mask, its plain version, the key sort
   and canonical_kmers;
7. the table-and-profile job (-t3 -p, and -t1 -p) on the phase-4 batch
   through the CLI: the kernel's launches on the fused path, the .hist equal
   to phase 4's, the -t1 counts summing to the instances, the -t3 table
   equal to the -t1 entries >= 3, and the profile sum equal to the sum of
   count^2;
8. the same job in batches of 2^24 bases, with the instance streams kept on
   the card and with none kept, byte-identical to phase 7; -p:<table>
   against phase 7's -t1 table equal to its profiles; 200 Mbp with -t3 -p;
   1 Mbp on the card and on the CPU byte-identical, its table equal to a
   numpy count;
9. times on the card at 2^26 positions of the -t -p stages: count_batch,
   its key sort with positions and its position inverse, compact_table_min,
   both joins, the host profile encode, and the whole -t3 -p batch;
10. the out-of-core job through the CLI (-M1, -P): -t3 and -t3 -p on the
    phase-5 input, planned out of core by the measured plan, byte-identical
    to the in-core file-sets of phase 8, with the plan and the stage times;
11. part merges of about 5e7 records through count_files_ooc (2 parts of a
    600 Mbp, 12 Mbp-genome input, part_cap 2^26), byte-identical to the
    in-core -t3 run, with stage times and the device footprints of the
    in-core jobs and of a part merge with want_back;
12. -R: the phase-10 -t3 -p job killed (SIGKILL) after its first batch and
    resumed, byte-identical to phase 10; the out-of-memory demotion under a
    per-process memory cap, byte-identical to the in-core run; kmermap on
    the card equal to the CPU; a FASTK_TPU_TRACE trace of the phase-4 job
    with the run_hist kernel in it, and the device's busy share;
13. the table tools, each through its launcher in fastk_tpu_torch/bin/, on
    the phase-5 input split by read into halves A and B, whose -t1 tables
    (about 1.6e7 entries each, counted on the card) fastmerge merges into
    the whole's -t1 table, also in -S slices spliced by fastcat;
    merge_tables and logex_apply (every expression shape) with their union
    on the card, equal to the CPU and to the native fastmerge and logex,
    with the union's times; vennex, histex, tabex, profex, haplex, homex,
    symmex, fastcp, fastmv and fastrm, each checked against the port's
    readers; a host launcher's start-up, and no host tool loading torch;
14. the multi-device library (``parallel/``) in an NCCL world of one:
    sharded_count on the phase-4 batch equal to count_batch, with its
    run_hist launch; count_files_mesh -t3 -p on the phase-5 input
    byte-identical to phase 10, with its phase times; the D = 4 device steps
    (route, exchange as a block transpose, owner count, counts back) on one
    card equal to count_batch, each timed; relative_profiles_sharded equal
    to phase 7's -p:<table> profiles; and -k40 -t3 -p -M8 on the phase-4
    input run out of core under 8e9 B of device memory;
15. the entry points (``fastk_tpu_torch/entry.py``): entry()'s step
    on the card equal to the CPU port's, with its run_hist launch;
    dryrun_multichip over an NCCL world of every visible card; and, only
    on two or more cards, the mesh job -t3 -p on the phase-5 input split
    into 8 files in a world of every card and in a world of one, both
    byte-identical to phase 10, with walls, phases and each rank's device
    peak, and sharded_count on the phase-4 batch at D = cards with its
    all_to_all_single times;
16. the probe kernels (``fastk_tpu_torch/csrc/probes.cu``, the Mosaic
    probes P1-P14 of ``benchmarks/_pallas_feas*.py``): ``python -m
    fastk_tpu_torch.probes`` on the card, its 19 probe lines OK with each
    kernel's launches; each kernel against its plain version at the
    probes' shapes and at the main path's scale (2^26 values into 32768
    bins, the walk and pack of the phase-4 batch's 2^21 start words, a
    carry over 2^14 blocks, 1M loop steps) and at the 16-byte loads' edges
    (views off a 16-byte boundary, tails, uint8 bytes viewed as bool),
    and the carry at every shape its tiles meet (1-D, one row of 2^26,
    2^26 rows of one value, odd rows from an unaligned view, empty sides,
    sums that wrap), timed beside its bound, its plain version and, for
    the histogram and the carry, the library calls of the same function;
    the loop's ns a step and its latency floor at the SM clock; the
    histogram at 4096 bins and on 2^21 values; the carry at its three
    shapes; and, with an untracked copy of the parent's csrc/probes.cu at
    PARENT_PROBES, the parent's histogram, pack, walk and carry in turns
    with this tree's;
17. the -M host-memory bound (``fastk_tpu_torch/probes/rss.py``, the port's
    ``benchmarks/bench_rss.py``): the CLI out of core at -k40 -t1 -M1 and
    count_files_mesh in a world of one at the -M1 plan (-t1 -p), each a
    fresh process on 80 and 240 MB of random bases; each run's peak RSS,
    its peak above the runtime floor, its device peak, the pinned-host
    cache's peak, run_hist's launches (the mesh's) and its wall, and the
    JAX script's flatness verdict, which must be PASS for both;
18. the port's headline bench (``fastk_tpu_torch/bench.py``, the
    counterpart of bench.py): its headline step on the bench's 2^24 batch
    equal to the step with the plain binning, one run_hist launch a step,
    the fused step equal to the CPU port's, sort_counted on the card equal
    to numpy's order; ``python -m fastk_tpu_torch.bench`` at 2^24 and 2^26
    in subprocesses, its lines printed and checked (the headline last, at
    least 3 trials, the step's host syncs, pinning and waits on the line
    before it); ``probes.profiles`` and ``probes.stages`` (2^26) with their
    lines;
19. the ports of the rest of ``benchmarks/`` (``fastk_tpu_torch/probes/``
    sizes, tail, sorts, h2d and decomp): each module's cases at 2^16 on the
    card equal to the CPU's; then each module's lines at full size: the
    sort and binning at batch sizes 2^23-2^27, the post-sort primitives
    flat and in rows (each row form equal to its flat form), the sort
    layouts at 2^26 (the row and stable sorts' words equal to sort_keys',
    the hash grouping's runs equal to sort_keys' runs, hash_hist equal to
    hist_batch, the pair histogram equal to torch.bincount), the H2D rates
    and overlaps, and the headline step's A/B (JAX's sort-and-searchsorted
    binning step equal to the run-length kernel's in every round) at 2^24
    and 2^26; run_hist launched in sizes, sorts and decomp.

Run with arguments, the script is a rank of a phase-15c world
(``fastk_tpu_torch/parallel/launch.py``).

Then one JSON line describing each kernel, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result. The inputs are made from fixed numpy seeds.
"""

from __future__ import annotations

import glob
import io
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stderr, redirect_stdout

import numpy as np

K = 40
READ_LEN = 20_000


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """bool [n], n a multiple of 32 -> int32 [n/32], LSB-first."""
    return np.packbits(mask, bitorder="little").view("<i4")


def _mask_from_lengths(lengths, n: int):
    mask = np.zeros(n, bool)
    starts = np.cumsum([0] + list(lengths[:-1]))
    mask[starts] = True
    return pack_mask(mask), int(sum(lengths))


def _mask_from_starts(starts, n: int, valid_end: int, fill=None):
    """Start words of n positions with the given starts (and the bool mask
    `fill` or'ed in), cleared at and after valid_end."""
    mask = np.zeros(n, bool) if fill is None else fill.copy()
    mask[list(starts)] = True
    mask[valid_end:] = False
    return pack_mask(mask), valid_end


TILE = 1 << 15  # positions of one tile of the CUDA kernel (1024 words)


def tile_masks(seed: int = 2):
    """(name, start words int32, valid_end) cases at the CUDA kernel's tile
    edges (tiles of 32768 positions; the next tile's first 4096 positions
    are read by one warp, the rest only when those hold no start)."""
    rng = np.random.default_rng(seed)
    T = TILE
    cases = [
        # runs that end exactly at a tile's last position and at its first
        ("tile_edge_ends", *_mask_from_starts(
            [0, T - 1, T, T + 1, 2 * T - 1, 2 * T + 1, 3 * T - 2, 3 * T,
             4 * T - 1, 4 * T, 5 * T + 1], 8 * T, 8 * T)),
        # a run across one whole tile, one across two, one across an edge
        ("runs_across_tiles", *_mask_from_starts(
            [0, T - 5, 2 * T + 3, 3 * T - 2, 6 * T + 1, 7 * T - 100,
             7 * T + 200], 8 * T, 8 * T)),
        # runs of 32766, 32767 and 32768 starting in a tile's last word
        ("lengths_32766_to_32768_from_last_word", *_mask_from_starts(
            [0, T - 20, T - 20 + 32766, 3 * T - 7, 3 * T - 7 + 32767,
             5 * T - 31, 5 * T - 31 + 32768], 7 * T, 7 * T)),
        # an all-zero tile after a start; next starts past the next tile's
        # first 4096 positions, and at its 4096th
        ("empty_tile_after_start", *_mask_from_starts(
            [0, 2 * T - 3, 3 * T + 10, 4 * T - 1, 4 * T + 5000, 6 * T - 1,
             6 * T + 4095, 6 * T + 4096], 7 * T, 7 * T)),
    ]
    edge = np.zeros(4 * T, bool)
    edge[T - 64: T + 64] = True
    edge[3 * T - 32: 3 * T + 32] = True
    edge |= rng.random(4 * T) < 0.01
    cases.append(("ones_at_tile_edges", pack_mask(edge), 4 * T))
    rnd = rng.random(4 * T) < 0.2
    for name, ve in (("valid_end_mid_word", 3 * T + 17),
                     ("valid_end_on_tile_edge", 2 * T),
                     ("valid_end_before_tile_edge", 2 * T - 1),
                     ("valid_end_after_tile_edge", 2 * T + 1)):
        cases.append((name, *_mask_from_starts([], 4 * T, ve, rnd)))
        cases.append((name + "_tail_bits", pack_mask(rnd), ve))
    cases.append(("valid_end_0", pack_mask(rnd[:T]), 0))
    cases.append(("valid_end_1", pack_mask(rnd[:T]), 1))
    cases.append(("partial_last_tile", *_mask_from_starts(
        [], 2 * T + 5024, 2 * T + 5000, rng.random(2 * T + 5024) < 0.05)))
    return cases


def crafted_masks(seed: int = 0):
    """(name, start words int32, valid_end) cases for the run-length kernel:
    edge lengths, runs across word and block boundaries, invalid tails, and
    the CUDA kernel's tile edges (tile_masks)."""
    rng = np.random.default_rng(seed)
    S = 1 << 15
    one_run = np.zeros(1 << 20, bool)
    one_run[0] = True
    cases = [
        ("empty", pack_mask(np.zeros(S, bool)), 0),
        ("singletons", pack_mask(np.ones(S, bool)), S),
        ("one_run_2^20", pack_mask(one_run), 1 << 20),
        ("no_start_bit_0", pack_mask(np.roll(one_run, 5)), 1 << 20),
        ("exact_lengths", *_mask_from_lengths(
            [2046, 2047, 32766, 32767, 32768, 1, 2, 3, 50], 1 << 18)),
    ]
    # runs that start and end on both sides of word (32 positions) and
    # block-iteration (32768 positions) boundaries
    lens = [31, 1, 32, 33, 32767 - 97, 2, 3, 32768 - 4, 64, 1]
    lens += list(rng.integers(1, 100, 3000))
    cases.append(("boundaries", *_mask_from_lengths(lens, 1 << 19)))
    tail = rng.random(1 << 16) < 0.3
    valid_end = (1 << 16) - 777
    tail_clear = tail.copy()
    tail_clear[valid_end:] = False
    cases.append(("invalid_tail", pack_mask(tail_clear), valid_end))
    cases.append(("tail_bits_ignored", pack_mask(tail), valid_end))
    cases.append(("random_2^20", pack_mask(rng.random(1 << 20) < 0.3),
                  1 << 20))
    return cases + tile_masks()


def random_words(n_pos: int, seed: int = 1):
    """A 2^26-scale random start mask: starts with probability 1/4, plus
    gaps of 64000 positions (runs that clip at 32767) and an invalid tail."""
    rng = np.random.default_rng(seed)
    nw = n_pos // 32
    words = (rng.integers(0, 1 << 32, nw, dtype=np.uint32)
             & rng.integers(0, 1 << 32, nw, dtype=np.uint32))
    for s in rng.integers(0, nw - 2000, 100):
        words[s: s + 2000] = 0
    valid_end = n_pos - 12345
    words[valid_end // 32 + 1:] = 0
    words[valid_end // 32] &= np.uint32((1 << (valid_end % 32)) - 1)
    return words.view(np.int32), valid_end


def write_hifi_fasta(path: str, genome_len: int, nreads: int, seed: int,
                     err: float = 0.003, read_len: int = READ_LEN) -> None:
    """50X-HiFi-like reads: read_len bases sampled from a random genome,
    `err` substitutions, half reverse-complemented; one line per read."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for lo in range(0, nreads, 500):
            n = min(500, nreads - lo)
            starts = rng.integers(0, genome_len - read_len + 1, n)
            reads = genome[starts[:, None] + np.arange(read_len)]
            bump = rng.integers(1, 4, (n, read_len), dtype=np.uint8)
            reads = np.where(rng.random((n, read_len)) < err,
                             (reads + bump) % 4, reads).astype(np.uint8)
            flip = rng.random(n) < 0.5
            reads[flip] = (3 - reads[flip])[:, ::-1]
            for i in range(n):
                f.write(b">r%d\n%s\n" % (lo + i, acgt[reads[i]].tobytes()))


def brute_count(codes: np.ndarray, k: int):
    """(Histogram, KmerTable at -t1) of the canonical k-mers of a code
    stream by numpy alone (k <= 64): every window without a code >= 4,
    forward and reverse complement packed into two uint64 halves,
    np.unique."""
    from numpy.lib.stride_tricks import sliding_window_view

    from fastk_tpu_torch.formats.hist import HIST_HIGH, Histogram
    from fastk_tpu_torch.formats.ktab import KmerTable, pack_codes

    win = sliding_window_view(codes, k)
    win = win[(win < 4).all(1)]

    def pack(a):
        out = np.zeros((len(a), 2), np.uint64)
        for j in range(k):
            h = j // 32
            out[:, h] = (out[:, h] << np.uint64(2)) | a[:, j].astype(np.uint64)
        return out

    f = pack(win)
    r = pack(3 - win[:, ::-1])
    use_r = (r[:, 0] < f[:, 0]) | ((r[:, 0] == f[:, 0]) & (r[:, 1] < f[:, 1]))
    canon = np.where(use_r[:, None], r, f)
    keys, counts = np.unique(canon, axis=0, return_counts=True)
    over = int(np.maximum(counts - HIST_HIGH, 0).sum())
    clipped = np.minimum(counts, HIST_HIGH)
    bases = np.zeros((len(keys), k), np.uint8)
    for j in range(k):
        h, nb = j // 32, min(32, k - 32 * (j // 32))
        shift = np.uint64(2 * (nb - 1 - j % 32))
        bases[:, j] = (keys[:, h] >> shift) & np.uint64(3)
    return (Histogram.from_clipped_counts(k, clipped, over),
            KmerTable(k, 1, pack_codes(bases), clipped))


def file_set(d: str, base: str, exts=(".hist", ".ktab", ".prof", ".pidx")
             ) -> dict:
    """{name: bytes} of the file-sets of `base` in directory d with the
    given extensions, hidden parts included, the base in each name replaced
    by '@' so that two bases compare."""
    out = {}
    for name in sorted(os.listdir(d)):
        stem = name[1:] if name.startswith(".") else name
        if stem.startswith(base + ".") and any(
                e in stem[len(base):] for e in exts):
            with open(os.path.join(d, name), "rb") as f:
                out[name.replace(base, "@", 1)] = f.read()
    return out


def profile_sums(path: str):
    """(reads, positions, sum of counts) over a .prof file-set."""
    from fastk_tpu_torch.formats.prof import ProfileIndex

    pi = ProfileIndex(path)
    npos = total = 0
    for i in range(pi.nreads):
        p = pi.fetch(i)
        npos += len(p)
        total += int(p.sum(dtype=np.int64))
    return pi.nreads, npos, total


def sum_squares(hist) -> int:
    """Sum over unique k-mers of count^2, from a histogram whose last bin
    is empty (no count clipped)."""
    if hist.counts[-1]:
        raise AssertionError("a count reached 32767: sum of squares unknown")
    f = np.arange(1, len(hist.counts) + 1, dtype=np.int64)
    return int((hist.counts * f * f).sum())


class JoinCounter:
    """Count the pipeline's profile joins by branch: 'inst' (retained
    instance streams) and 'packed' (the packed codes uploaded again)."""

    def __init__(self):
        from fastk_tpu_torch.pipeline import count as tpipe

        self.n = {"inst": 0, "packed": 0}
        for branch, name in (("inst", "profile_join_inst"),
                             ("packed", "profile_join")):
            setattr(tpipe, name, self._wrap(branch, getattr(tpipe, name)))

    def _wrap(self, branch, fn):
        def counted(*args):
            self.n[branch] += 1
            return fn(*args)

        return counted

    def take(self) -> dict:
        got, self.n = self.n, {"inst": 0, "packed": 0}
        return got


class OocProbe:
    """Times the out-of-core job on the card by wrapping what
    pipeline/outofcore.py calls: each slice's dedup and each part merge with
    CUDA events, the spill writes and the profile encode on the host clock,
    and the starts of phases 2 and 3 (the first merge operands, the profile
    writer). Counts the merges, and those with want_back. With
    measure_back, each merge is followed by the same merge with want_back,
    whose device footprint (peak allocation above what was allocated before
    it, plus its operands) and time on the card are recorded apart; its
    time counts in phase 2's wall time but not in the merge times."""

    NAMES = ("unique_batch", "unique_batch_inst", "merge_unique_blocks",
             "pad_counted", "encode_profiles_bulk", "ProfWriter")

    def __init__(self, measure_back: bool = False):
        from fastk_tpu_torch.pipeline import outofcore as ooc

        self.ooc = ooc
        self.measure_back = measure_back
        self.slices, self.merges, self.back = [], [], []
        self.io = {"spill": [0.0, 0], "pos": [0.0, 0]}  # seconds, bytes
        self.encode_s = 0.0
        self.t_merge = self.t_prof = None

    @staticmethod
    def _events():
        import torch

        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        import torch

        ooc = self.ooc
        saved = self.saved = {n: getattr(ooc, n) for n in self.NAMES}
        self.saved_io = (ooc._Spill.append, ooc._PosSpill.append)

        def dedup(fn):
            def timed(*a):
                ev = self._events()
                ev[0].record()
                res = fn(*a)
                ev[1].record()
                self.slices.append(ev)
                return res
            return timed

        def merge(words, counts, want_back=False):
            ev = self._events()
            ev[0].record()
            out = saved["merge_unique_blocks"](words, counts,
                                               want_back=want_back)
            ev[1].record()
            n = counts.numel()
            self.merges.append((n, want_back, ev))
            if self.measure_back:
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                evb = self._events()
                evb[0].record()
                saved["merge_unique_blocks"](words, counts, want_back=True)
                evb[1].record()
                torch.cuda.synchronize()
                self.back.append((n, torch.cuda.max_memory_allocated()
                                  - before + n * (8 * len(words) + 4),
                                  evb[0].elapsed_time(evb[1])))
            return out

        def pad(*a):
            if self.t_merge is None:
                self.t_merge = time.perf_counter()
            return saved["pad_counted"](*a)

        def encode(*a):
            t0 = time.perf_counter()
            out = saved["encode_profiles_bulk"](*a)
            self.encode_s += time.perf_counter() - t0
            return out

        def writer(*a, **kw):
            if self.t_prof is None:
                self.t_prof = time.perf_counter()
            return saved["ProfWriter"](*a, **kw)

        def timed_io(kind, fn, width):
            def append(obj, i, a, b):
                t0 = time.perf_counter()
                fn(obj, i, a, b)
                self.io[kind][0] += time.perf_counter() - t0
                self.io[kind][1] += len(b) * width(obj)
            return append

        ooc.unique_batch = dedup(saved["unique_batch"])
        ooc.unique_batch_inst = dedup(saved["unique_batch_inst"])
        ooc.merge_unique_blocks = merge
        ooc.pad_counted = pad
        ooc.encode_profiles_bulk = encode
        ooc.ProfWriter = writer
        ooc._Spill.append = timed_io("spill", self.saved_io[0],
                                     lambda o: 4 * (o.W + 1))
        ooc._PosSpill.append = timed_io("pos", self.saved_io[1], lambda o: 6)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.t_end = time.perf_counter()
        for n, fn in self.saved.items():
            setattr(self.ooc, n, fn)
        self.ooc._Spill.append, self.ooc._PosSpill.append = self.saved_io
        return False

    def report(self, nbatches: int) -> dict:
        """Stage times of the run: phase walls (s), phase 1 per batch (ms),
        the slices' dedup on the card (ms), spill writes (MB, MB/s), the
        merges (count, with want_back, ms on the card, the largest as
        (records, want_back, ms)), the profile encode (ms)."""
        slice_ms = [a.elapsed_time(b) for a, b in self.slices]
        merges = [(n, wb, a.elapsed_time(b)) for n, wb, (a, b) in self.merges]
        t_prof = self.t_prof or self.t_end
        out = dict(
            phase1_s=self.t_merge - self.t0,
            batch_ms=(self.t_merge - self.t0) * 1e3 / max(nbatches, 1),
            slices=len(slice_ms), slice_ms=statistics.median(slice_ms),
            phase2_s=t_prof - self.t_merge,
            merges=len(merges), back=sum(wb for _, wb, _ in merges),
            largest=max(merges), merge_ms=sum(ms for _, _, ms in merges),
            phase3_s=self.t_end - t_prof if self.t_prof else 0.0,
            encode_ms=self.encode_s * 1e3)
        for kind, (secs, nbytes) in self.io.items():
            out[f"{kind}_mb"] = nbytes / 1e6
            out[f"{kind}_mb_s"] = nbytes / 1e6 / secs if secs else 0.0
        return out


class UnionProbe:
    """Times the library union (tools/fastmerge.merge_tables,
    algebra.merge_universe) by wrapping what it calls: the host key packing
    (ops/kmers.py packed_to_words and words_to_packed), merge_counted
    (upload, merge, fetch) and in it the upload (pad_counted, the card
    synchronised after it) on the host clock, and the merge on the card
    (merge_unique_blocks) with CUDA events, with its row count."""

    def __enter__(self):
        import torch

        from fastk_tpu_torch.ops import kmers, tables

        self.mods = (kmers, tables)
        self.saved = (kmers.packed_to_words, kmers.words_to_packed,
                      tables.merge_counted, tables.merge_unique_blocks,
                      tables.pad_counted)
        self.host = {"packed_to_words": 0.0, "words_to_packed": 0.0,
                     "merge_counted": 0.0, "pad_counted": 0.0}
        self.merges = []

        def timed(name, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if name == "pad_counted":
                    torch.cuda.synchronize()
                self.host[name] += time.perf_counter() - t0
                return out
            return run

        def merge(words, counts, want_back=False):
            ev = OocProbe._events()
            ev[0].record()
            out = self.saved[3](words, counts, want_back=want_back)
            ev[1].record()
            self.merges.append((counts.numel(), ev))
            return out

        kmers.packed_to_words = timed("packed_to_words", self.saved[0])
        kmers.words_to_packed = timed("words_to_packed", self.saved[1])
        tables.merge_counted = timed("merge_counted", self.saved[2])
        tables.merge_unique_blocks = merge
        tables.pad_counted = timed("pad_counted", self.saved[4])
        return self

    def __exit__(self, *exc):
        kmers, tables = self.mods
        (kmers.packed_to_words, kmers.words_to_packed, tables.merge_counted,
         tables.merge_unique_blocks, tables.pad_counted) = self.saved
        return False

    def report(self) -> dict:
        """Host ms by stage, the merges' rows and their ms on the card."""
        out = {k: v * 1e3 for k, v in self.host.items()}
        out["rows"] = [n for n, _ in self.merges]
        out["card_ms"] = sum(a.elapsed_time(b) for _, (a, b) in self.merges)
        return out


# runs `-m <module> args` as python would, and records at exit whether the
# module loaded torch: the FASTK_PYTHON of the launchers in phase 13
_RECORDER = r'''
import atexit, os, runpy, sys

@atexit.register
def _record():
    with open(os.environ["CHIP_SMOKE_MODULES"], "a") as f:
        f.write("%s %d\n" % (sys.argv[0], "torch" in sys.modules))

assert sys.argv[1] == "-m"
sys.argv = sys.argv[2:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
'''

HOST_TOOLS = ("histex", "tabex", "profex", "fastrm", "fastmv", "fastcp",
              "logex", "symmex", "fastmerge", "fastcat", "vennex", "haplex",
              "homex")

# every expression shape of the Logex grammar, over tables A, B and C
ALL_SHAPES = [
    ("XU", "A|+B|+C"), ("XI", "A&.B&.C"), ("XD", "(A-B)-C"),
    ("XX", "A^B"), ("XN", "#(A|B)"), ("XM1", "A|<B"), ("XM2", "A|>B"),
    ("XM3", "A|*B"), ("XM4", "A&-B"), ("XF", "A[5-200]|+B[2-]"),
    ("XG", "A{40-60}"), ("XC", "(A&+B)[10-3000]{20-80}"),
    ("XP", "#A|+#B|+#C"),
]


class Launchers:
    """Runs the port's launchers (fastk_tpu_torch/bin/<tool>) as
    subprocesses, with the repo's root in front of PYTHONPATH as the
    launchers put it. FASTK_PYTHON is a stand-in interpreter that records,
    for each run, whether the tool loaded torch. Walls are summed by
    tool."""

    def __init__(self, tmp: str):
        self.bin = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "fastk_tpu_torch", "bin")
        rec = os.path.join(tmp, "recorder.py")
        with open(rec, "w") as f:
            f.write(_RECORDER)
        py = os.path.join(tmp, "python-recorder")
        with open(py, "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "{rec}" "$@"\n')
        os.chmod(py, 0o755)
        self.log = os.path.join(tmp, "modules.log")
        self.env = dict(os.environ, FASTK_PYTHON=py,
                        CHIP_SMOKE_MODULES=self.log)
        self.walls = {}

    def __call__(self, tool: str, *argv, cwd=None, record=True) -> str:
        t0 = time.perf_counter()
        r = subprocess.run([os.path.join(self.bin, tool), *argv], cwd=cwd,
                           env=self.env if record else None,
                           capture_output=True, text=True, timeout=900)
        self.walls[tool] = (self.walls.get(tool, 0.0)
                            + time.perf_counter() - t0)
        if r.returncode != 0:
            raise AssertionError(f"{tool} {' '.join(argv)}: rc "
                                 f"{r.returncode}\n{r.stderr[-3000:]}")
        return r.stdout

    def torch_loaded(self) -> dict:
        """{tool: whether any of its recorded runs loaded torch}."""
        out = {}
        with open(self.log) as f:
            for line in f:
                mod, flag = line.split()
                tool = mod.rsplit(".", 1)[-1]
                out[tool] = out.get(tool, False) or flag == "1"
        return out


def _entries_equal(a, b) -> bool:
    return (len(a) == len(b) and np.array_equal(a.packed, b.packed)
            and np.array_equal(a.counts, b.counts))


def table_tools_phase(tmp: str, fasta: str, prof: str) -> None:
    """Phase 13: the table tools on a bacterial 50X run. `fasta` is split by
    read into halves A and B; -t1 tables of A, B and of C, its first 20
    reads (the CLI in this process), and of the whole (bin/fastk) are
    counted on the card. `prof` is a .prof file-set for profex and for
    fastcp/fastmv/fastrm. Raises on any disagreement."""
    import torch

    from fastk_tpu_torch.algebra import logex_apply
    from fastk_tpu_torch.formats.hist import read_histogram
    from fastk_tpu_torch.formats.ktab import (kmer_to_string, pack_kmer,
                                              read_ktab, write_ktab)
    from fastk_tpu_torch.formats.prof import ProfileIndex
    from fastk_tpu_torch.ops.canonical import revcomp_packed
    from fastk_tpu_torch.ops.count import merge_unique_blocks
    from fastk_tpu_torch.ops.histker import run_hist
    from fastk_tpu_torch.ops.kmers import packed_to_words
    from fastk_tpu_torch.ops.tables import pad_counted
    from fastk_tpu_torch.tools.fastk import main as fastk_main
    from fastk_tpu_torch.tools.fastmerge import merge_tables

    smi = _smi()
    launch = Launchers(tmp)
    run_hist.launches = 0
    t13 = time.perf_counter()

    # the input: halves A and B by read, -t1 tables of A, B and the whole
    with open(fasta, "rb") as f:
        lines = f.read().split(b"\n")
    nreads = len(lines) // 2
    half = 2 * (nreads // 2)
    for name, part in (("A", lines[:half]), ("B", lines[half: 2 * nreads]),
                       ("C", lines[:40])):
        with open(os.path.join(tmp, f"half{name}.fasta"), "wb") as f:
            f.write(b"\n".join(part) + b"\n")
    del lines
    ha, hb, hw, table_c = (os.path.join(tmp, n)
                           for n in ("ha", "hb", "hw", "hsub"))
    t0 = time.perf_counter()
    for base, name in ((ha, "A"), (hb, "B"), (table_c, "C")):
        if fastk_main(["-k40", "-t1", f"-N{base}",
                       os.path.join(tmp, f"half{name}.fasta")]) != 0:
            raise AssertionError(f"fastk -t1 of half {name} failed")
    halves_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    launch("fastk", "-k40", "-t1", f"-N{hw}", fasta)
    ta, tb, tw = read_ktab(ha), read_ktab(hb), read_ktab(hw)
    print(f"phase 13 input: {nreads} reads split into halves of "
          f"{nreads // 2} and {nreads - nreads // 2}; -t1 tables counted on "
          f"the card: A {len(ta)}, B {len(tb)}, whole {len(tw)} entries, C "
          f"(the first 20 reads) {len(read_ktab(table_c))} "
          f"({len(ta) + len(tb) - len(tw)} shared by A and B); A, B and C "
          f"{halves_s:.2f} s in this process, the whole {launch.walls['fastk']:.2f}"
          f" s through bin/fastk [{smi}]", flush=True)

    # 13a: fastmerge of the halves = the whole; slices spliced by fastcat
    hm = os.path.join(tmp, "hm")
    launch("fastmerge", "-T4", "-ht", hm, ha, hb)
    merge_s = launch.walls["fastmerge"]
    tm = read_ktab(hm)
    if not _entries_equal(tm, tw):
        raise AssertionError("fastmerge of the halves differs from the "
                             "whole's -t1 table")
    if not np.array_equal(read_histogram(hm).counts,
                          read_histogram(hw).counts):
        raise AssertionError("fastmerge's .hist bins differ from the "
                             "whole's")
    for n in (1, 2):
        launch("fastmerge", "-T4", "-t", f"-S{n}of2",
               os.path.join(tmp, f"hs{n}"), ha, hb)
    launch("fastcat", "-t", os.path.join(tmp, "hc"),
           os.path.join(tmp, "hs1"), os.path.join(tmp, "hs2"))
    if not _entries_equal(read_ktab(os.path.join(tmp, "hc")), tm):
        raise AssertionError("fastcat of the -S slices differs from the "
                             "unsliced merge")

    # 13b: the library merge on the card, against the CPU and 13a
    rows = len(ta) + len(tb)
    walls = []
    for _ in range(2):
        with UnionProbe() as probe:
            t0 = time.perf_counter()
            got = merge_tables([ta, tb], device="cuda")
            walls.append(time.perf_counter() - t0)
        if not _entries_equal(got, tm):
            raise AssertionError("merge_tables on the card differs from "
                                 "fastmerge")
        del got
    rep_b = probe.report()
    t0 = time.perf_counter()
    cpu = merge_tables([ta, tb], device="cpu")
    cpu_s = time.perf_counter() - t0
    if not _entries_equal(cpu, tm):
        raise AssertionError("merge_tables on the CPU differs")
    del cpu
    words = packed_to_words(np.concatenate([ta.packed, tb.packed]), 40)
    counts = np.concatenate([ta.counts, tb.counts]).astype(np.int32)
    wt, ct = pad_counted(words, counts, torch.device("cuda"))
    del words, counts
    merge_ms = _cuda_ms(lambda: merge_unique_blocks(wt, ct), reps=5)
    del wt, ct
    torch.cuda.empty_cache()
    smi_b = _smi()
    print(f"phase 13a-b union of the halves: bin/fastmerge -T4 -ht "
          f"{merge_s:.2f} s, entries and .hist bins equal to the whole's "
          f"-t1 count; -S1of2 + -S2of2 spliced by bin/fastcat equal to the "
          f"unsliced merge; merge_tables on the card {walls[0]:.2f} s, "
          f"{walls[1]:.2f} s (second call: packed_to_words "
          f"{rep_b['packed_to_words']:.1f} ms, merge_counted "
          f"{rep_b['merge_counted']:.1f} ms of which the upload "
          f"{rep_b['pad_counted']:.1f} ms and the merge on the card "
          f"{rep_b['card_ms']:.3f} ms at {rep_b['rows']} rows, "
          f"words_to_packed {rep_b['words_to_packed']:.1f} ms), on the CPU "
          f"{cpu_s:.2f} s, both equal to fastmerge; merge_unique_blocks at "
          f"{rows} rows {merge_ms:.3f} ms on the card (median of 5, CUDA "
          f"events) [{smi_b}]", flush=True)

    # 13c: logex, every expression shape: native streamed CLI against the
    # library evaluator with its union on the card
    tc = read_ktab(table_c)
    lx = os.path.join(tmp, "lx")
    os.mkdir(lx)
    launch("logex", "-T4", "-h1:100",
           *(f"{os.path.join(lx, n)}={e}" for n, e in ALL_SHAPES),
           f"{ha}.ktab", f"{hb}.ktab", f"{table_c}.ktab")
    with UnionProbe() as probe:
        t0 = time.perf_counter()
        res = logex_apply(ALL_SHAPES, [ta, tb, tc], (1, 100), device="cuda")
        apply_s = time.perf_counter() - t0
    rep_c = probe.report()
    sizes = []
    for name, t, h in res:
        base = os.path.join(lx, name)
        if not _entries_equal(read_ktab(base), t):
            raise AssertionError(f"logex {name}: the CLI's table differs "
                                 "from logex_apply's")
        if read_histogram(base) != h:
            raise AssertionError(f"logex {name}: the histograms differ")
        sizes.append(len(t))
    del res
    print(f"phase 13c logex, {len(ALL_SHAPES)} expression shapes over A, B "
          f"and a {len(tc)}-entry C, -h1:100: bin/logex -T4 "
          f"{launch.walls['logex']:.2f} s, logex_apply on the card "
          f"{apply_s:.2f} s (union on the card {rep_c['card_ms']:.3f} ms at "
          f"{rep_c['rows']} rows; merge_counted {rep_c['merge_counted']:.1f} "
          f"ms with its upload {rep_c['pad_counted']:.1f} ms, key packing "
          f"{rep_c['packed_to_words']:.1f} + "
          f"{rep_c['words_to_packed']:.1f} ms); every table and histogram "
          f"equal; entries {dict(zip((n for n, _ in ALL_SHAPES), sizes))}",
          flush=True)

    # 13d: the other tools, each against the port's readers
    venn = os.path.join(tmp, "venn")
    os.mkdir(venn)
    launch("vennex", "-h1:32767", f"{ha}.ktab", f"{hb}.ktab", cwd=venn)
    only_a, only_b, both = (int(read_histogram(os.path.join(venn, n)).counts
                                .sum()) for n in ("HA_hb", "ha_HB", "HA_HB"))
    if (only_a + both, only_b + both) != (len(ta), len(tb)):
        raise AssertionError(f"vennex regions {only_a}, {only_b}, {both} do "
                             f"not add up to A {len(ta)} and B {len(tb)}")
    hist = read_histogram(hw)
    out = launch("histex", "-A", "-h1:32767", f"{hw}.hist")
    listed = {int(a): int(b) for a, b in (ln.split("\t")
                                          for ln in out.splitlines())}
    if listed != {f: int(c) for f, c in enumerate(hist.counts, 1) if c}:
        raise AssertionError("histex -A differs from the .hist")
    if "Table is OK" not in launch("tabex", "-C", f"{hw}.ktab"):
        raise AssertionError("tabex -C rejects the whole's table")
    out = launch("tabex", f"{hw}.ktab", "0-99").splitlines()
    want = [f" {i:9d}: {kmer_to_string(tw.packed[i], 40)} = "
            f"{int(tw.counts[i]):5d}" for i in range(100)]
    if out[0] != f"Opening 40-mer table with {len(tw):,} entries" or (
            out[1:] != want):
        raise AssertionError("tabex's listing differs from the table")
    pi = ProfileIndex(prof)
    out = launch("profex", prof, "1-2")
    want = "".join(f"\nRead {p + 1}:\n" + "".join(
        f" {i:5d}: {v:5d}\n" for i, v in enumerate(pi.fetch(p)))
        for p in range(2))
    if out != want:
        raise AssertionError("profex differs from the profiles")
    hap = [ln for ln in launch("haplex", "-g2:100", f"{hw}.ktab").splitlines()
           if ln]
    view = tw.packed.view("S10").ravel()
    for ln in hap[:2000]:
        s, c = ln.split()
        key = np.frombuffer(pack_kmer(s.lower()).tobytes(), "S10")[0]
        i = int(np.searchsorted(view, key))
        if i >= len(tw) or view[i] != key or (
                int(tw.counts[i]) != int(c) or not 2 <= int(c) <= 100):
            raise AssertionError(f"haplex lists {ln}, not in the table")
    if not hap:
        raise AssertionError("haplex found no pair")
    # homex walks the table in Python (~8 us an entry on the host), so it
    # reads C, as counted and as rewritten in 5 parts
    write_ktab(os.path.join(tmp, "hsub5"), tc, nparts=5)
    homex = [launch("homex", "-e3", "-g5:100", f"{b}.ktab")
             for b in (table_c, os.path.join(tmp, "hsub5"))]
    if homex[0] != homex[1] or " at:" not in homex[0]:
        raise AssertionError("homex differs between two part layouts of "
                             "one table")
    hsym = os.path.join(tmp, "hsym")
    launch("symmex", "-T4", f"{hw}.ktab", hsym)
    sym = read_ktab(hsym)
    pal = np.all(revcomp_packed(tw.packed, 40) == tw.packed, axis=1)
    c64 = tw.counts.astype(np.int64)
    if (len(sym) != 2 * len(tw) - int(pal.sum()) or not sym.check_sorted()
            or int(sym.counts.astype(np.int64).sum())
            != 2 * int(c64.sum()) - int(c64[pal].sum())):
        raise AssertionError("symmex's table is not the whole's with its "
                             "reverse complements")
    pdir = os.path.dirname(prof)
    pbase = os.path.basename(prof)
    want = file_set(pdir, pbase)
    for d in ("cp", "mv"):
        os.mkdir(os.path.join(tmp, d))
    launch("fastcp", prof, os.path.join(tmp, "cp"))
    launch("fastmv", os.path.join(tmp, "cp", pbase), os.path.join(tmp, "mv"))
    got_cp, left = file_set(os.path.join(tmp, "mv"), pbase), os.listdir(
        os.path.join(tmp, "cp"))
    launch("fastrm", os.path.join(tmp, "mv", pbase))
    if (got_cp != want or left or os.listdir(os.path.join(tmp, "mv"))
            or file_set(pdir, pbase) != want or len(want) < 6):
        raise AssertionError("fastcp/fastmv/fastrm lost or left parts of "
                             f"{sorted(want)}")

    # 13e: start-up of a host launcher, and no host tool loaded torch
    small_hist = f"{table_c}.hist"
    starts = []
    for _ in range(3):
        t0 = time.perf_counter()
        launch("histex", small_hist, record=False)
        starts.append(time.perf_counter() - t0)
    loaded = launch.torch_loaded()
    if set(loaded) != set(HOST_TOOLS) | {"fastk"} or any(
            loaded[t] for t in HOST_TOOLS) or not loaded["fastk"]:
        raise AssertionError(f"torch loaded by tool: {loaded}")
    if run_hist.launches:
        raise AssertionError("phase 13 launched run_hist")
    w = launch.walls
    print(f"phase 13d-e: vennex regions {only_a} + {both} = A, {only_b} + "
          f"{both} = B ({w['vennex']:.2f} s); histex -A = the .hist; tabex "
          f"-C OK and its listing = the reader's; profex = the profiles; "
          f"haplex {len(hap)} lines, each in the table ({w['haplex']:.2f} s);"
          f" homex on C equal on two part layouts ({w['homex']:.2f} s for "
          f"both); "
          f"symmex {len(sym)} entries = 2 x {len(tw)} - {int(pal.sum())} "
          f"palindromes ({w['symmex']:.2f} s); fastcp, fastmv, fastrm moved "
          f"and removed all {len(want)} files of the set; host launcher "
          f"start-up (histex on a small .hist) "
          f"{statistics.median(starts) * 1e3:.0f} ms (median of 3); the 13 "
          f"host tools ran without torch in sys.modules, bin/fastk with it; "
          f"run_hist launches 0; phase 13 {time.perf_counter() - t13:.1f} s "
          f"[{_smi()}]", flush=True)


def _timed_ms(fn):
    """(fn(), its milliseconds on the card between two CUDA events)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _valid_segments(res) -> tuple:
    """(words uint32 [n, W], counts) of a segmented count's valid
    segments, on the host."""
    from fastk_tpu_torch.convert import words_to_numpy

    ns = int(res["nseg"])
    v = res["seg_valid"][:ns]
    return (np.stack(words_to_numpy(w[:ns][v] for w in res["seg_words"]),
                     axis=1), res["seg_counts"][:ns][v].cpu().numpy())


def multi_device_phase(tmp: str, fasta: str, fasta5: str, prof: str,
                       ooc_base: str, ooc_wall: float) -> int:
    """Phase 14: the multi-device library (parallel/) on the card.

    a. an NCCL world of one (a FileStore, cuda:0): sharded_count on the
       phase-4 batch equal to count_batch, and count_files_mesh on the
       phase-5 input with -k40 -t3 -p at the CLI's -M1 plan, byte-identical
       to `ooc_base`, phase 10's out-of-core file-sets;
    b. the D > 1 device steps for D = 4 shards of the phase-4 batch on one
       card, the all_to_all done as the block transpose it computes, equal
       to count_batch (NCCL refuses two ranks on one card);
    c. relative_profiles_sharded in that world against `prof`'s -t1 table,
       equal to its profiles (the single-card -p:<table> run's);
    e. -k40 -t3 -p -M8 on the phase-4 input through the CLI: out of core,
       its device peak under 8e9 B, byte-identical to the fused in-core run,
       whose peak a position is printed (the CLI's FUSED_BYTES).

    Returns run_hist's launches in a."""
    import datetime
    import gc

    import torch
    import torch.distributed as dist

    from fastk_tpu_torch.formats.hist import write_histogram
    from fastk_tpu_torch.formats.ktab import read_ktab
    from fastk_tpu_torch.io.reader import batched_reads
    from fastk_tpu_torch.ops.count import (
        count_batch,
        positions_inverse,
        unique_batch_inst,
    )
    from fastk_tpu_torch.ops.histker import run_hist
    from fastk_tpu_torch.ops.kmers import canonical_kmers, nwords, pad_needed
    from fastk_tpu_torch.convert import device_codes
    from fastk_tpu_torch.parallel import dist as pdist
    from fastk_tpu_torch.parallel.host import (
        relative_profiles_sharded,
        sharded_count,
    )
    from fastk_tpu_torch.parallel.meshooc import count_files_mesh
    from fastk_tpu_torch.pipeline.count import _pad_codes, _round_size
    from fastk_tpu_torch.tools import fastk as cli

    dev = torch.device("cuda")
    t14 = time.perf_counter()
    (batch,) = [b for b, _ in batched_reads([fasta], 256 << 20)]
    size = _round_size(len(batch.codes), K)
    codes = _pad_codes(batch, K, size)

    # 14a: the library in an NCCL world of one
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "pg14.store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=600))
    try:
        mesh = pdist.make_mesh(device="cuda")
        if mesh.group is None or dist.get_backend(mesh.group) != "nccl":
            raise AssertionError("phase 14a: the mesh is not an NCCL world")
        run_hist.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        words, counts, hist_arr, over, pos = sharded_count(
            batch.codes, K, mesh, want_positions=True)
        sc_s = time.perf_counter() - t0
        sc_launches = run_hist.launches
        sort14 = os.path.join(tmp, "sort14")
        os.mkdir(sort14)
        est5 = os.path.getsize(fasta5)
        _parts, part_cap = cli._ooc_plan(est5, 1, True,
                                         cli._device_budget(dev))
        ppc = max(1, min(256, -(-est5 // part_cap)))  # as _run_mesh plans
        t0 = time.perf_counter()
        out14 = count_files_mesh(
            [fasta5], K, mesh=mesh, table_min=3, profiles=True,
            batch_bases=cli._batch_bases({"M": 1}), sort_path=sort14,
            parts_per_chip=ppc, part_cap=part_cap, out_base=f"{tmp}/m14",
            out_nparts=4, slice_positions=cli._slice_positions(1))
        mesh_s = time.perf_counter() - t0
        launches = run_hist.launches
        write_histogram(f"{tmp}/m14", out14.hist)
        phase_s = out14.mesh_stats["phase_s"]

        cb = count_batch(device_codes(codes, dev), K, size, True, True)
        want_w, want_c = _valid_segments(cb)
        if not (sc_launches == 1 and np.array_equal(words, want_w)
                and np.array_equal(counts, want_c)
                and np.array_equal(hist_arr, cb["hist"].cpu().numpy())
                and over == int(cb["overflow"])
                and np.array_equal(pos, cb["pos_counts"][: len(pos)]
                                   .cpu().numpy())):
            raise AssertionError(f"phase 14a: sharded_count differs from "
                                 f"count_batch ({sc_launches} launches)")
        if file_set(tmp, "m14") != file_set(tmp, ooc_base) or os.listdir(
                sort14):
            raise AssertionError("phase 14a: count_files_mesh differs from "
                                 "phase 10's out-of-core file-sets, or "
                                 "left spills")

        # 14c: -p:<table> through the multi-device library
        t0 = time.perf_counter()
        relative_profiles_sharded([fasta], read_ktab(prof), mesh,
                                  batch_bases=cli._batch_bases({"M": 12}),
                                  out_base=f"{tmp}/r14", out_nparts=4)
        rel_s = time.perf_counter() - t0
        if file_set(tmp, "r14", (".prof", ".pidx")) != file_set(
                tmp, os.path.basename(prof), (".prof", ".pidx")):
            raise AssertionError("phase 14c: relative_profiles_sharded "
                                 "differs from the -p:<table> profiles")
    finally:
        dist.destroy_process_group()
    del words, counts, pos, out14
    print(f"phase 14a NCCL world of one: sharded_count on the phase-4 batch "
          f"{sc_s:.2f} s, equal to count_batch (table of {len(want_c)} "
          f"entries, histogram, pos_counts), run_hist launches "
          f"{sc_launches}; count_files_mesh -k40 -t3 -p on the phase-5 "
          f"input at the -M1 plan ({ppc} parts) {mesh_s:.2f} s (phases "
          f"{phase_s[0]:.2f}, {phase_s[1]:.2f}, {phase_s[2]:.2f} s) against "
          f"phase 10's out-of-core CLI {ooc_wall:.2f} s, byte-identical; "
          f"run_hist launches in 14a {launches}; 14c "
          f"relative_profiles_sharded {rel_s:.2f} s, equal to -p:<table> "
          f"[{_smi()}]", flush=True)

    # 14b: the D = 4 device steps on one card, run twice, the second timed
    D, W, halo = 4, nwords(K), pad_needed(K)
    shard = size // D
    cap = int(shard // D * 1.8)
    spl = torch.from_numpy(pdist.splitters_from_prefix_hist(
        pdist.prefix_histogram(device_codes(codes, dev), K, size, 10)
        .cpu().numpy(), D).astype(np.int64)).to(dev)
    for _ in range(2):
        ms = dict(route=0.0, exchange=0.0, count=0.0, back=0.0)
        routes, sends = [], []
        for d in range(D):
            row = device_codes(codes[d * shard: (d + 1) * shard + halo], dev)

            def route():
                words, invalid = canonical_kmers(row, K, shard)
                return pdist._route_chip(
                    words, invalid,
                    torch.arange(shard, dtype=torch.int32, device=dev), spl,
                    D, cap, shard)

            r, t = _timed_ms(route)
            if int(r[2]):
                raise AssertionError(f"phase 14b: shard {d} overflowed its "
                                     f"route by {int(r[2])} records")
            ms["route"] += t
            sends.append(torch.stack([*r[0], r[1]], dim=2))
            routes.append((r[1], r[3]))
            del r, row
        recv, ms["exchange"] = _timed_ms(
            lambda: torch.stack(sends).transpose(0, 1).contiguous())
        del sends
        segs, hist4, back = [], 0, []
        for c in range(D):
            lanes = recv[c].reshape(D * cap, W + 1)
            res, t = _timed_ms(lambda: pdist._count_received(
                tuple(lanes[:, j] for j in range(W)), lanes[:, W], D * cap,
                True))
            ms["count"] += t
            segs.append(_valid_segments(res))
            hist4 = hist4 + res["hist"]
            back.append(res["rec_counts"].view(D, cap))
            del res, lanes
        del recv

        def inverse():
            got_back = torch.stack(back).transpose(0, 1).contiguous()
            return torch.cat([positions_inverse(
                orig, pdist._slot_counts_to_routed(
                    got_back[d].reshape(-1), valid.reshape(-1), shard))
                for d, (valid, orig) in enumerate(routes)])

        pos4, ms["back"] = _timed_ms(inverse)
        del back, routes
    if not (np.array_equal(np.concatenate([w for w, _ in segs]), want_w)
            and np.array_equal(np.concatenate([c for _, c in segs]), want_c)
            and torch.equal(hist4, cb["hist"])
            and torch.equal(pos4.to(torch.int16), cb["pos_counts"])):
        raise AssertionError("phase 14b: the D = 4 steps differ from "
                             "count_batch")
    print(f"phase 14b D = 4 device steps on one card, shards of 2^"
          f"{shard.bit_length() - 1} positions, cap {cap}: canonical_kmers "
          f"+ _route_chip {ms['route']:.3f} ms for the 4 shards, the "
          f"exchange as a block transpose {ms['exchange']:.3f} ms, "
          f"_count_received {ms['count']:.3f} ms for the 4 owners, counts "
          f"back + _slot_counts_to_routed + positions_inverse "
          f"{ms['back']:.3f} ms (CUDA events, the second of two runs); "
          f"equal to count_batch; the NCCL all_to_all at D > 1 is not run "
          f"on this one-card machine", flush=True)
    del cb, pos4, hist4, segs, want_w, want_c

    # 14e: F6, the -M bound of a one-batch -p job
    est4 = os.path.getsize(fasta)
    peaks = {}
    logs = {}
    for name, flags in (("f12", []), ("f8", ["-M8"])):
        sort = os.path.join(tmp, f"sort_{name}")
        os.mkdir(sort)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        log = io.StringIO()
        with redirect_stdout(log), redirect_stderr(log):
            rc = cli.main(["-k40", "-t3", "-p", "-v", *flags, f"-P{sort}",
                           f"-N{tmp}/{name}", fasta])
        peaks[name] = (torch.cuda.max_memory_allocated(), base)
        logs[name] = log.getvalue()
        if rc != 0 or os.listdir(sort):
            raise AssertionError(f"phase 14e {flags}: rc {rc}; log:\n"
                                 f"{logs[name][-3000:]}")
    plan8 = [ln.strip() for ln in logs["f8"].splitlines()
             if "measured dedup ratio" in ln or "out-of-core" in ln
             or "planning" in ln]
    if ("out-of-core:" not in logs["f8"] or "out-of-core:" in logs["f12"]
            or peaks["f8"][0] >= 8e9
            or file_set(tmp, "f8") != file_set(tmp, "f12")):
        raise AssertionError(f"phase 14e: -M8 peak {peaks['f8'][0]} B, "
                             f"plan {plan8}")
    fused_b = (peaks["f12"][0] - peaks["f12"][1]) / est4
    # an out-of-core slice's dedup at 2^26 positions, upload included
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = unique_batch_inst(device_codes(codes, dev), K, size)
    torch.cuda.synchronize()
    slice_b = (torch.cuda.max_memory_allocated() - base) / size
    del res
    print(f"phase 14e F6: -k40 -t3 -p -M8 on the phase-4 input ({est4} "
          f"bytes): plan {plan8}; max_memory_allocated "
          f"{peaks['f8'][0] / 1e9:.3f} GB (base {peaks['f8'][1] / 1e9:.3f} "
          f"GB) < 8 GB, file-sets byte-identical to the fused in-core run "
          f"at -M12, whose peak is {peaks['f12'][0] / 1e9:.3f} GB (base "
          f"{peaks['f12'][1] / 1e9:.3f} GB) = {fused_b:.1f} B a position "
          f"(FUSED_BYTES {cli.FUSED_BYTES}); a slice's unique_batch_inst "
          f"at 2^26 positions {slice_b:.1f} B a position (SLICE_BYTES "
          f"{cli.SLICE_BYTES}); phase 14 "
          f"{time.perf_counter() - t14:.1f} s [{_smi()}]", flush=True)
    return launches


def entry_phase() -> int:
    """Phase 15a: entry()'s step on the card equal to the CPU port's on the
    same codes (segments, counts, histogram, pos_counts). Returns run_hist's
    launches in the step."""
    import torch

    from fastk_tpu_torch import entry
    from fastk_tpu_torch.ops.histker import run_hist

    fn, (codes,) = entry.entry()
    cfn, (ccodes,) = entry.entry(device="cpu")
    if codes.device.type != "cuda":
        raise AssertionError(f"phase 15a: entry() put its codes on "
                             f"{codes.device}")
    fn(codes)  # warm-up: the kernel's build and first launch
    torch.cuda.synchronize()
    run_hist.launches = 0
    t0 = time.perf_counter()
    got = fn(codes)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = run_hist.launches
    want = cfn(ccodes)
    same = launches == 1 and all(
        int(got[key]) == int(want[key])
        for key in ("nseg", "nvalid", "overflow")) and all(
        torch.equal(got[key].cpu(), want[key])
        for key in ("seg_counts", "seg_valid", "hist", "pos_counts")) and all(
        torch.equal(g.cpu(), w)
        for g, w in zip(got["seg_words"], want["seg_words"]))
    if not same:
        raise AssertionError(f"phase 15a: entry()'s step on the card differs "
                             f"from the CPU port ({launches} run_hist "
                             f"launches)")
    print(f"phase 15a entry(): count_batch at k {entry.ENTRY_K}, 2^"
          f"{entry.ENTRY_SIZE.bit_length() - 1} positions on the card "
          f"{step_ms:.3f} ms (host wall, synchronised, after a warm-up), "
          f"equal to the CPU port (segments, {int(got['nseg'])} segments' "
          f"counts, histogram, pos_counts); run_hist launches {launches}",
          flush=True)
    return launches


def dryrun_phase(n: int) -> int:
    """Phase 15b: dryrun_multichip over an NCCL world of n ranks, one a
    card (entry.run_dryrun, which dryrun_multichip runs, returns the
    ranks' reports). Returns run_hist's launches over the ranks."""
    from fastk_tpu_torch import entry

    t0 = time.perf_counter()
    reports = entry.run_dryrun(n)
    wall = time.perf_counter() - t0
    if [r["rank"] for r in reports] != list(range(n)) or any(
            r["world"] != n or not r["device"].startswith("cuda")
            or r["run_hist_launches"] < 1 for r in reports):
        raise AssertionError(f"phase 15b: reports {reports}")
    launches = sum(r["run_hist_launches"] for r in reports)
    print(f"phase 15b dryrun_multichip({n}): an NCCL world of {n} rank(s), "
          f"one a card, every check passed in {wall:.2f} s (process "
          f"start-up included; the ranks' own walls "
          f"{[round(r['wall_s'], 2) for r in reports]} s); run_hist launches "
          f"by rank {[r['run_hist_launches'] for r in reports]}; devices "
          f"{[r['device'] for r in reports]} [{_smi()}]", flush=True)
    return launches


def _peak(dev):
    import torch

    return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)


def _task_mesh_job(args) -> dict:
    """A rank of phase 15c's mesh job: count_files_mesh on this rank's
    share of args["paths"], its slice streamed to <out_base>.<rank> (or
    <out_base> in a world of one); rank 0 writes the histogram there."""
    import torch

    from fastk_tpu_torch.formats.hist import write_histogram
    from fastk_tpu_torch.ops.histker import run_hist
    from fastk_tpu_torch.parallel.dist import make_mesh
    from fastk_tpu_torch.parallel.meshooc import count_files_mesh
    from fastk_tpu_torch.parallel.multihost import _barrier

    mesh = make_mesh(device=args["device"])
    sort = os.path.join(os.getcwd(), f"sort{mesh.rank}")
    os.makedirs(sort, exist_ok=True)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    _barrier()
    run_hist.launches = 0
    t0 = time.perf_counter()
    out = count_files_mesh(args["paths"], K, mesh=mesh, sort_path=sort,
                           out_base=args["out_base"], **args["kw"])
    wall = time.perf_counter() - t0
    _barrier()
    if mesh.rank == 0:
        write_histogram(args["out_base"], out.hist)
    return dict(wall_s=wall, phase_s=out.mesh_stats["phase_s"],
                stats=out.mesh_stats, peak=_peak(mesh.device),
                launches=run_hist.launches, slice_base=out.slice_base,
                hist=out.hist, spill_left=os.listdir(sort))


def _task_exchange(args) -> dict:
    """A rank of phase 15c's sharded_count on the phase-4 batch, run twice;
    the second run's all_to_all_single calls (the keys out, the counts
    back) timed with CUDA events on the card. Rank 0 returns digests of
    the result."""
    import hashlib

    import torch

    from fastk_tpu_torch.io.reader import batched_reads
    from fastk_tpu_torch.ops.histker import run_hist
    from fastk_tpu_torch.parallel import dist as pdist
    from fastk_tpu_torch.parallel.host import sharded_count

    mesh = pdist.make_mesh(device=args["device"])
    cuda = mesh.device.type == "cuda"
    (batch,) = [b for b, _ in batched_reads([args["fasta"]], 256 << 20)]
    real = pdist._exchange
    times = []

    def timed(m, send):
        if not cuda:
            return real(m, send)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        recv = real(m, send)
        b.record()
        times.append((a, b, send.numel() * send.element_size()))
        return recv

    pdist._exchange = timed
    try:
        for _ in range(2):
            times.clear()
            run_hist.launches = 0
            t0 = time.perf_counter()
            words, counts, hist, over, pos = sharded_count(
                batch.codes, K, mesh, want_positions=True)
            wall = time.perf_counter() - t0
    finally:
        pdist._exchange = real
    if cuda:
        torch.cuda.synchronize(mesh.device)
    res = dict(launches=run_hist.launches, wall_s=wall,
               exchanges=[(a.elapsed_time(b), nb) for a, b, nb in times])
    if mesh.rank == 0:
        res["digest"] = [hashlib.sha256(np.ascontiguousarray(x).tobytes())
                         .hexdigest() for x in (words, counts, hist, pos)]
        res["overflow"] = over
    return res


WORLD_TASKS = {"mesh_job": _task_mesh_job, "exchange": _task_exchange}
WORKER = [sys.executable, os.path.abspath(__file__)]


def _equal_size_chunks(fasta: str, d: str, nfiles: int) -> list:
    """`fasta` split by read into nfiles files of consecutive reads under
    d, each read named by its ordinal in six digits, so that the files
    (reads of one length) have one size."""
    with open(fasta, "rb") as f:
        seqs = f.read().split(b"\n")[1::2]
    paths = []
    for i in range(nfiles):
        lo, hi = i * len(seqs) // nfiles, (i + 1) * len(seqs) // nfiles
        p = os.path.join(d, f"chunk{i}.fasta")
        with open(p, "wb") as f:
            f.write(b"".join(b">r%06d\n%s\n" % (j, seqs[j])
                             for j in range(lo, hi)))
        paths.append(p)
    if len({os.path.getsize(p) for p in paths}) != 1:
        raise AssertionError("phase 15c: the chunks differ in size")
    return paths


def rank_major_paths(chunks: list, world: int) -> list:
    """The chunks arranged so that a world of `world` ranks reads them in
    their own order (count_files_mesh reads rank-major: each rank its
    shard_files share, in list order)."""
    from fastk_tpu_torch.parallel.multihost import shard_files

    if world == 1:
        return list(chunks)
    slots = [chunks.index(p) for r in range(world)
             for p in shard_files(chunks, r, world)]
    paths = [None] * len(chunks)
    for j, slot in enumerate(slots):
        paths[slot] = chunks[j]
    if [p for r in range(world)
            for p in shard_files(paths, r, world)] != chunks:
        raise AssertionError("phase 15c: no rank-major arrangement")
    return paths


def restream(slices: list, target: str, k: int, nparts: int) -> None:
    """The ranks' slice file-sets of one job (.ktab, .prof) written again
    as one file-set of `nparts` parts: the table through fastcat's
    streamed splice, the profiles decoded and encoded in read order."""
    from fastk_tpu_torch.formats.prof import (
        ProfileIndex,
        ProfWriter,
        encode_profiles_bulk,
    )
    from fastk_tpu_torch.tools.fastcat import cat_tables_streamed

    cat_tables_streamed(slices, target, nparts)
    idx = [ProfileIndex(s) for s in slices]
    total = sum(pi.nreads for pi in idx)
    with ProfWriter(target, k, total, nparts=min(nparts, max(1, total))) as pw:
        for pi in idx:
            profs = list(pi)
            if not profs:
                continue
            plen = np.array([len(p) for p in profs], np.int64)
            boff = np.concatenate([[0], np.cumsum(plen)[:-1]])
            blob, offs = encode_profiles_bulk(np.concatenate(profs), boff,
                                              plen)
            pw.add_block(blob, offs)


def multi_card_phase(tmp: str, fasta: str, fasta5: str, ooc_base: str,
                     n: int, device: str = "cuda", M: float = 1) -> int:
    """Phase 15c: the multi-device job at full size on n >= 2 cards.

    count_files_mesh -t3 -p at the CLI's -M plan on the phase-5 input, split
    by read into 8 files, in an NCCL world of n ranks and in a world of
    one (launch.run_world, as dryrun_multichip starts its ranks): each
    world's file-sets (the ranks' slices written again as one 4-part set)
    byte-identical to `ooc_base`, phase 10's; each world's wall, phases
    and each rank's device peak. Then sharded_count on the phase-4 batch
    at D = n, equal to count_batch, with the all_to_all_single exchange's
    ms a device step. Returns run_hist's launches over the ranks."""
    import hashlib

    import torch

    from fastk_tpu_torch.formats.hist import write_histogram
    from fastk_tpu_torch.io.reader import batched_reads
    from fastk_tpu_torch.ops.count import count_batch
    from fastk_tpu_torch.convert import device_codes
    from fastk_tpu_torch.parallel import launch
    from fastk_tpu_torch.pipeline.count import _pad_codes, _round_size
    from fastk_tpu_torch.tools import fastk as cli

    t15 = time.perf_counter()
    d15 = os.path.join(tmp, "p15")
    os.mkdir(d15)
    chunks = _equal_size_chunks(fasta5, d15, 8)
    est = sum(os.path.getsize(p) for p in chunks)
    dev = torch.device(device)
    _parts, part_cap = cli._ooc_plan(est, M, True, cli._device_budget(dev))
    launches = 0
    lines = []
    for world in sorted({n, 1}, reverse=True):
        wdir = os.path.join(d15, f"w{world}")
        os.mkdir(wdir)
        base = os.path.join(tmp, f"m15w{world}")
        kw = dict(table_min=3, profiles=True,
                  batch_bases=cli._batch_bases({"M": M}),
                  parts_per_chip=max(1, min(256, -(-est // (world
                                                          * part_cap)))),
                  part_cap=part_cap, out_nparts=4,
                  slice_positions=cli._slice_positions(
                      M, cli.MESH_SLICE_BYTES if world > 1
                      else cli.SLICE_BYTES))
        t0 = time.perf_counter()
        res = launch.run_world(
            WORKER, "mesh_job", world, wdir,
            dict(device=device, paths=rank_major_paths(chunks, world),
                 out_base=base if world == 1 else os.path.join(wdir, "m"),
                 kw=kw, pg_timeout_s=600), timeout=900, tag="mesh")
        outer = time.perf_counter() - t0
        if world > 1:
            restream([r["slice_base"] for r in res], base, K, 4)
            write_histogram(base, res[0]["hist"])
        if file_set(tmp, os.path.basename(base)) != file_set(tmp, ooc_base) \
                or any(r["spill_left"] for r in res):
            raise AssertionError(f"phase 15c: the world of {world}'s "
                                 "file-sets differ from phase 10's, or "
                                 "spills were left")
        launches += sum(r["launches"] for r in res)
        wall = max(r["wall_s"] for r in res)
        phases = [max(r["phase_s"][i] for r in res) for i in range(3)]
        peaks = [None if r["peak"] is None else round(r["peak"] / 1e9, 3)
                 for r in res]
        under = all((r["peak"] or 0) < M * 1e9 for r in res)
        lines.append(
            f"world {world}: count_files_mesh {wall:.2f} s (the slowest "
            f"rank; phases 1-3 {phases[0]:.2f}, {phases[1]:.2f}, "
            f"{phases[2]:.2f} s; by rank "
            f"{[[round(x, 2) for x in r['phase_s']] for r in res]}; "
            f"{outer:.2f} s with process start-up), {kw['parts_per_chip']} "
            f"parts a rank, slices of {kw['slice_positions']} positions, "
            f"max_memory_allocated by rank {peaks} GB ("
            f"{'all' if under else 'NOT all'} under the {M:g} GB of -M), "
            f"run_hist launches by rank {[r['launches'] for r in res]}, "
            f"escalations {[r['stats']['slack_escalations'] for r in res]}, "
            f"phase 3's profile exchange rounds by rank "
            f"{[r['stats']['profile_exchange_rounds'] for r in res]}, "
            f"the largest round's send and receive "
            f"{max(r['stats']['profile_exchange_peak_bytes'] for r in res)}"
            " B")
        for name in os.listdir(tmp):
            if name.startswith((f"m15w{world}.", f".m15w{world}.")):
                os.remove(os.path.join(tmp, name))
    print(f"phase 15c the mesh job -k40 -t3 -p at the -M{M:g} plan on the "
          f"phase-5 input in 8 files ({est} bytes), both worlds' file-sets "
          f"byte-identical to phase 10's: " + "; ".join(lines)
          + f" [{_smi()}]", flush=True)

    # the exchange of one device step at D = n on the phase-4 batch
    wdir = os.path.join(d15, "x")
    os.mkdir(wdir)
    res = launch.run_world(WORKER, "exchange", n, wdir,
                           dict(device=device, fasta=fasta),
                           timeout=900, tag="x")
    (batch,) = [b for b, _ in batched_reads([fasta], 256 << 20)]
    size = _round_size(len(batch.codes), K)
    cb = count_batch(device_codes(_pad_codes(batch, K, size), dev), K, size,
                     True, True)
    want_w, want_c = _valid_segments(cb)
    want = [hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()
            for x in (want_w, want_c.astype(np.int64),
                      cb["hist"].cpu().numpy(),
                      cb["pos_counts"].cpu().numpy().astype(np.int32)[
                          : len(batch.codes)])]
    if res[0]["digest"] != want or res[0]["overflow"] != int(cb["overflow"]):
        raise AssertionError(f"phase 15c: sharded_count at D = {n} differs "
                             "from count_batch")
    del cb
    launches += sum(r["launches"] for r in res)
    ex = [[(round(ms, 3), nb) for ms, nb in r["exchanges"]] for r in res]
    print(f"phase 15c sharded_count on the phase-4 batch at D = {n}, equal "
          f"to count_batch: all_to_all_single by rank (ms, bytes sent a "
          f"rank; the keys out, then the counts back; CUDA events, the "
          f"second of two runs) {ex}"
          f"; the step's host wall by rank "
          f"{[round(r['wall_s'], 3) for r in res]} s; run_hist launches by "
          f"rank {[r['launches'] for r in res]}; phase 15c "
          f"{time.perf_counter() - t15:.1f} s [{_smi()}]", flush=True)
    return launches


def _smi() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def ooc_line(r: dict) -> str:
    n, _, ms = r["largest"]
    return (f"phase 1 {r['phase1_s']:.2f} s ({r['batch_ms']:.1f} ms a batch; "
            f"slice dedup on the card median {r['slice_ms']:.3f} ms over "
            f"{r['slices']} slices; spill {r['spill_mb']:.0f} MB at "
            f"{r['spill_mb_s']:.0f} MB/s), phase 2 {r['phase2_s']:.2f} s "
            f"({r['merges']} merges, {r['back']} with want_back, "
            f"{r['merge_ms']:.1f} ms on the card in all, the largest "
            f"{n} records in {ms:.3f} ms; position spill {r['pos_mb']:.0f} "
            f"MB at {r['pos_mb_s']:.0f} MB/s), phase 3 {r['phase3_s']:.2f} s "
            f"(encode {r['encode_ms']:.1f} ms)")


def plan_of(log: str) -> tuple:
    """(planned parts, merges after consolidation, records of the largest
    group) from an out-of-core run's verbose lines."""
    parts = int(re.search(r"planning (\d+) parts", log).group(1))
    m = re.search(r"consolidated into (\d+) merges", log)
    groups = int(m.group(1)) if m else parts
    sizes = [int(x) for x in re.findall(
        r"part \d+/\d+(?: \(\+\d+\))?: (\d+) records", log)]
    return parts, groups, max(sizes)


def device_busy(path: str) -> tuple:
    """(busy share of the traced run, busy share between the first and the
    last device event, number of run_hist kernel events, the kernels that
    took the most device time) from a torch.profiler Chrome trace: the
    union of the device's kernel, copy and set intervals over the span of
    all timed events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "ts" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not dev:
        raise AssertionError(f"no device activity in {path}")
    busy, end = 0.0, -1.0
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = e.get("name", "")[:40]
            by_name[name] = by_name.get(name, 0.0) + float(e.get("dur", 0))
    top = ", ".join(f"{name} {us / 1e3:.3f} ms" for name, us in
                    sorted(by_name.items(), key=lambda x: -x[1])[:6])
    nhist = sum(1 for e in events if e.get("cat") == "kernel"
                and "run_hist_kernel" in e.get("name", ""))
    return (busy / (hi - lo), busy / (dev[-1][1] - dev[0][0]), nhist, top)


def _cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the card, each run timed with CUDA
    events after `warmup` untimed runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _graph_ms(fn, n: int = 20, reps: int = 7) -> float:
    """Median milliseconds of one fn() on the card: n calls captured in one
    CUDA graph, each replay timed with CUDA events and divided by n, so that
    the host's launch overhead stays out of the window."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return statistics.median(times)


# the H100 SXM's published memory rate and its float32 rate outside the
# tensor cores, for run_hist's bound
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12


def run_hist_bound(words, valid_end: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one run_hist call: the start
    words read once and the int64 histogram written once, against one
    operation a position."""
    nbytes = 4 * words.numel() + 8 * 32768
    t_bytes, t_ops = nbytes / HBM_BYTES_S, valid_end / SCALAR_OPS_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _host_ms(fn, reps: int = 3) -> float:
    """Median wall milliseconds of fn(), the card synchronised before and
    after each run."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


PROBE_SOURCE = "fastk_tpu_torch/csrc/probes.cu"
PROBE_VALUES = 1 << 26  # phase 16's histogram input
PROBE_BLOCKS = 1 << 14  # phase 16's carry, blocks of 1024
# the pallas_call sites each probe kernel replaces
PROBE_REPLACES = {
    "probe_hist": "benchmarks/_pallas_feas.py:42 (P1), "
                  "benchmarks/_pallas_feas2.py:53 (P5, P6), "
                  "benchmarks/_pallas_feas2.py:170 (P10), "
                  "benchmarks/_pallas_feas3.py:56 (P11), "
                  "benchmarks/_pallas_feas4.py:28 (P14-D)",
    "probe_loop": "benchmarks/_pallas_feas.py:70 (P2), "
                  "benchmarks/_pallas_feas2.py:111 (P8), "
                  "benchmarks/_pallas_feas3.py:84 (P12), "
                  "benchmarks/_pallas_feas4.py:28 (P14-A, B, C)",
    "probe_bits": "benchmarks/_pallas_feas.py:88 (P3), "
                  "benchmarks/_pallas_feas2.py:140 (P9), "
                  "benchmarks/_pallas_feas3.py:124 (P13), "
                  "benchmarks/_pallas_feas4.py:28 (P14-E)",
    "probe_carry": "benchmarks/_pallas_feas.py:113 (P4), "
                   "benchmarks/_pallas_feas2.py:88 (P7)",
}


def _bound(nbytes: int, ops: int) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes at the
    memory rate and the operations at the scalar rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / SCALAR_OPS_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# an untracked copy of the parent commit's probe kernels, timed in turns
# with this tree's in phase 16c when it is there (git archive <parent>
# fastk_tpu_torch/csrc/probes.cu | tar -x -C _archive/parent); _archive/
# is in .gitignore
PARENT_PROBES = "_archive/parent/fastk_tpu_torch/csrc/probes.cu"


def parent_probes():
    """The ctypes library of the parent's probe kernels (fk_probe_hist,
    fk_probe_loop, fk_probe_bits, fk_probe_carry), built by one nvcc from
    the untracked
    copy at PARENT_PROBES into _archive/parent_build/, or None when there
    is no copy."""
    import ctypes

    from fastk_tpu_torch import _kernels

    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, PARENT_PROBES)
    if not os.path.exists(src):
        return None
    out = os.path.join(here, "_archive", "parent_build")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "probes.so")
    r = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared",
                        "-o", so, src], capture_output=True, text=True,
                       timeout=600)
    if r.returncode:
        raise RuntimeError(f"phase 16c: nvcc failed on the parent's "
                           f"kernels:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, args in (("fk_probe_hist", [ptr, i64, i32, i32, ptr, ptr]),
                       ("fk_probe_loop", [ptr, i32, i32, ptr, i32, ptr, ptr]),
                       ("fk_probe_bits", [ptr, i64, i32, i32, ptr, ptr]),
                       ("fk_probe_carry", [ptr, i64, i64, ptr, ptr, ptr])):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return lib


def _busy_sm_mhz(fn) -> float:
    """clocks.sm in MHz as nvidia-smi reads it while the card runs fn()
    over and over, until nvidia-smi has answered."""
    import torch

    p = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         stdout=subprocess.PIPE, text=True)
    try:
        while p.poll() is None:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
        out = p.communicate(timeout=60)[0]
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    return float(out.split()[0])


# the lanes an H100 SM issues a clock: loads, and int32 arithmetic
SM_LOAD_LANES = 32
SM_INT32_LANES = 64


def loop_bound(steps: int, mode: str, sms: int, sm_mhz: float) -> tuple:
    """(bound ms, "operations") of probe_loop over `steps` steps: the larger
    of the steps' loads (none in index mode) at sms x SM_LOAD_LANES a clock
    and their int32 adds at sms x SM_INT32_LANES, at sm_mhz."""
    hz = sm_mhz * 1e6
    loads = 0 if mode == "index" else steps
    return (1e3 * max(loads / (sms * SM_LOAD_LANES * hz),
                      steps / (sms * SM_INT32_LANES * hz)), "operations")


def _constant(name: str) -> int:
    """A constexpr int of PROBE_SOURCE."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, PROBE_SOURCE)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    return int(m.group(1))


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_BRA = re.compile(r"\bBRA\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def loop_sass(so: str) -> dict:
    """{mode: [(LDG, LDS, IADD3) of each loop]} of the probe_loop_kernel
    instances in the library `so`, read from cuobjdump -sass: a loop is the
    instructions from a backward branch's target to the branch."""
    from fastk_tpu_torch import _kernels
    from fastk_tpu_torch.ops import probes as ops

    dump = subprocess.run(
        [os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump"),
         "-sass", so], capture_output=True, text=True, check=True,
        timeout=300).stdout
    out = {}
    for part in dump.split("Function : ")[1:]:
        m = re.match(r"\S*probe_loop_kernelILi(\d)E", part)
        if not m:
            continue
        insns, labels, pending = [], {}, []
        for line in part.splitlines():
            lab = _SASS_LABEL.match(line)
            if lab:
                pending.append(lab.group(1))
                continue
            ins = _SASS_INSN.search(line)
            if ins:
                addr = int(ins.group(1), 16)
                labels.update((p, addr) for p in pending)
                pending = []
                insns.append((addr, ins.group(2)))
        loops = []
        for addr, text in insns:
            bra = _SASS_BRA.search(text)
            if not bra:
                continue
            tgt = bra.group(1)
            tgt = labels.get(tgt) if tgt.startswith(".") else int(tgt, 16)
            if tgt is None or tgt >= addr:
                continue
            names = [t.split()[1] if t.startswith("@") else t.split()[0]
                     for a, t in insns if tgt <= a <= addr]
            loops.append(tuple(sum(o.startswith(k) for o in names)
                               for k in ("LDG", "LDS", "IADD3")))
        out[ops.LOOP_MODES[int(m.group(1))]] = loops
    return out


def probes_phase(words_np: np.ndarray) -> list:
    """Phase 16: the probe kernels (csrc/probes.cu).

    a. `python -m fastk_tpu_torch.probes` in process on the card, every
       probe line OK, with each kernel's launches counted from 0;
    b. each kernel against its plain version on the card, at the probes'
       shapes and at the main path's scale: 2^26 values into 32768 bins (add
       and store mode), the walk and clz over `words_np` (the start words of
       the phase-4 batch, 2^21 words), the pack of their 2^26 mask bits, a
       carry over 2^14 blocks of 1024, and the loop at 1M and 2^30 steps in
       each mode (and at 2^31 - 1 in index mode, on a 4 x 1024 table, and
       with trips below 0). Also the 16-byte loads' edges: views off a
       16-byte boundary, a tail, and uint8 bytes 0-255 viewed as a bool mask
       (held against the plain pack of bytes != 0); and the carry at every
       shape its tiles meet: 1-D, one row of 2^26, 2^26 rows of one value,
       rows of 3 and 1000 from a view off a 16-byte boundary, [0, k], [k,
       0], and values near +-2^31. The loop's SASS (loop_sass) holds
       kLoopUnroll loads a pass in each load mode and kLoopUnroll IADD3s in
       index mode;
    c. each kernel's time at that scale (a launch in a CUDA graph), its
       bound, its plain version's time and, for the histogram,
       torch.bincount's; store mode's time beside its bound, its plain
       version and scatter_reduce_(..., "amax"); clz on the start words and
       on 2^26 random words beside its bound; the loop in each mode at 1M
       and 2^30 steps, its rate beside its bound (loop_bound, at the SM
       clock nvidia-smi reads while it runs); the histogram also at 4096
       bins and on 2^21 values (its flush), and the time torch.amax takes
       to read the histogram's and the pack's input once. With a copy of
       the parent's kernels at PARENT_PROBES, the parent's histogram (add
       and store), loop (1M steps), pack, walk and carry in turns with this
       tree's on the same tensors (parent, new, new, parent). The carry at
       its three shapes (2^14 rows of 1024, one row of 2^26, 2^26 rows of
       one value), each beside its bound, its plain version and the library
       calls of the same function, and torch.amax's read of the row shape's
       64 MiB.

    Returns the kernels line's entries of the four kernels."""
    import torch

    from fastk_tpu_torch import probes
    from fastk_tpu_torch.ops import probes as ops

    dev = torch.device("cuda")
    t16 = time.perf_counter()
    # a. the probes, the path of this slice
    for k in ops.KERNELS:
        k.launches = 0
    results = probes.main("cuda")
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    bad = [r for r in results if not r[1]]
    if len(results) != 19 or bad or min(launches.values()) < 1:
        raise AssertionError(f"phase 16a: {len(results)} probes, failed "
                             f"{bad}, launches {launches}")

    # b. each kernel against its plain version on the same card tensors
    g = torch.Generator(device=dev)
    g.manual_seed(16)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ones = torch.ones((8, 128), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(0)
    big_vals = torch.randint(0, 32768, (PROBE_VALUES,), generator=g,
                             device=dev, dtype=torch.int32)
    words = t(words_np)
    shifts = torch.arange(32, device=dev)
    mask = ((words.long().unsqueeze(1) >> shifts) & 1).bool().reshape(-1)
    blocks = torch.randint(-1000, 1000, (PROBE_BLOCKS, 1024), generator=g,
                           device=dev, dtype=torch.int32)
    wide = torch.randint(-(1 << 31), (1 << 31) - 1, (PROBE_VALUES,),
                         generator=g, device=dev, dtype=torch.int32)
    near = torch.where(
        torch.randint(0, 2, (1 << 12, 1000), generator=g, device=dev) == 1,
        (1 << 31) - 1 - torch.randint(0, 8, (1 << 12, 1000), generator=g,
                                      device=dev),
        -(1 << 31) + torch.randint(0, 8, (1 << 12, 1000), generator=g,
                                   device=dev)).to(torch.int32)
    trips_1m = torch.tensor([1_000_000], dtype=torch.int32, device=dev)
    u8 = torch.randint(0, 256, (1 << 20,), generator=g, device=dev,
                       dtype=torch.uint8)
    cases = {
        "probe_hist": [
            ("P1", (t(rng.integers(0, 16, 1024, np.int32)), 16)),
            ("P5", (t(np.random.default_rng(0).integers(
                0, 4096, 1024, np.int32)), 4096)),
            ("P6", (t(np.random.default_rng(0).integers(
                0, 32768, 1024, np.int32)), 32768)),
            ("P10", (t(np.random.default_rng(2).permutation(128)[:16]
                       .astype(np.int32)), 128, True)),
            ("P14-D", (torch.arange(1000, dtype=torch.int32, device=dev)
                       & 1023, 1024)),
            ("the large size, into 32768 bins", (big_vals, 32768)),
            ("an unaligned view with a tail",
             (big_vals[3:(1 << 24) + 2], 32768)),
            ("store, the large size", (big_vals, 32768, True)),
            ("store, an unaligned view with a tail",
             (big_vals[3:(1 << 24) + 2], 32768, True))],
        "probe_loop": [
            ("P2", (t(np.full((1, 1), 37, np.int32)),
                    t(np.full(1, 37, np.int32)), "index")),
            ("P14-A", (ones, t(np.array([1000], np.int32)), "static")),
            ("P14-B", (ones, t(np.array([1000], np.int32)), "global")),
            ("P14-C", (ones, t(np.array([1000], np.int32)), "shared"))]
        + [(f"1M {m}", (t(rng.integers(-9, 9, (8, 128), np.int32)),
                        trips_1m, m)) for m in ops.LOOP_MODES],
        "probe_bits": [
            ("P3", (t(np.full((1, 1), 1 << 20, np.int32)), "clz")),
            ("P9", (t(np.random.default_rng(1).integers(0, 2, 1024)
                      .astype(bool)), "pack", 16)),
            ("P13", (t(np.random.default_rng(3).integers(
                0, 1 << 16, 1024, dtype=np.int32)), "walk")),
            ("P14-E", (torch.arange(100, dtype=torch.int32, device=dev) | 1,
                       "walk")),
            ("the start words, walk", (words, "walk")),
            ("the start words, clz", (words, "clz")),
            ("the start words' mask, pack", (mask, "pack", 32)),
            ("the start words from the second, clz", (words[1:], "clz")),
            ("the start words from the second, walk", (words[1:], "walk")),
            ("the mask from byte 5", (mask[5:5 + (1 << 20)], "pack", 32)),
            ("a tail at width 16", (mask[:(1 << 20) + 16], "pack", 16)),
            ("uint8 bytes viewed as bool", (u8.view(torch.bool), "pack", 32),
             (u8 != 0, "pack", 32))],
        "probe_carry": [
            ("P4", (torch.arange(4096, dtype=torch.int32,
                                 device=dev).reshape(4, 8, 128),)),
            ("P7", (torch.arange(4096, dtype=torch.int32,
                                 device=dev).reshape(4, 1024),)),
            ("the large size", (blocks,)),
            ("a 1-D x, the start words", (words,)),
            ("one row of 2^26", (wide.reshape(1, -1),)),
            ("2^26 rows of one value", (wide.reshape(-1, 1),)),
            ("rows of 3 from value 1", (wide[1:1 + 3 * (1 << 22)]
                                        .reshape(-1, 3),)),
            ("rows of 1000 from value 3", (wide[3:3 + 1000 * 4096]
                                           .reshape(-1, 1000),)),
            ("[0, 1024]", (blocks[:0],)),
            ("[1024, 0]", (wide[:0].reshape(1024, 0),)),
            ("values near +-2^31", (near,))],
    }
    tables = {m: args[0] for (label, args), m in zip(
        cases["probe_loop"][4:], ops.LOOP_MODES)}
    trips_2p30 = torch.tensor([1 << 30], dtype=torch.int32, device=dev)
    narrow = t(rng.integers(-9, 9, (4, 1024), np.int32))
    cases["probe_loop"] += [
        (f"2^30 {m}", (tables[m], trips_2p30, m)) for m in ops.LOOP_MODES] + [
        ("index, 2^31 - 1", (tables["index"], t(np.array([(1 << 31) - 1],
                                                         np.int32)), "index")),
        ("global, 4 x 1024, 2^30", (narrow, trips_2p30, "global")),
        ("shared, 4 x 1024, 2^30", (narrow, trips_2p30, "shared")),
        ("global, trips -5", (tables["global"], t(np.array([-5], np.int32)),
                              "global"))]
    fns = {k.__name__: k for k in ops.KERNELS}
    refs = {name: getattr(ops, name + "_ref") for name in fns}
    errs = {}
    for name, lst in cases.items():
        errs[name] = 0
        for label, args, *plain in lst:
            got, want = fns[name](*args), refs[name](*(plain or [args])[0])
            torch.cuda.synchronize()
            if got.shape != want.shape or got.device != want.device:
                raise AssertionError(f"phase 16b: {name} on {label}: shape "
                                     f"{tuple(got.shape)} on {got.device}, "
                                     f"plain {tuple(want.shape)}")
            err = (int((got.long() - want.long()).abs().max())
                   if got.numel() else 0)
            errs[name] = max(errs[name], err)
            if err:
                raise AssertionError(f"phase 16b: {name} differs from its "
                                     f"plain version on {label}: max abs "
                                     f"err {err}")
    if not torch.equal(ops.probe_bits(mask, "pack", 32), words):
        raise AssertionError("phase 16b: the pack of the start words' mask "
                             "is not the start words")
    # a load a step: each unrolled loop of the loop's instances, in SASS
    from fastk_tpu_torch import _kernels

    unroll = _constant("kLoopUnroll")
    sass = loop_sass(_kernels.build())
    for m, col in (("index", 2), ("static", 0), ("global", 0),
                   ("shared", 1)):
        if max((loop[col] for loop in sass.get(m, [])), default=0) < unroll:
            raise AssertionError(f"phase 16b: probe_loop's {m} instance has "
                                 f"no loop of {unroll} "
                                 f"{('LDG', 'LDS', 'IADD3')[col]}s in its "
                                 f"SASS (loops: {sass.get(m)})")

    # c. times at the main path's scale
    nset = int(mask.sum())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the SM clock under the loop, for its bound
    sm_mhz = _busy_sm_mhz(lambda: ops.probe_loop(tables["global"],
                                                 trips_2p30, "global"))
    scale = {
        "probe_hist": ((big_vals, 32768),
                       _bound(4 * PROBE_VALUES + 4 * 32768, PROBE_VALUES),
                       f"2^{PROBE_VALUES.bit_length() - 1} int32 values into "
                       "32768 bins"),
        "probe_loop": ((tables["global"], trips_2p30, "global"),
                       loop_bound(1 << 30, "global", sms, sm_mhz),
                       "2^30 steps from device memory, over the card"),
        "probe_bits": ((mask, "pack", 32),
                       _bound(mask.numel() + mask.numel() // 8, mask.numel()),
                       f"pack of {mask.numel()} mask bits into "
                       f"{words.numel()} words"),
        "probe_carry": ((blocks,),
                        _bound(4 * blocks.numel() + 4 * PROBE_BLOCKS,
                               blocks.numel()),
                        f"{PROBE_BLOCKS} blocks of 1024 int32"),
    }
    entries = []
    lines = []
    for name, (args, (bound_ms, bound_by), what) in scale.items():
        ms = _graph_ms(lambda: fns[name](*args))
        plain_ms = _cuda_ms(lambda: refs[name](*args))
        library_ms = (_cuda_ms(lambda: torch.bincount(big_vals,
                                                      minlength=32768))
                      if name == "probe_hist" else None)
        entries.append(dict(
            name=name, route="cuda", source=PROBE_SOURCE,
            replaces=PROBE_REPLACES[name], launches=launches[name],
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            at=what))
        lines.append(f"{name} {ms:.4f} ms ({what}; bound {bound_ms:.4f} ms "
                     f"by {bound_by}, {100 * bound_ms / ms:.1f} %; plain "
                     f"{plain_ms:.4f} ms"
                     + (f"; torch.bincount {library_ms:.4f} ms"
                        if library_ms is not None else "") + ")")
    walk_ms = _graph_ms(lambda: ops.probe_bits(words, "walk"))
    walk_bound, walk_by = _bound(4 * words.numel() + 8, nset)
    # store mode at 2^26 values, beside one library call of the same function
    amax_idx = big_vals.long()
    amax_src = torch.arange(PROBE_VALUES, dtype=torch.int64, device=dev)
    amax_out = torch.zeros(32768, dtype=torch.int64, device=dev)
    store_bound, store_by = _bound(4 * PROBE_VALUES + 4 * 32768, PROBE_VALUES)
    store = dict(
        ms=_graph_ms(lambda: ops.probe_hist(big_vals, 32768, True)),
        bound_ms=store_bound, bound_by=store_by,
        plain_ms=_cuda_ms(lambda: ops.probe_hist_ref(big_vals, 32768, True)),
        library_ms=_cuda_ms(lambda: amax_out.scatter_reduce_(
            0, amax_idx, amax_src, "amax")),
        library_call='scatter_reduce_(0, idx, src, "amax"), int64')
    del amax_idx, amax_src
    # clz: 4 B read and 4 B written a word
    clz = {}
    for label, w in (("the 2^21 start words", words),
                     ("2^26 random words", wide)):
        ms = _graph_ms(lambda: ops.probe_bits(w, "clz"))
        b, by = _bound(8 * w.numel(), w.numel())
        clz[label] = dict(ms=ms, bound_ms=b, bound_by=by, share=b / ms)
    clz["the 2^21 start words"]["plain_ms"] = _cuda_ms(
        lambda: ops.probe_bits_ref(words, "clz"))
    # the loop's rate over the card, each mode at 1M and 2^30 steps, and
    # on a table narrower than its unroll (each step's own address)
    loop_at = {}
    for label, trips, steps, tabs in (
            ("1M", trips_1m, 1_000_000, tables),
            ("2^30", trips_2p30, 1 << 30, tables),
            ("2^30, 4 x 1024", trips_2p30, 1 << 30,
             {"global": narrow, "shared": narrow})):
        for m, tab in tabs.items():
            ms = _graph_ms(lambda: ops.probe_loop(tab, trips, m))
            b, _ = loop_bound(steps, m, sms, sm_mhz)
            loop_at[f"{m}, {label}"] = dict(
                ms=ms, ns_per_step=ms * 1e6 / steps,
                steps_per_s=steps / (ms * 1e-3), bound_ms=b, share=b / ms)
    # the histogram's other shapes (their times are the turns' below), and
    # one read of each input by torch
    vals_4096 = big_vals & 4095
    flush_vals = big_vals[:1 << 21]
    hist_bounds = {
        "hist, 4096 bins": _bound(4 * PROBE_VALUES + 4 * 4096,
                                  PROBE_VALUES)[0],
        "hist, 2^21 values": _bound(4 * flush_vals.numel() + 4 * 32768,
                                    flush_vals.numel())[0]}
    mask_u8 = mask.view(torch.uint8)
    read_ms = {"probe_hist": _graph_ms(lambda: torch.amax(big_vals)),
               "probe_bits": _graph_ms(lambda: torch.amax(mask_u8)),
               "probe_carry": _graph_ms(lambda: torch.amax(blocks))}
    # the parent's kernels against this tree's, in turns
    from fastk_tpu_torch import _kernels

    def stream():  # the stream a CUDA graph captures, at call time
        return torch.cuda.current_stream().cuda_stream

    def p_call(fn, x, a, b, out):
        _kernels.check(fn(x.data_ptr(), x.numel(), a, b, out.data_ptr(),
                          stream()), "the parent's probe kernel")
        return out

    def p_hist(x, nbins, store=0):
        return lambda lib: p_call(lib.fk_probe_hist, x, nbins, store,
                                  torch.empty(nbins, dtype=torch.int32,
                                              device=dev))

    loop_out = torch.empty(1, dtype=torch.int32, device=dev)

    def p_loop(lib):
        """The parent's one-thread loop, 1M steps from device memory."""
        _kernels.check(lib.fk_probe_loop(
            tables["global"].data_ptr(), 8, 128, trips_1m.data_ptr(), 2,
            loop_out.data_ptr(), stream()), "the parent's loop")
        return loop_out

    def p_carry(x):
        """lib -> the parent's carry of x, with its own scratch: a status
        word a row and the ticket."""
        nb = x.shape[0]
        scratch = torch.empty(nb + 1, dtype=torch.int64, device=dev)
        out = torch.empty(nb, dtype=torch.int32, device=dev)

        def run(lib):
            _kernels.check(lib.fk_probe_carry(
                x.data_ptr(), nb, x.numel() // nb, scratch.data_ptr(),
                out.data_ptr(), stream()), "the parent's carry")
            return out
        return run

    parent = parent_probes()
    pairs = {
        "hist, 32768 bins": (p_hist(big_vals, 32768),
                             lambda: ops.probe_hist(big_vals, 32768)),
        "hist store, 32768 bins": (p_hist(big_vals, 32768, 1),
                                   lambda: ops.probe_hist(big_vals, 32768,
                                                          True)),
        "loop, 1M from device memory": (
            p_loop, lambda: ops.probe_loop(tables["global"], trips_1m,
                                           "global")),
        "hist, 4096 bins": (p_hist(vals_4096, 4096),
                            lambda: ops.probe_hist(vals_4096, 4096)),
        "hist, 2^21 values": (p_hist(flush_vals, 32768),
                              lambda: ops.probe_hist(flush_vals, 32768)),
        "pack": (lambda lib: p_call(lib.fk_probe_bits, mask, 2, 32,
                                    torch.empty(words.numel(),
                                                dtype=torch.int32,
                                                device=dev)),
                 lambda: ops.probe_bits(mask, "pack", 32)),
        "walk": (lambda lib: p_call(lib.fk_probe_bits, words, 1, 32,
                                    torch.empty(1, dtype=torch.int64,
                                                device=dev)),
                 lambda: ops.probe_bits(words, "walk")),
        "carry, 2^14 rows of 1024": (p_carry(blocks),
                                     lambda: ops.probe_carry(blocks))}
    turns = {}
    for label, (p_fn, new_fn) in pairs.items():
        order = [("new", new_fn)]
        if parent is not None:
            got, want = p_fn(parent), new_fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"phase 16c: the parent's {label} "
                                     "differs from this tree's")
            order.insert(0, ("parent", lambda: p_fn(parent)))
        t = {}
        n = 2 if label.startswith("loop") else 20  # the parent's 8.8 ms
        for v, fn in order + order[::-1]:  # parent, new, new, parent
            t.setdefault(v, []).append(_graph_ms(fn, n=n))
        turns[label] = t
    # the carry at its three shapes, beside its bound, its plain version
    # and the library calls of the same function
    carry_at = {
        "2^14 rows of 1024": (blocks, {
            "x.sum(1) + torch.cumsum (two calls)":
                lambda x: torch.cumsum(x.sum(1), 0),
            "torch.sum (P7's total)": torch.sum}),
        "one row of 2^26": (wide.reshape(1, -1), {"torch.sum": torch.sum}),
        "2^26 rows of one value": (wide.reshape(-1, 1), {
            "torch.cumsum(x, 0, dtype=torch.int32)":
                lambda x: torch.cumsum(x.reshape(-1), 0,
                                       dtype=torch.int32)})}
    carry = {}
    for label, (x, libcalls) in carry_at.items():
        ms = _graph_ms(lambda: ops.probe_carry(x))
        bound_ms, bound_by = _bound(4 * x.numel() + 4 * x.shape[0],
                                    x.numel())
        carry[label] = dict(
            ms=ms, bound_ms=bound_ms, bound_by=bound_by,
            share=bound_ms / ms,
            plain_ms=_cuda_ms(lambda: ops.probe_carry_ref(x)),
            library_ms={k: _graph_ms(lambda: f(x))
                        for k, f in libcalls.items()})
    entries[1].update(sm_mhz=sm_mhz, sms=sms, rates=loop_at,
                      threads=ops.loop_threads(tables["global"], "global"))
    entries[2]["walk_ms"] = walk_ms
    entries[2]["walk_bound_ms"] = walk_bound
    entries[0]["more_bound_ms"] = hist_bounds
    for e in entries:
        if e["name"] in read_ms:
            e["read_ms"] = read_ms[e["name"]]
    entries[0]["store"] = store
    entries[0]["turns"] = {k: v for k, v in turns.items() if "hist" in k}
    entries[1]["turns"] = {k: v for k, v in turns.items() if "loop" in k}
    entries[2]["clz"] = clz
    entries[2]["turns"] = {k: turns[k] for k in ("pack", "walk")}
    entries[3]["turns"] = {k: v for k, v in turns.items() if "carry" in k}
    entries[3]["shapes"] = carry
    entries[3]["library_ms"] = carry["2^14 rows of 1024"]["library_ms"][
        "x.sum(1) + torch.cumsum (two calls)"]
    entries[3]["library_call"] = "x.sum(1) then torch.cumsum, two calls"
    print(f"phase 16a probes: {len(results)} probe lines OK on the card "
          f"(python -m fastk_tpu_torch.probes); launches {launches}",
          flush=True)
    print(f"phase 16b kernels vs plain on the card: "
          + ", ".join(f"{n} {len(c)} cases (max abs err {errs[n]})"
                      for n, c in cases.items())
          + "; the pack of the phase-4 start words' mask equals "
          "those words", flush=True)
    print(f"phase 16c times (median of 7, a launch in a CUDA graph): "
          + "; ".join(lines)
          + f"; probe_bits walk over the {words.numel()} start words ({nset} "
          f"set bits) "
          f"{walk_ms:.4f} ms, bound {walk_bound:.4f} ms by {walk_by}; "
          f"store mode {store['ms']:.4f} ms (bound {store_bound:.4f} ms by "
          f"{store_by}, {100 * store_bound / store['ms']:.1f} %; plain "
          f"{store['plain_ms']:.4f} ms; scatter_reduce_ amax "
          f"{store['library_ms']:.4f} ms); clz "
          + ", ".join(f"{k} {c['ms']:.4f} ms (bound {c['bound_ms']:.4f} ms "
                      f"by {c['bound_by']}, {100 * c['share']:.1f} %)"
                      for k, c in clz.items())
          + f" (plain on the start words "
          f"{clz['the 2^21 start words']['plain_ms']:.4f} ms)"
          + "; probe_" + ", ".join(
              f"{k} {turns[k]['new'][0]:.4f} ms (bound {b:.4f} ms, "
              f"{100 * b / turns[k]['new'][0]:.1f} %)"
              for k, b in hist_bounds.items())
          + "; one read by torch.amax: "
          + ", ".join(f"{k}'s input {v:.4f} ms" for k, v in read_ms.items()),
          flush=True)
    print(f"phase 16c the loop over the card ({entries[1]['threads']} "
          f"threads; bound at {sm_mhz:.0f} MHz on {sms} SMs): " + "; ".join(
              f"{k} {c['ms']:.4f} ms, {c['ns_per_step']:.6f} ns a step, "
              f"{c['steps_per_s']:.4g} steps/s (bound {c['bound_ms']:.6f} "
              f"ms, {100 * c['share']:.1f} %)" for k, c in loop_at.items()),
          flush=True)
    print("phase 16c the carry (a launch in a CUDA graph): " + "; ".join(
        f"{label} {c['ms']:.4f} ms (bound {c['bound_ms']:.4f} ms by "
        f"{c['bound_by']}, {100 * c['share']:.1f} %; plain "
        f"{c['plain_ms']:.4f} ms; "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in c["library_ms"].items())
        + ")" for label, c in carry.items()), flush=True)
    print("phase 16c in turns (ms; the parent timed before and after "
          "this tree's kernel): "
          + "; ".join(f"{k}: " + ", ".join(
              f"{v} {x[0]:.4f} / {x[1]:.4f}" for v, x in t.items())
              for k, t in turns.items())
          + ("" if parent is not None else
             f"; the parent not timed: no copy of its kernels at "
             f"{PARENT_PROBES}")
          + f"; phase 16 {time.perf_counter() - t16:.1f} s [{_smi()}]",
          flush=True)
    return entries


RSS_SIZES = (80, 240)  # MB of bases, benchmarks/bench_rss.py's defaults


def host_memory_phase(tmp: str) -> int:
    """Phase 17: the -M host-memory bound on the card
    (``fastk_tpu_torch/probes/rss.py``, the port's bench_rss.py).

    a. the CLI out of core, -k40 -t1 -v -M1, and
    b. count_files_mesh in a world of one at the -M1 plan (-t1 -p),
    each in a fresh process on random bases at RSS_SIZES, a and b side by
    side on one input a size (their walls share the host), with the outputs
    and spills of each in a temp dir deleted after the run.
    Prints each run's peak RSS, its peak above the runtime floor (set
    beside -M1's 1000 MB, not gated), the device peak, the pinned-host
    cache's peak, run_hist's launches and the wall; then the JAX script's
    flatness line for a and b. Fails on a FAIL verdict, on a run that
    peaked no higher than the floor, when a ran in core, or when b launched
    no run_hist kernel (rss.run_one_mesh raises).
    Returns b's run_hist launches."""
    import shutil

    from fastk_tpu_torch.probes import rss

    t17 = time.perf_counter()
    d17 = os.path.join(tmp, "rss17")
    os.mkdir(d17)
    df = subprocess.run(["df", "-h", d17], capture_output=True, text=True,
                        timeout=60).stdout.strip()
    print(f"phase 17 disk of its temp dir:\n{df}", flush=True)
    floor = rss.runtime_rss("cuda")
    runs = {"17a": [], "17b": []}
    what = {"17a": "the CLI out of core at -M1",
            "17b": "count_files_mesh, world one, at the -M1 plan"}
    fasta = os.path.join(d17, "in.fasta")

    def run(label: str) -> dict:
        work = tempfile.mkdtemp(prefix=label, dir=d17)
        try:
            return (rss.run_one if label == "17a" else rss.run_one_mesh)(
                fasta, work, K, "cuda")
        finally:
            shutil.rmtree(work)

    for mb in RSS_SIZES:
        rss.make_fasta(fasta, mb << 20)
        # a and b side by side, each its own process (its own peaks)
        with ThreadPoolExecutor(2) as pool:
            both = list(pool.map(run, runs))
        for label, res in zip(runs, both):
            res["label"] = f"{mb}MB"
            res["above_runtime_mb"] = res["peak_rss_mb"] - floor
            runs[label].append(res)
            print(f"phase {label} {what[label]} on {mb} MB "
                  f"({res['input_bases']} bytes): peak RSS "
                  f"{res['peak_rss_mb']} MB, {res['above_runtime_mb']} MB "
                  f"above the runtime's {floor} MB (-M1: 1000 MB); device "
                  f"peak {res['device_peak_bytes'] / 1e9:.3f} GB; pinned "
                  f"host cache peak {res['pinned_peak_bytes'] / 1e6:.1f} MB "
                  f"(at the end {res['pinned_current_bytes'] / 1e6:.1f} "
                  "MB); run_hist launches "
                  f"{res['run_hist_launches']}"
                  + ("" if label == "17b" else
                     f"; out of core {res['out_of_core']}")
                  + f"; {res['wall_s']:.2f} s", flush=True)
        os.remove(fasta)
    verdicts = {}
    for label, res in runs.items():
        v = rss.flatness(res, list(RSS_SIZES))
        v.update(phase=label, runtime_rss_mb=floor, device="cuda")
        verdicts[label] = v
        print(json.dumps(v), flush=True)
    launches = sum(r["run_hist_launches"] for r in runs["17b"])
    print(f"phase 17 {time.perf_counter() - t17:.1f} s [{_smi()}]",
          flush=True)
    failed = [k for k, v in verdicts.items() if v["verdict"] != "PASS"]
    if failed:
        raise AssertionError(f"phase 17: flatness FAIL in {failed}")
    if min(r["above_runtime_mb"] for rs in runs.values() for r in rs) <= 0:
        raise AssertionError("phase 17: a run peaked no higher than the "
                             "runtime floor: its ru_maxrss was not its own")
    if not all(r["out_of_core"] for r in runs["17a"]):
        raise AssertionError("phase 17a: the -M1 plan kept the CLI in core")
    return launches


BENCH_SIZES = (1 << 24, 1 << 26)  # bench.py's default batch; phase 4's
BENCH_TIMEOUT_S = 600


def bench_phase() -> int:
    """Phase 18: the port's headline bench (``fastk_tpu_torch/bench.py``,
    the counterpart of bench.py) and its probes on the card.

    a. in process, on the bench's batch at 2^24: three headline steps, each
       one run_hist launch, the histogram equal to the same step's with
       run_hist_ref (exact) and nvalid to the reads' windows; the fused
       step's nvalid, nseg and pos_counts equal to the CPU port's on the
       same batch; sort_counted's device sort of 2^21 rows of three words
       equal to numpy's order;
    b. ``python -m fastk_tpu_torch.bench`` in a subprocess at each of
       BENCH_SIZES (FASTK_BENCH_SIZE), its lines printed: the fused line,
       the step's syncs and waits, the headline last, which must parse with
       value > 0, at least 3 trials and this card's name; one run_hist
       launch a headline step;
    c. ``probes.profiles`` (2^24) and ``probes.stages`` (2^26), in process.
    Returns the run_hist launches of a, b and c."""
    import torch

    from fastk_tpu_torch import bench
    from fastk_tpu_torch.ops.histker import (
        hist_device_part,
        run_hist,
        run_hist_ref,
    )
    from fastk_tpu_torch.ops.pack import upload_packed
    from fastk_tpu_torch.ops.tables import sort_counted
    from fastk_tpu_torch.probes import profiles, stages

    t18 = time.perf_counter()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    kind = torch.cuda.get_device_name(0)

    # 18a
    size = BENCH_SIZES[0]
    pw, exc, total, nreads = bench.bench_input(
        size, max(1 << 16, size // 33), bench.READ_LEN)
    nvalid_expect = nreads * (bench.READ_LEN - K + 1)
    run_hist.launches = 0
    for i in range(3):
        before = run_hist.launches
        hist, nvalid = bench.headline_step(pw, exc, total, size, dev)
        if run_hist.launches != before + 1:
            raise AssertionError(f"phase 18a: step {i} made "
                                 f"{run_hist.launches - before} launches")
    launches_a = run_hist.launches
    sw, valid_end = hist_device_part(upload_packed(pw, exc, total, dev), K,
                                     size)
    want, _ = run_hist_ref(sw, valid_end)
    if not torch.equal(hist, want) or not (
            nvalid == valid_end == nvalid_expect):
        raise AssertionError(f"phase 18a: the headline step's histogram "
                             f"differs from run_hist_ref's, or nvalid "
                             f"{nvalid} != {valid_end} != {nvalid_expect}")
    del sw, want
    got = bench.fused_step(pw, exc, total, size, dev)
    t0 = time.perf_counter()
    ref = bench.fused_step(pw, exc, total, size, cpu)
    cpu_s = time.perf_counter() - t0
    if (not int(got[0]) == int(ref[0]) == nvalid_expect
            or int(got[1]) != int(ref[1])
            or not torch.equal(got[2].cpu(), ref[2])):
        raise AssertionError("phase 18a: the fused step on the card differs "
                             "from the CPU port's")
    rng = np.random.default_rng(18)
    w = rng.integers(0, 1 << 32, (1 << 21, 3), dtype=np.int64
                     ).astype(np.uint32)
    c = rng.integers(1, 1 << 15, 1 << 21).astype(np.uint16)
    sw_, sc_ = sort_counted(w, c, device="cuda")
    order = np.argsort(np.ascontiguousarray(w.astype(">u4")).view("S12")
                       .ravel(), kind="stable")
    if not (np.array_equal(sw_, w[order]) and np.array_equal(sc_, c[order])):
        raise AssertionError("phase 18a: sort_counted on the card differs "
                             "from numpy's order")
    print(f"phase 18a the bench's batch at 2^{size.bit_length() - 1} "
          f"({nreads} reads of "
          f"{bench.READ_LEN}): 3 headline steps, {launches_a} run_hist "
          f"launches, the histogram equal to run_hist_ref's, nvalid "
          f"{nvalid}; the fused step equal to the CPU port's (nvalid, "
          f"nseg {int(got[1])}, pos_counts; the CPU's step {cpu_s:.2f} s); "
          f"sort_counted of 2^21 rows on the card equal to numpy's order",
          flush=True)
    del got, ref, hist
    torch.cuda.empty_cache()

    # 18b
    launches_b = 0
    here = os.path.dirname(os.path.abspath(__file__))
    for size in BENCH_SIZES:
        env = dict(os.environ, FASTK_BENCH_SIZE=str(size))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "fastk_tpu_torch.bench"],
                           cwd=here, env=env, capture_output=True, text=True,
                           timeout=BENCH_TIMEOUT_S)
        wall = time.perf_counter() - t0
        for ln in r.stdout.splitlines():
            print(f"phase 18b 2^{size.bit_length() - 1}: {ln}", flush=True)
        if r.returncode != 0:
            raise AssertionError(f"phase 18b: the bench at {size} exited "
                                 f"{r.returncode}:\n{r.stderr[-3000:]}")
        lines = [json.loads(ln) for ln in r.stdout.splitlines()]
        fused, diag, head = lines
        if not (head["metric"] == bench.METRIC and head["value"] > 0
                and head["band"]["n_trials"] >= 3
                and head["batch_size"] == size
                and fused["metric"] == bench.FUSED_METRIC
                and fused["band"]["n_trials"] >= 3
                and all(ln["device"]["name"] == kind for ln in lines)):
            raise AssertionError(f"phase 18b: the bench's lines at {size} "
                                 "are not the contract's")
        if diag["run_hist_launches"] != diag["steps"] or (
                diag["host_syncs"] is None):
            raise AssertionError(f"phase 18b: {diag['run_hist_launches']} "
                                 f"launches in {diag['steps']} steps")
        launches_b += diag["run_hist_launches"]
        print(f"phase 18b 2^{size.bit_length() - 1}: {wall:.1f} s",
              flush=True)

    # 18c
    run_hist.launches = 0
    profiles.main()
    stages.main()
    launches_c = run_hist.launches
    torch.cuda.empty_cache()
    print(f"phase 18c run_hist launches {launches_c}; phase 18 "
          f"{time.perf_counter() - t18:.1f} s [{_smi()}]", flush=True)
    return launches_a + launches_b + launches_c


PHASE19_CHECK = 1 << 16  # where each case on the card meets the CPU
SIZES19 = tuple(range(23, 28))  # probes.sizes' batch sizes, log2


def probe_modules_phase() -> int:
    """Phase 19: the ports of the rest of benchmarks/ (``probes.sizes``,
    ``tail``, ``sorts``, ``h2d`` and ``decomp``) on the card.

    a. each module's cases at 2^16 on the card, each output equal to the
       same case's on the CPU (probes/common.py same);
    b. each module's main at full size in process, its lines printed:
       sizes at 2^23-2^27; tail on the bench's batch at 2^26 and the
       primitives at 2^26; sorts at 2^26; h2d at 2^26, its headline steps
       on the bench's batch at 2^26; decomp at 2^24 and 2^26. It raises on
       a row form that differs from its flat form (tail), a row or stable
       sort whose words differ from sort_keys' or a hash grouping whose
       runs are not sort_keys' runs, a pair histogram that differs from
       torch.bincount, a sweep case that failed, hash_hist against
       hist_batch (sorts), the old step against the walk step in any round
       (decomp), and no run_hist launch in sizes, sorts or decomp.
    Returns run_hist's launches in b."""
    import torch

    from fastk_tpu_torch.ops.histker import run_hist
    from fastk_tpu_torch.probes import common, decomp, h2d, sizes, sorts, tail

    t19 = time.perf_counter()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    mods = (sizes, tail, sorts, h2d, decomp)
    for mod in mods:
        t0 = time.perf_counter()
        card = mod.cases(cuda, PHASE19_CHECK)
        host = dict(mod.cases(cpu, PHASE19_CHECK))
        bad = [n for n, fn in card if not common.same(fn(), host[n]())]
        if bad or len(card) != len(host):
            raise AssertionError(f"phase 19a: {mod.__name__} cases differ on "
                                 f"the card from the CPU: {bad}")
        print(f"phase 19a {mod.__name__}: {len(card)} cases at 2^16 on the "
              f"card equal to the CPU's ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        del card, host
        torch.cuda.empty_cache()

    run_hist.launches = 0
    launches = {}

    def run(key, fn):
        before = run_hist.launches
        t0 = time.perf_counter()
        res = fn()
        launches[key] = run_hist.launches - before
        torch.cuda.empty_cache()
        print(f"phase 19b {key}: {time.perf_counter() - t0:.1f} s, "
              f"{launches[key]} run_hist launches", flush=True)
        return res

    run("sizes", lambda: sizes.main(sizes=SIZES19))
    res = run("tail", tail.main)
    if res["mismatches"]:
        raise AssertionError(f"phase 19b: tail's row forms differ from the "
                             f"flat forms: {res['mismatches']}")
    res = run("sorts", sorts.main)
    if res["failed"] or not res["mxu_correct"] or res["mismatches"]:
        raise AssertionError(f"phase 19b: sorts failed {res['failed']}, "
                             f"mxu hist correct {res['mxu_correct']}, "
                             f"layouts unlike sort_keys' {res['mismatches']}")
    run("h2d", h2d.main)
    for size in (1 << 24, 1 << 26):
        run(f"decomp 2^{size.bit_length() - 1}",
            lambda size=size: decomp.main(size=size))
    missing = [k for k in ("sizes", "sorts", "decomp 2^24", "decomp 2^26")
               if not launches[k]]
    if missing:
        raise AssertionError(f"phase 19b: no run_hist launch in {missing}")
    total = sum(launches.values())
    print(f"phase 19 run_hist launches {total} {launches}; phase 19 "
          f"{time.perf_counter() - t19:.1f} s [{_smi()}]", flush=True)
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    from fastk_tpu_torch import native
    from fastk_tpu_torch.formats.hist import (
        HIST_HIGH,
        Histogram,
        read_histogram,
        write_histogram,
    )
    from fastk_tpu_torch.formats.ktab import read_ktab
    from fastk_tpu_torch.formats.prof import encode_profiles_bulk
    from fastk_tpu_torch.io.reader import batched_reads
    from fastk_tpu_torch.tools.fastrm import remove_set
    from fastk_tpu_torch import _kernels
    from fastk_tpu_torch.ops.count import (
        compact_table_min,
        count_batch,
        fold_invalid,
        hist_batch,
        positions_inverse,
        profile_join,
        profile_join_inst,
        segmented_count,
        sort_keys,
        unique_batch_inst,
    )
    from fastk_tpu_torch.ops.histker import (
        hist_device_part,
        run_hist,
        run_hist_ref,
        start_words,
    )
    from fastk_tpu_torch.ops.kmers import canonical_kmers
    from fastk_tpu_torch.convert import device_codes, fetch_u16
    from fastk_tpu_torch.ops.pack import pack_stream_words, upload_packed
    from fastk_tpu_torch.pipeline.count import (
        DEFAULT_BATCH_BASES,
        _count_single_fused,
        _device_table,
        _ProfSink,
        _table,
        _pad_codes,
        _round_size,
        count_files,
    )
    from fastk_tpu_torch.pipeline.outofcore import count_files_ooc
    from fastk_tpu_torch.tools.fastk import _batch_bases, _measure_dedup
    from fastk_tpu_torch.tools.fastk import main as fastk_main
    from fastk_tpu_torch.tools.kmermap import main as kmermap_main

    dev = torch.device("cuda")

    # phase 1: device
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"phase 1 device: {kind}, {torch.cuda.device_count()} card(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, native "
          f"host codecs {'loaded' if native.load() else 'absent'}", flush=True)
    print(smi, flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    so = _kernels.build()
    _kernels.load()
    build_s = time.perf_counter() - t0
    with open(so + ".log") as f:
        ptxas = " ".join(ln.split("ptxas info    : ")[-1].strip()
                         for ln in f if "Used" in ln)
    print(f"phase 2 build: {build_s:.1f} s, {os.path.basename(so)}, "
          f"ptxas: {ptxas or 'no report'}", flush=True)

    # phase 3: kernel against its plain version, on the card
    cases = crafted_masks()
    cases.append(("random_2^26", *random_words(1 << 26)))
    max_err = 0
    names = []
    for name, words_np, valid_end in cases:
        words = torch.from_numpy(np.ascontiguousarray(words_np)).to(dev)
        got, nv = run_hist(words, valid_end)
        want, nv_ref = run_hist_ref(words, valid_end)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        if err or nv != nv_ref:
            raise AssertionError(f"run_hist differs from run_hist_ref on "
                                 f"{name}: max abs err {err}")
        names.append(name)
    # a view one word in: not 16-byte aligned, so the kernel's scalar loads
    words = torch.from_numpy(pack_mask(
        np.random.default_rng(3).random(1 << 20) < 0.3)).to(dev)[1:]
    if not torch.equal(run_hist(words, (1 << 20) - 40)[0],
                       run_hist_ref(words, (1 << 20) - 40)[0]):
        raise AssertionError("run_hist differs from run_hist_ref on an "
                             "unaligned view")
    names.append("unaligned_view")
    print(f"phase 3 kernel vs plain: {len(names)} cases equal "
          f"({', '.join(names)}), max abs err {max_err}; "
          f"{_kernels.load().fk_run_hist_blocks_per_sm()} blocks of 256 "
          "threads resident per SM", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # phase 4: one batch of ~60 Mbp through the CLI
        fasta = os.path.join(tmp, "single.fasta")
        nreads = 3000
        write_hifi_fasta(fasta, 1_200_000, nreads, seed=4)
        run_hist.launches = 0
        t0 = time.perf_counter()
        rc = fastk_main(["-k40", f"-N{tmp}/s", fasta])
        main_s = time.perf_counter() - t0
        launches = run_hist.launches
        if rc != 0 or launches < 1:
            raise AssertionError(f"fastk main rc {rc}, run_hist launches "
                                 f"{launches}")
        hist = read_histogram(f"{tmp}/s")

        t0 = time.perf_counter()
        batches = [b for b, _ in batched_reads([fasta], 256 << 20)]
        parse_s = time.perf_counter() - t0
        if len(batches) != 1:
            raise AssertionError(f"expected one batch, got {len(batches)}")
        batch = batches[0]
        size = _round_size(len(batch.codes), K)
        codes = _pad_codes(batch, K, size)
        pack_s, dev_s = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pw, exc = pack_stream_words(codes)
            t1 = time.perf_counter()
            hist_batch(upload_packed(pw, exc, len(codes), dev), K,
                       size)["hist"].cpu()
            pack_s.append(t1 - t0)
            dev_s.append(time.perf_counter() - t1)
        pack_s, dev_s = statistics.median(pack_s), statistics.median(dev_s)
        sw, valid_end = hist_device_part(device_codes(codes, dev), K, size)
        ref_bins, _ = run_hist_ref(sw, valid_end)
        ref_bins = ref_bins.cpu().numpy()
        err = int(np.abs(run_hist(sw, valid_end)[0].cpu().numpy()
                         - ref_bins).max())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"run_hist differs from run_hist_ref on the "
                                 f"real 2^26 batch: max abs err {err}")
        ref = Histogram.from_bins(K, ref_bins, valid_end - int(
            (ref_bins[1:] * np.arange(1, HIST_HIGH + 1)).sum()))
        want_inst = nreads * (READ_LEN - K + 1)
        if hist != ref:
            raise AssertionError("CLI .hist differs from the plain binning "
                                 "of the same sorted keys")
        if not hist.total_instances() == valid_end == want_inst:
            raise AssertionError(
                f"instances: hist {hist.total_instances()}, nvalid "
                f"{valid_end}, expected {want_inst}")
        print(f"phase 4 single batch: {batch.totlen} bases, size 2^"
              f"{size.bit_length() - 1}, run_hist launches {launches}, CLI "
              f"{main_s:.2f} s, parse {parse_s:.2f} s, host pack "
              f"{pack_s * 1e3:.1f} ms + upload+count+fetch {dev_s * 1e3:.1f} "
              f"ms = {batch.totlen / (pack_s + dev_s):.4g} bases/s, "
              f"instances {want_inst} exact, equal to plain binning; the "
              f"kernel equal to run_hist_ref on the batch's start words",
              flush=True)

        # phase 5: several batches; two batch sizes; numpy brute force
        fasta5 = os.path.join(tmp, "multi.fasta")
        nreads5 = 10_000
        write_hifi_fasta(fasta5, 4_000_000, nreads5, seed=5)
        nbatches = [sum(1 for _ in batched_reads([fasta5], bb))
                     for bb in (DEFAULT_BATCH_BASES, 1 << 24)]
        if nbatches[0] < 3:
            raise AssertionError(f"expected >= 3 batches, got {nbatches[0]}")
        t0 = time.perf_counter()
        outs = [count_files([fasta5], K, device="cuda")]
        multi_s = time.perf_counter() - t0
        outs.append(count_files([fasta5], K, batch_bases=1 << 24,
                                device="cuda"))
        blobs = []
        for i, out in enumerate(outs):
            write_histogram(f"{tmp}/m{i}", out.hist)
            with open(f"{tmp}/m{i}.hist", "rb") as f:
                blobs.append(f.read())
            want5 = nreads5 * (READ_LEN - K + 1)
            if out.hist.total_instances() != want5:
                raise AssertionError(f"multi-batch instances "
                                     f"{out.hist.total_instances()} != "
                                     f"{want5}")
        if blobs[0] != blobs[1]:
            raise AssertionError("multi-batch .hist differs between batch "
                                 "sizes")
        fasta1 = os.path.join(tmp, "one_mbp.fasta")
        write_hifi_fasta(fasta1, 100_000, 50, seed=6)
        codes1 = next(batched_reads([fasta1], 256 << 20))[0].codes
        want1, table1 = brute_count(codes1, K)
        for bb in (256 << 20, 1 << 18):
            if count_files([fasta1], K, batch_bases=bb,
                           device="cuda").hist != want1:
                raise AssertionError(f"1 Mbp histogram (batch_bases {bb}) "
                                     "differs from the numpy count")
        print(f"phase 5 multi-batch: {outs[0].totlen} bases, "
              f"{multi_s:.2f} s in {nbatches[0]} batches at the default "
              f"batch size, .hist identical in {nbatches[1]} batches of "
              f"2^24, instances {want5} exact; 1 Mbp equal "
              "to numpy brute force (one batch and 4 batches)", flush=True)

        # phase 6: times at 2^26 positions, on the phase-4 batch
        codes_d = device_codes(codes, dev)
        kernel_ms = _graph_ms(lambda: run_hist(sw, valid_end))
        call_ms = _cuda_ms(lambda: run_hist(sw, valid_end))
        plain_ms = _cuda_ms(lambda: run_hist_ref(sw, valid_end))
        bound_ms, bound_by = run_hist_bound(sw, valid_end)
        kmers_ms = _cuda_ms(lambda: canonical_kmers(codes_d, K, size))
        words, invalid = canonical_kmers(codes_d, K, size)
        folded = fold_invalid(words, invalid)
        del words, invalid
        sort_ms = _cuda_ms(lambda: sort_keys(folded))
        s_words, _ = sort_keys(folded)
        del folded
        starts_ms = _cuda_ms(lambda: start_words(s_words, valid_end))
        rnd_words, rnd_end = random_words(1 << 26)
        rnd = torch.from_numpy(rnd_words).to(dev)
        rnd_kernel_ms = _graph_ms(lambda: run_hist(rnd, rnd_end))
        rnd_call_ms = _cuda_ms(lambda: run_hist(rnd, rnd_end))
        rnd_plain_ms = _cuda_ms(lambda: run_hist_ref(rnd, rnd_end))
        rnd_bound_ms, _ = run_hist_bound(rnd, rnd_end)
        sw_np = sw.cpu().numpy()  # phase 16 walks and packs them
        nstarts = int(np.unpackbits(sw_np.view(np.uint8),
                                    bitorder="little")[:valid_end].sum())
        print(f"phase 6 times at 2^26 positions (median of 7, CUDA events): "
              f"run_hist kernel {kernel_ms:.4f} ms a launch in a CUDA graph "
              f"of 20 ({call_ms:.4f} ms in a window of one call, host launch "
              f"included), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {4 * sw.numel()} B of start words + 256 KiB of "
              f"histogram at 3.35 TB/s), {100 * bound_ms / kernel_ms:.1f} % "
              f"of the bound, {launches} launch(es) in the phase-4 job, "
              f"{nstarts} run starts; random mask: {rnd_kernel_ms:.4f} ms "
              f"in the graph ({rnd_call_ms:.4f} ms one call), plain "
              f"{rnd_plain_ms:.4f} ms, {100 * rnd_bound_ms / rnd_kernel_ms:.1f}"
              f" % of its bound; sort_keys {sort_ms:.3f} ms; canonical_kmers "
              f"{kmers_ms:.3f} ms; start_words {starts_ms:.3f} ms",
              flush=True)

        # phase 7: the -t3 -p and -t1 -p jobs on the phase-4 batch, through
        # the CLI (the fused single-batch path)
        run_hist.launches = 0
        base7 = torch.cuda.memory_allocated()  # phase 6's tensors
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = fastk_main(["-k40", "-t3", "-p", f"-N{tmp}/p3", fasta])
        cli7_s = time.perf_counter() - t0
        launches7 = run_hist.launches
        peak7 = torch.cuda.max_memory_allocated()
        if rc != 0 or launches7 < 1:
            raise AssertionError(f"fastk -t3 -p rc {rc}, run_hist launches "
                                 f"{launches7}")
        if fastk_main(["-k40", "-t1", "-p", f"-N{tmp}/p1", fasta]) != 0:
            raise AssertionError("fastk -t1 -p failed")
        for b in ("p3", "p1"):
            if read_histogram(f"{tmp}/{b}") != hist:
                raise AssertionError(f"{b}.hist differs from phase 4's")
        t1, t3 = read_ktab(f"{tmp}/p1"), read_ktab(f"{tmp}/p3")
        c1 = t1.counts.astype(np.int64)
        if int(c1.sum()) != want_inst or int(c1.max()) >= HIST_HIGH:
            raise AssertionError(f"-t1 counts sum {int(c1.sum())} != "
                                 f"{want_inst} or a count clipped")
        keep = t1.counts >= 3
        if not (np.array_equal(t3.packed, t1.packed[keep])
                and np.array_equal(t3.counts, t1.counts[keep])
                and t3.minval == 3):
            raise AssertionError("-t3 table is not the -t1 entries >= 3")
        nprof, npos, psum = profile_sums(f"{tmp}/p1")
        if (nprof, npos, psum) != (nreads, want_inst, int((c1 * c1).sum())):
            raise AssertionError(
                f"profiles: {nprof} reads, {npos} positions, sum {psum}; "
                f"want {nreads}, {want_inst}, {int((c1 * c1).sum())}")
        prof7 = file_set(tmp, "p1", (".prof", ".pidx"))
        if file_set(tmp, "p3", (".prof", ".pidx")) != prof7:
            raise AssertionError("-t3 -p and -t1 -p profiles differ")
        print(f"phase 7 -t3 -p on one batch: CLI {cli7_s:.2f} s, run_hist "
              f"launches {launches7}, .hist equal to phase 4, -t1 {len(t1)} "
              f"entries summing to {want_inst} instances, -t3 {len(t3)} "
              f"entries = the -t1 entries >= 3, profile sum {psum} = sum of "
              "count^2", flush=True)

        # phase 8: the same job in several batches (both profile-join
        # branches), relative profiles, 200 Mbp, and cuda against cpu
        joins = JoinCounter()
        set7 = file_set(tmp, "p3")
        os.environ["FASTK_TPU_BATCH_BASES"] = str(1 << 24)
        try:
            if fastk_main(["-k40", "-t3", "-p", f"-N{tmp}/b", fasta]) != 0:
                raise AssertionError("fastk in batches of 2^24 failed")
            inst_joins = joins.take()
            os.environ["FASTK_TPU_INST_HBM"] = "0"
            if fastk_main(["-k40", "-t3", "-p", f"-N{tmp}/z", fasta]) != 0:
                raise AssertionError("fastk with no instance budget failed")
            packed_joins = joins.take()
        finally:
            os.environ.pop("FASTK_TPU_BATCH_BASES", None)
            os.environ.pop("FASTK_TPU_INST_HBM", None)
        for b in ("b", "z"):
            if file_set(tmp, b) != set7:
                raise AssertionError(f"multi-batch run {b} differs from "
                                     "phase 7's file-sets")
            for ext in (".hist", ".ktab", ".prof"):
                remove_set(f"{tmp}/{b}{ext}")
        if (inst_joins["inst"] < 3 or inst_joins["packed"]
                or packed_joins["packed"] != inst_joins["inst"]
                or packed_joins["inst"]):
            raise AssertionError(f"join branches: {inst_joins} with the "
                                 f"default budget, {packed_joins} with 0")
        if fastk_main(["-k40", f"-p:{tmp}/p1.ktab", f"-N{tmp}/rel",
                       fasta]) != 0:
            raise AssertionError("fastk -p:<table> failed")
        if (file_set(tmp, "rel") != prof7
                or os.path.exists(f"{tmp}/rel.hist")):
            raise AssertionError("relative profiles against the -t1 table "
                                 "differ from the -p profiles")
        remove_set(f"{tmp}/rel.prof")
        joins.take()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out8 = count_files([fasta5], K, table_min=3, profiles=True,
                           out_base=f"{tmp}/big", device="cuda")
        big_s = time.perf_counter() - t0
        peak8 = torch.cuda.max_memory_allocated()
        write_histogram(f"{tmp}/big", out8.hist)  # phase 10 compares it
        big_joins = joins.take()
        big_prof = profile_sums(f"{tmp}/big")
        big_tab = read_ktab(f"{tmp}/big")
        if (out8.hist.total_instances() != want5
                or big_prof != (nreads5, want5, sum_squares(out8.hist))
                or len(big_tab) != int(out8.hist.counts[2:].sum())
                or read_histogram(f"{tmp}/m0") != out8.hist):
            raise AssertionError(
                f"200 Mbp -t3 -p: instances {out8.hist.total_instances()}, "
                f"profiles {big_prof}, {len(big_tab)} table entries")
        for name, d in (("g", "cuda"), ("c", "cpu")):
            if fastk_main(["-k40", "-t1", "-p", f"-N{tmp}/{name}", fasta1],
                          device=d) != 0:
                raise AssertionError(f"1 Mbp on {d} failed")
        tab_g = read_ktab(f"{tmp}/g")
        if (file_set(tmp, "g") != file_set(tmp, "c")
                or not np.array_equal(tab_g.packed, table1.packed)
                or not np.array_equal(tab_g.counts, table1.counts)):
            raise AssertionError("1 Mbp: cuda and cpu file-sets differ, or "
                                 "the table differs from the numpy count")
        print(f"phase 8 multi-batch -t3 -p: 60 Mbp in batches of 2^24 "
              f"byte-identical to phase 7 with instance streams kept "
              f"({inst_joins}) and with none ({packed_joins}); -p:<-t1 "
              f"table> profiles identical to -p; 200 Mbp {big_s:.2f} s "
              f"({big_joins}), instances {want5}, profile sum = sum of "
              f"count^2, {len(big_tab)} entries >= 3; 1 Mbp cuda file-sets "
              f"= cpu, table = numpy count ({len(tab_g)} entries)",
              flush=True)
        del out8

        # phase 9: times of the -t -p stages at 2^26 positions, on the
        # phase-4 batch
        del s_words, rnd, sw
        cb_ms = _cuda_ms(lambda: count_batch(codes_d, K, size, True, True))
        words, invalid = canonical_kmers(codes_d, K, size)
        folded = fold_invalid(words, invalid)
        del words, invalid
        pos = torch.arange(size, dtype=torch.int32, device=dev)
        sortpos_ms = _cuda_ms(lambda: sort_keys(folded, (pos,)))
        s_words9, (s_pos9,) = sort_keys(folded, (pos,))
        del folded, pos
        elem = segmented_count(s_words9, want_elem_counts=True)[
            "elem_counts"].to(torch.int16)
        inverse_ms = _cuda_ms(lambda: positions_inverse(s_pos9, elem))
        del s_words9, s_pos9, elem
        res = count_batch(codes_d, K, size, True, True)
        compact_ms = _cuda_ms(lambda: compact_table_min(
            res["seg_words"], res["seg_counts"], 3))
        t_words, t_counts = _device_table(t1, K, dev)
        join_ms = _cuda_ms(lambda: profile_join(t_words, t_counts, codes_d,
                                                K, size))
        inst = unique_batch_inst(codes_d, K, size)
        join_inst_ms = _cuda_ms(lambda: profile_join_inst(
            t_words, t_counts, inst["s_words"], inst["s_pos"]))
        for got in (profile_join(t_words, t_counts, codes_d, K, size),
                    profile_join_inst(t_words, t_counts, inst["s_words"],
                                      inst["s_pos"])):
            if not torch.equal(got, res["pos_counts"]):
                raise AssertionError("a join against the batch's own table "
                                     "differs from count_batch's counts")
        nuniq = int(res["nseg"]) - 1  # the batch has invalid positions
        table_ms = _host_ms(lambda: _table(K, 3, res["seg_words"],
                                           res["seg_counts"], nuniq,
                                           f"{tmp}/x", 4))
        fetch_ms = _host_ms(lambda: fetch_u16(res["pos_counts"]))
        pos_np = fetch_u16(res["pos_counts"])
        del res, inst, t_words, t_counts
        plen = np.maximum(batch.rlen - K + 1, 0)
        encode_ms = _host_ms(lambda: encode_profiles_bulk(
            pos_np, batch.boff[:-1], plen), reps=5)

        def write_prof():
            sink = _ProfSink(K, f"{tmp}/x", 4, batch.nreads)
            sink.add_batch(batch.boff, batch.rlen, pos_np)
            sink.close()

        prof_ms = _host_ms(write_prof)
        upcount_ms = _host_ms(lambda: count_batch(
            upload_packed(pw, exc, len(codes), dev), K, size, True, True))
        whole_s = _host_ms(lambda: _count_single_fused(
            batch, K, 3, False, f"{tmp}/w", 4, dev)) / 1e3
        if file_set(tmp, "w", (".ktab", ".prof", ".pidx")) != {
                n: b for n, b in set7.items() if ".hist" not in n}:
            raise AssertionError("the timed -t3 -p batch wrote other files")
        print(f"phase 9 -t3 -p times at 2^26 positions (median of 7, CUDA "
              f"events): count_batch {cb_ms:.3f} ms, of which sort_keys "
              f"with positions {sortpos_ms:.3f} ms and positions_inverse "
              f"{inverse_ms:.3f} ms; compact_table_min {compact_ms:.3f} ms; "
              f"profile_join {join_ms:.3f} ms, profile_join_inst "
              f"{join_inst_ms:.3f} ms against the {len(t1)}-entry table; "
              f"host profile encode {encode_ms:.1f} ms; the whole -t3 -p "
              f"batch (pack, count, table, profiles, files; parse apart) "
              f"{whole_s * 1e3:.1f} ms = {batch.totlen / whole_s:.4g} "
              f"bases/s, of which (each timed alone) upload + count_batch "
              f"{upcount_ms:.1f} ms, -t3 table fetch + .ktab write "
              f"{table_ms:.1f} ms, profile fetch {fetch_ms:.1f} ms, profile "
              f"encode + .prof write {prof_ms:.1f} ms", flush=True)
        del codes_d, pos_np

        # phase 10: out of core through the CLI at -M1 (spills under -P) on
        # the phase-5 input, against phase 8's in-core file-sets
        sort10 = os.path.join(tmp, "sort10")
        os.mkdir(sort10)
        nb10 = sum(1 for _ in batched_reads([fasta5],
                                            _batch_bases({"M": 1})))
        runs10 = {}
        for name, flags, exts in (("o10t", ["-t3"], (".hist", ".ktab")),
                                  ("o10p", ["-t3", "-p"], None)):
            want10 = (file_set(tmp, "big", exts) if exts
                      else file_set(tmp, "big"))
            log = io.StringIO()
            base10 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with OocProbe() as probe, redirect_stdout(log), \
                    redirect_stderr(log):
                rc = fastk_main(["-k40", *flags, "-v", "-M1", f"-P{sort10}",
                                 f"-N{tmp}/{name}", fasta5])
            wall10 = time.perf_counter() - t0
            peak10 = torch.cuda.max_memory_allocated() - base10
            text = log.getvalue()
            r = probe.report(nb10)
            if (rc != 0 or "out-of-core:" not in text or r["merges"] < 1
                    or (r["back"] >= 1) != ("-p" in flags)):
                raise AssertionError(
                    f"phase 10 {flags}: rc {rc}, {r['merges']} merges, "
                    f"{r['back']} with want_back; log:\n{text[-3000:]}")
            if file_set(tmp, name) != want10:
                raise AssertionError(f"phase 10 {flags}: the out-of-core "
                                     "file-sets differ from the in-core ones")
            if os.listdir(sort10):
                raise AssertionError(f"phase 10: spills left in {sort10}: "
                                     f"{os.listdir(sort10)}")
            runs10[name] = (wall10, plan_of(text), r, peak10)
        (wt, (pt, gt, lt), rt, mt), (wp, (pp, gp, lp), rp, mp) = (
            runs10["o10t"], runs10["o10p"])
        print(f"phase 10 out of core through the CLI at -M1 on the phase-5 "
              f"200 Mbp, {nb10} batches: file-sets byte-identical to the "
              f"in-core run of phase 8; -t3: CLI {wt:.2f} s, device peak "
              f"{mt / 1e9:.3f} GB above what was held, planned {pt} "
              f"parts, {gt} merges after consolidation, largest group {lt} "
              f"records, {ooc_line(rt)}; -t3 -p: CLI {wp:.2f} s, device peak "
              f"{mp / 1e9:.3f} GB, planned "
              f"{pp} parts, {gp} merges after consolidation, largest group "
              f"{lp} records, {ooc_line(rp)}", flush=True)

        # phase 11: part merges of ~5e7 records through count_files_ooc, on
        # a yeast-sized 50X run, against the in-core -t3 run; the device
        # footprints behind the CLI's plan constants
        fasta11 = os.path.join(tmp, "yeast.fasta")
        nreads11 = 30_000
        write_hifi_fasta(fasta11, 12_000_000, nreads11, seed=11)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        inc11 = count_files([fasta11], K, table_min=3,
                            out_base=f"{tmp}/y_in", device="cuda")
        incore11_s = time.perf_counter() - t0
        peak11 = torch.cuda.max_memory_allocated()
        write_histogram(f"{tmp}/y_in", inc11.hist)
        want11 = nreads11 * (READ_LEN - K + 1)
        if inc11.hist.total_instances() != want11:
            raise AssertionError(f"600 Mbp in core: instances "
                                 f"{inc11.hist.total_instances()} != "
                                 f"{want11}")
        sort11 = os.path.join(tmp, "sort11")
        os.mkdir(sort11)
        log = io.StringIO()
        t0 = time.perf_counter()
        with OocProbe(measure_back=True) as probe11, redirect_stdout(log):
            out11 = count_files_ooc([fasta11], K, 2, sort_path=sort11,
                                    table_min=3, part_cap=1 << 26,
                                    out_base=f"{tmp}/y_ooc", verbose=True,
                                    device="cuda")
        ooc11_s = time.perf_counter() - t0
        write_histogram(f"{tmp}/y_ooc", out11.hist)
        r11 = probe11.report(sum(1 for _ in batched_reads([fasta11],
                                                          64 << 20)))
        sizes11 = [n for n, _, _ in probe11.merges]
        if file_set(tmp, "y_ooc") != file_set(tmp, "y_in"):
            raise AssertionError("600 Mbp: the out-of-core file-sets differ "
                                 "from the in-core ones")
        if len(sizes11) < 2 or min(sizes11) < 1 << 24 or os.listdir(sort11):
            raise AssertionError(f"600 Mbp: merges of {sizes11} records "
                                 f"(want >= 2 of >= 2^24); log:\n"
                                 f"{log.getvalue()[-3000:]}")
        back_n, back_bytes, back_ms = max(probe11.back)
        # footprints: bytes at the plan's terms, est = the file's bytes,
        # ratio = the CLI's first-slice measurement
        est11, est5, est4 = (os.path.getsize(f) for f in
                             (fasta11, fasta5, fasta))
        ratio11, ratio5 = (_measure_dedup([f], K, 64 << 20, False, 0, dev)
                           for f in (fasta11, fasta5))
        unique_b = peak11 / (est11 * ratio11)
        print(f"phase 11 part merges through count_files_ooc: 600 Mbp "
              f"({nreads11} reads from a 12 Mbp genome), 2 parts at "
              f"part_cap 2^26: merges of {sizes11} records, file-sets "
              f"byte-identical to the in-core -t3 run ({incore11_s:.2f} s); "
              f"out of core {ooc11_s:.2f} s: {ooc_line(r11)}; device "
              f"footprints (max_memory_allocated): in-core -t3 at 600 Mbp "
              f"{peak11 / 1e9:.3f} GB = {unique_b:.1f} B a block record "
              f"(est {est11} x ratio {ratio11:.4f}); in-core -t3 -p at 200 "
              f"Mbp {peak8 / 1e9:.3f} GB = {peak8 / est5:.1f} B a position "
              f"(ratio {ratio5:.4f}: {peak8 / est5 - ratio5 * unique_b:.1f} "
              f"B a position beside {unique_b:.1f} B a block record); fused "
              f"-t3 -p CLI at 60 Mbp {peak7 / 1e9:.3f} GB, less the "
              f"{base7 / 1e9:.3f} GB that phase 6 holds, = "
              f"{(peak7 - base7) / est4:.1f} B a position; a part merge with "
              f"want_back {back_bytes / 1e9:.3f} GB = "
              f"{back_bytes / back_n:.1f} B a record at {back_n} records, "
              f"{back_ms:.3f} ms on the card",
              flush=True)
        for b in ("y_in", "y_ooc"):
            for ext in (".hist", ".ktab"):
                remove_set(f"{tmp}/{b}{ext}")
        os.remove(fasta11)
        del inc11, out11

        # phase 12a: -R, the phase-10 -t3 -p job killed after its first
        # batch is in the manifest, then resumed
        sort12 = os.path.join(tmp, "sort12")
        os.mkdir(sort12)
        repo = os.path.dirname(os.path.abspath(__file__))
        argv12 = ["-k40", "-t3", "-p", "-M1", "-R", f"-P{sort12}",
                  f"-N{tmp}/r12", fasta5]
        env12 = dict(os.environ, FASTK_TPU_BATCH_BASES=str(1 << 24),
                     PYTHONPATH=repo + os.pathsep
                     + os.environ.get("PYTHONPATH", ""))
        nb12 = sum(1 for _ in batched_reads([fasta5], 1 << 24))

        def batches_done() -> int:
            for m in glob.glob(os.path.join(sort12, "fastk_tpu_ooc.*",
                                            "manifest.json")):
                try:
                    with open(m) as f:
                        return int(json.load(f)["batches_done"])
                except (OSError, ValueError, KeyError):
                    pass
            return 0

        t0 = time.perf_counter()
        with open(os.path.join(tmp, "r12.err"), "wb") as err12:
            proc = subprocess.Popen(
                [sys.executable, "-m", "fastk_tpu_torch.tools.fastk",
                 *argv12], cwd=repo, env=env12, stdout=subprocess.DEVNULL,
                stderr=err12)
            try:
                while batches_done() < 1:
                    if proc.poll() is not None:
                        raise AssertionError(
                            f"-R run ended (rc {proc.returncode}) before "
                            "its first batch reached the manifest")
                    if time.perf_counter() - t0 > 600:
                        raise AssertionError("-R run: no manifest in 600 s")
                    time.sleep(0.02)
                proc.send_signal(signal.SIGKILL)
            finally:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        killed_at = batches_done()
        if not 1 <= killed_at < nb12 or os.path.exists(f"{tmp}/r12.hist"):
            raise AssertionError(f"-R run killed with {killed_at} of {nb12} "
                                 "batches in the manifest")
        os.environ["FASTK_TPU_BATCH_BASES"] = str(1 << 24)
        try:
            log = io.StringIO()
            t0 = time.perf_counter()
            with redirect_stdout(log), redirect_stderr(log):
                rc = fastk_main(argv12 + ["-v"])
            resume_s = time.perf_counter() - t0
        finally:
            os.environ.pop("FASTK_TPU_BATCH_BASES", None)
        text = log.getvalue()
        m = re.search(r"resume: phase 1 re-enters after batch (\d+)", text)
        if rc != 0 or not m or int(m.group(1)) != killed_at:
            raise AssertionError(f"-R rerun: rc {rc}; log:\n{text[-3000:]}")
        if file_set(tmp, "r12") != file_set(tmp, "o10p") or os.listdir(
                sort12):
            raise AssertionError("-R: the resumed file-sets differ from "
                                 "phase 10's, or spills were left")

        # phase 12b: out-of-memory demotion. A redundant head (error-free
        # reads of a 100 kb genome) makes the measured plan promote the job
        # in core; the novel tail (an 80 Mbp genome at 1X) then outgrows a
        # memory cap that fits the out-of-core job, whose reserved peak
        # sets the cap.
        head = os.path.join(tmp, "head.fasta")
        tail = os.path.join(tmp, "tail.fasta")
        write_hifi_fasta(head, 100_000, 1000, seed=12, err=0.0)
        write_hifi_fasta(tail, 80_000_000, 4000, seed=13)
        dem = ["-k40", "-t3", "-M1", f"-P{sort12}"]
        total_mem = torch.cuda.get_device_properties(0).total_memory
        os.environ["FASTK_TPU_BATCH_BASES"] = str(1 << 24)
        try:
            torch.cuda.empty_cache()
            base = torch.cuda.memory_reserved()
            torch.cuda.reset_peak_memory_stats()
            if fastk_main(dem + ["-R", f"-N{tmp}/d_ooc", head, tail]) != 0:
                raise AssertionError("the out-of-core demotion reference "
                                     "failed")
            need = torch.cuda.max_memory_reserved() - base
            torch.cuda.empty_cache()
            cap = torch.cuda.memory_reserved() + int(1.5 * need)
            torch.cuda.set_per_process_memory_fraction(cap / total_mem)
            try:
                log = io.StringIO()
                t0 = time.perf_counter()
                with redirect_stdout(log), redirect_stderr(log):
                    rc = fastk_main(dem + ["-v", f"-N{tmp}/d_dem", head,
                                           tail])
                demote_s = time.perf_counter() - t0
            finally:
                torch.cuda.set_per_process_memory_fraction(1.0)
        finally:
            os.environ.pop("FASTK_TPU_BATCH_BASES", None)
        text = log.getvalue()
        if (rc != 0 or "in-core (footprint" not in text
                or "falling back to out-of-core" not in text):
            raise AssertionError(f"demotion: rc {rc}; log:\n{text[-3000:]}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        d_in = count_files([head, tail], K, table_min=3,
                           out_base=f"{tmp}/d_in", device="cuda")
        peak_in = torch.cuda.max_memory_reserved()
        write_histogram(f"{tmp}/d_in", d_in.hist)
        if not (file_set(tmp, "d_dem") == file_set(tmp, "d_in")
                == file_set(tmp, "d_ooc")) or peak_in <= cap:
            raise AssertionError("demotion: the demoted, in-core and "
                                 "out-of-core file-sets differ, or the "
                                 "in-core job fits the cap")

        # phase 12c: kmermap on the card against the CPU, phase 8's 1 Mbp
        # reads against their own -t1 table
        beds = {}
        for d in ("cuda", "cpu"):
            for flag in ([], ["-m"]):
                if kmermap_main(flag + [f"{tmp}/g.ktab", fasta1,
                                        f"{tmp}/km_{d}"], device=d) != 0:
                    raise AssertionError(f"kmermap on {d} failed")
                sfx = "kmers.merge.bed" if flag else "kmers.bed"
                with open(f"{tmp}/km_{d}.one_mbp.{sfx}", "rb") as f:
                    beds[d, sfx] = f.read()
        nbed = {sfx: beds["cuda", sfx].count(b"\n")
                for sfx in ("kmers.bed", "kmers.merge.bed")}
        if any(beds["cuda", sfx] != beds["cpu", sfx] for sfx in nbed) or (
                nbed["kmers.bed"] != 50 * (READ_LEN - K + 1)):
            raise AssertionError(f"kmermap: cuda and cpu beds differ, or "
                                 f"{nbed} rows")

        # phase 12d: a FASTK_TPU_TRACE trace of the phase-4 -k40 job
        trace_dir = os.path.join(tmp, "trace")
        os.environ["FASTK_TPU_TRACE"] = trace_dir
        run_hist.launches = 0
        try:
            t0 = time.perf_counter()
            rc = fastk_main(["-k40", f"-N{tmp}/tr", fasta])
            trace_s = time.perf_counter() - t0
        finally:
            os.environ.pop("FASTK_TPU_TRACE", None)
        launches12 = run_hist.launches
        (tpath,) = glob.glob(os.path.join(trace_dir, "*.trace.json"))
        busy, busy_dev, nker, top = device_busy(tpath)
        if (rc != 0 or launches12 < 1 or nker != launches12
                or read_histogram(f"{tmp}/tr") != hist):
            raise AssertionError(f"trace: rc {rc}, run_hist launches "
                                 f"{launches12}, {nker} in the trace")
        print(f"phase 12 -R: killed (SIGKILL) with {killed_at} of {nb12} "
              f"batches in the manifest, resumed after batch {killed_at} in "
              f"{resume_s:.2f} s, file-sets byte-identical to phase 10; "
              f"out-of-memory demotion under a {cap / 1e9:.3f} GB cap (the "
              f"in-core job reserves {peak_in / 1e9:.3f} GB): demoted in "
              f"{demote_s:.2f} s, file-sets byte-identical to the in-core "
              f"and out-of-core runs; kmermap beds on the card = cpu "
              f"({nbed}); trace of the -k40 job ({trace_s:.2f} s, "
              f"{os.path.getsize(tpath)} bytes): {nker} run_hist kernel "
              f"event(s), device busy {100 * busy:.2f} % of the run, "
              f"{100 * busy_dev:.2f} % between its first and last device "
              f"event; device time by kernel: {top}", flush=True)

        # phase 13: the table tools and the library union on the card
        table_tools_phase(tmp, fasta5, f"{tmp}/p1")

        # phase 14: the multi-device library, and -M on a one-batch -p job
        launches14 = multi_device_phase(tmp, fasta, fasta5, f"{tmp}/p1",
                                        "o10p", wp)

        # phase 15: the entry points, and the mesh job on every card
        torch.cuda.empty_cache()
        launches15a = entry_phase()
        ncards = torch.cuda.device_count()
        launches15b = dryrun_phase(ncards)
        launches15c = 0
        if ncards >= 2:
            launches15c = multi_card_phase(tmp, fasta, fasta5, "o10p",
                                           ncards)
        else:
            print("phase 15c needs two or more cards (one rank a card); "
                  "this machine has one, so it ran nothing", flush=True)

        # phase 16: the probe kernels, their path and their times
        torch.cuda.empty_cache()
        probe_entries = probes_phase(sw_np)

        # phase 17: the -M host-memory bound, out of core and in the mesh
        torch.cuda.empty_cache()
        launches17 = host_memory_phase(tmp)

        # phase 18: the port's headline bench and its probes
        torch.cuda.empty_cache()
        launches18 = bench_phase()

        # phase 19: the ports of the rest of benchmarks/
        torch.cuda.empty_cache()
        launches19 = probe_modules_phase()

    print(f"phases 1-19 in {time.perf_counter() - t_start:.1f} s [{_smi()}]",
          flush=True)

    print(json.dumps({"kernels": [{
        "name": "run_hist", "route": "cuda",
        "source": "fastk_tpu_torch/csrc/run_hist.cu",
        "replaces": "fastk_tpu/ops/histker.py:72",
        "launches": (launches + launches7 + launches12 + launches14
                     + launches15a + launches15b + launches15c
                     + launches17 + launches18 + launches19),
        "launches_per_job": launches,
        "launches_phase14a": launches14,
        "launches_phase15a": launches15a,
        "launches_phase15b": launches15b,
        "launches_phase15c": launches15c,
        "launches_phase17b": launches17,
        "launches_phase18": launches18,
        "launches_phase19": launches19,
        "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "random_mask_ms": rnd_kernel_ms}] + probe_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:  # a rank of a phase-15c world
        from fastk_tpu_torch.parallel.launch import worker_main

        sys.exit(worker_main(WORLD_TASKS))
    sys.exit(main())
