#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fastk_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile the CUDA kernels from ``fastk_tpu_torch/csrc``;
3. the run-length histogram kernel against its plain torch version on the
   card, on crafted start masks and on random ones up to 2^26 positions;
4. the histogram job on one batch of about 60 Mbp of 50X-HiFi-like reads
   (2^26 positions), through the CLI, with the kernel's launch count,
   exact instance accounting and a second computation that bins the same
   sorted keys with the plain version;
5. the job on about 200 Mbp in several batches, at two batch sizes that must
   give byte-identical histograms, and on 1 Mbp against a numpy count;
6. times on the card at 2^26 positions: the kernel, its plain version, the
   key sort and canonical_kmers;
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
    with the run_hist kernel in it, and the device's busy share.

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


def crafted_masks(seed: int = 0):
    """(name, start words int32, valid_end) cases for the run-length kernel:
    edge lengths, runs across word and block boundaries, invalid tails."""
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
    return cases


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

    from fastk_tpu.formats.hist import HIST_HIGH, Histogram
    from fastk_tpu.formats.ktab import KmerTable, pack_codes

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
    from fastk_tpu.formats.prof import ProfileIndex

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1

    from fastk_tpu import native
    from fastk_tpu.formats.hist import (
        HIST_HIGH,
        Histogram,
        read_histogram,
        write_histogram,
    )
    from fastk_tpu.formats.ktab import read_ktab
    from fastk_tpu.formats.prof import encode_profiles_bulk
    from fastk_tpu.io.reader import batched_reads
    from fastk_tpu.tools.fastrm import remove_set
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
    from fastk_tpu_torch.ops.pack import (
        device_codes,
        fetch_u16,
        pack_stream_words,
        upload_packed,
    )
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
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
    print(f"phase 3 kernel vs plain: {len(cases)} cases equal "
          f"({', '.join(names)}), max abs err {max_err}", flush=True)

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
              f"instances {want_inst} exact, equal to plain binning",
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
        kernel_ms = _cuda_ms(lambda: run_hist(sw, valid_end))
        plain_ms = _cuda_ms(lambda: run_hist_ref(sw, valid_end))
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
        rnd_kernel_ms = _cuda_ms(lambda: run_hist(rnd, rnd_end))
        rnd_plain_ms = _cuda_ms(lambda: run_hist_ref(rnd, rnd_end))
        print(f"phase 6 times at 2^26 positions (median of 7, CUDA events): "
              f"run_hist kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(random mask: {rnd_kernel_ms:.4f} / {rnd_plain_ms:.4f} ms); "
              f"sort_keys {sort_ms:.3f} ms; canonical_kmers {kmers_ms:.3f} ms; "
              f"start_words {starts_ms:.3f} ms",
              flush=True)

        # phase 7: the -t3 -p and -t1 -p jobs on the phase-4 batch, through
        # the CLI (the fused single-batch path)
        run_hist.launches = 0
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
            t0 = time.perf_counter()
            with OocProbe() as probe, redirect_stdout(log), \
                    redirect_stderr(log):
                rc = fastk_main(["-k40", *flags, "-v", "-M1", f"-P{sort10}",
                                 f"-N{tmp}/{name}", fasta5])
            wall10 = time.perf_counter() - t0
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
            runs10[name] = (wall10, plan_of(text), r)
        (wt, (pt, gt, lt), rt), (wp, (pp, gp, lp), rp) = (
            runs10["o10t"], runs10["o10p"])
        print(f"phase 10 out of core through the CLI at -M1 on the phase-5 "
              f"200 Mbp, {nb10} batches: file-sets byte-identical to the "
              f"in-core run of phase 8; -t3: CLI {wt:.2f} s, planned {pt} "
              f"parts, {gt} merges after consolidation, largest group {lt} "
              f"records, {ooc_line(rt)}; -t3 -p: CLI {wp:.2f} s, planned "
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
              f"-t3 -p CLI at 60 Mbp {peak7 / 1e9:.3f} GB = "
              f"{peak7 / est4:.1f} B a position; a part merge with "
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

    print(json.dumps({"kernels": [{
        "name": "run_hist", "route": "cuda",
        "source": "fastk_tpu_torch/csrc/run_hist.cu",
        "replaces": "fastk_tpu/ops/histker.py:72",
        "launches": launches + launches7 + launches12,
        "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
