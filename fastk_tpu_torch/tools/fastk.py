"""The port's ``fastk`` CLI: the counting job on the card, in core or out of
core.

    python -m fastk_tpu_torch.tools.fastk [-k<int(40)>] [-t[<int(1)>]]
        [-p[:<table>[.ktab]]] [-c] [-bc<int>] [-v] [-N<path_name>]
        [-P<dir($TMPDIR)>] [-M<int(12)>] [-T<int(4)>] [-R]
        <source>[.fast[aq][.gz]] ...

Writes <source>.hist (or <path_name>.hist), <source>.ktab with -t and
<source>.prof with -p, each table and profile set in -T parts. With
-p:<table> only the relative profiles are written, and -t is ignored. Flags
and their parsing (``parse_argv``, copied from ``fastk_tpu/tools/fastk.py``)
are the JAX package's, and so is the plan:

- the input's bases are estimated from its files (gzip expansion measured
  from the head, Dazzler's 2-bit .bps, a x6 guess for BAM/CRAM);
- the job runs in core when its worst-case footprint (every position
  unique) fits both -M and the device's memory; otherwise the first slice's
  measured dedup ratio (uniques / valid positions) decides, and if the
  measured footprint still does not fit, the job runs out of core
  (``pipeline/outofcore.py``) with its spills under -P. A one-batch -p
  input is charged its fused count's own footprint (FUSED_BYTES), which
  does not shrink with the ratio; the out-of-core job counts device slices
  small enough for -M (SLICE_BYTES), and a rank of a multi-process job
  slices small enough for its exchange too (MESH_SLICE_BYTES);
- an in-core job that was promoted by the measurement and then runs out of
  device memory (torch.cuda.OutOfMemoryError) is redone out of core;
- -R keeps the out-of-core spill and its manifest when a run fails, and a
  rerun with the same inputs and flags resumes after the last batch that
  was spilled whole. -R also keeps the plan off the measurement.

The device's memory is FASTK_TPU_HBM_GB when set, else the card's own (13 GB
on the CPU, as the JAX CLI assumes). FASTK_TPU_BATCH_BASES caps the batch.
FASTK_TPU_TRACE=<dir> writes a torch.profiler trace of the run (CUDA
activity included on the card) as Chrome trace JSON into <dir>. Under a
recording profiler (that one, or a caller's) the job keeps a record of its
spans and counters (``fastk_tpu_torch.trace``), whose fastk:<span> ranges
share the trace's timeline. On failure the partial file-sets are removed.

Multi-process runs: start one process a card with FASTK_TPU_COORD
(host:port of rank 0), FASTK_TPU_NPROCS (the number of processes) and
FASTK_TPU_PROC (this one's rank), as for the JAX CLI. The processes join
one torch.distributed world (NCCL on cards, gloo with device="cpu"), each
counts its share of the input files and of the keyspace
(``parallel/meshooc.py``, or ``parallel/host.py``'s relative profiles for
-p:<table>) and streams its slice file-sets ``<out>.<rank>``; rank 0 then
writes the histogram and splices the slices into ``<out>`` (fastcat).
"""

from __future__ import annotations

import gc
import gzip
import math
import os
import resource
import sys
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from fastk_tpu_torch import trace
from fastk_tpu_torch.formats.hist import write_histogram
from fastk_tpu_torch.formats.ktab import read_ktab
from fastk_tpu_torch.io.reader import batched_reads
from fastk_tpu_torch.ops.count import unique_batch
from fastk_tpu_torch.ops.pack import device_codes
from fastk_tpu_torch.ops.kmers import pad_needed
from fastk_tpu_torch.parallel.multihost import init_from_env, rank_device
from fastk_tpu_torch.pipeline.count import (
    MAX_DEVICE_POSITIONS,
    _code_slices,
    count_files,
)
from fastk_tpu_torch.pipeline.outofcore import count_files_ooc
from fastk_tpu_torch.tools._cli import die, print_number, source_root

# The port's device footprints, peaks of torch.cuda.max_memory_allocated
# on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 11; PERF.md):
# the in-core job per record of its per-batch unique blocks (135.5 B at 600
# Mbp -t3), with -p also per position (68.8 B at 200 Mbp -t3 -p), and one
# out-of-core part merge with want_back per record, operands included
# (142.0 B at 4.4e7 records). From chip_smoke.py phase 14e, the peak less
# what was allocated before: the fused single-batch -p job (count_batch)
# per position of its input (141.1 B at 60 Mbp -t3 -p), and a device
# slice's dedup per slice position, which sets the out-of-core and mesh
# jobs' phase-1 peak (126.2 B, unique_batch_inst at 2^26 positions, k=40).
# From chip_smoke.py phase 15c, a rank's peak in the multi-process mesh job
# (-k40 -t3 -p, four ranks) per position of its device slice, the routed
# exchange's send and receive lanes included (429 B at 4.2e6 positions).
UNIQUE_BYTES = 136
POSITION_BYTES = 69
MERGE_BYTES = 142
FUSED_BYTES = 142
SLICE_BYTES = 127
MESH_SLICE_BYTES = 430

USAGE = """Usage: fastk [-k<int(40)>] [-t[<int(1)>]] [-p[:<table>[.ktab]]] [-c] [-bc<int>]
             [-v] [-N<path_name>] [-P<dir($TMPDIR)>] [-M<int(12)>] [-T<int(4)>]
                 <source>[.cram|.[bs]am|.db|.dam|.f[ast][aq][.gz] ..."""


def parse_argv(argv):
    """The JAX CLI's flag parser (``fastk_tpu/tools/fastk.py``), copied."""
    cfg = dict(k=40, t=None, p=False, ptable=None, c=False, bc=0, v=False,
               N=None, P=os.environ.get("TMPDIR", "/tmp"), M=12, T=4,
               R=False, inputs=[])
    for a in argv:
        if a in ("-R", "--resume"):
            # staged restart (reference DEVELOPER mode, FastK.c:302-315):
            # keep the out-of-core spill on failure and re-enter after the
            # last completed batch on rerun
            cfg["R"] = True
        elif a.startswith("-k"):
            cfg["k"] = int(a[2:])
        elif a == "-t":
            cfg["t"] = 1
        elif a.startswith("-t"):
            cfg["t"] = int(a[2:])
        elif a == "-p":
            cfg["p"] = True
        elif a.startswith("-p:"):
            cfg["p"] = True
            cfg["ptable"] = a[3:]
        elif a == "-c":
            cfg["c"] = True
        elif a.startswith("-bc"):
            cfg["bc"] = int(a[3:])
        elif a == "-v":
            cfg["v"] = True
        elif a.startswith("-N"):
            cfg["N"] = a[2:]
        elif a.startswith("-P"):
            cfg["P"] = a[2:]
        elif a.startswith("-M"):
            cfg["M"] = int(a[2:])
        elif a.startswith("-T"):
            cfg["T"] = int(a[2:])
        elif a.startswith("-"):
            die(f"fastk: {a} is an illegal option\n{USAGE}")
        else:
            cfg["inputs"].append(a)
    if not cfg["inputs"]:
        die(USAGE)
    if cfg["k"] < 5:
        die("fastk: k must be at least 5")
    if cfg["k"] > 256:
        # the reference breaks for k ≳ 128 (README.md:239); the W=ceil(k/16)
        # word pipeline here is brute-force-validated through k=256
        # (tests/test_k_range.py), gated there pending larger-k validation
        die("fastk: k must be at most 256")
    return cfg


def _clean_outputs(out_base: str) -> None:
    """Remove partial output file-sets on failure (the Clean_Exit analog,
    reference FastK.c:181-221)."""
    from fastk_tpu_torch.tools.fastrm import remove_set

    for ext in (".hist", ".ktab", ".prof"):
        try:
            remove_set(out_base + ext, force=True)
        except Exception:
            pass


class _Timer:
    """The timeTo analog (FastK.c:104-175): per-phase user/sys/wall deltas
    and %utilization in the reference's format ("M:SS.mmm" past a minute,
    else "S.mmm", tagged u/s/w), plus a Total line with peak RSS in MB."""

    def __init__(self):
        self._mark = self._now()
        self._init = self._mark

    @staticmethod
    def _now():
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return (ru.ru_utime, ru.ru_stime, time.time(), ru.ru_maxrss)

    @staticmethod
    def _fmt(secs: float, tag: str) -> str:
        ms = int(round(secs * 1000))
        if secs >= 60:
            return f"{ms // 60000}:{(ms // 1000) % 60:02d}.{ms % 1000:03d}{tag}"
        return f"{ms // 1000}.{ms % 1000:03d}{tag}"

    def _line(self, label: str, base) -> tuple:
        now = self._now()
        u, s, w = (now[i] - base[i] for i in range(3))
        txt = (f"{label}  {self._fmt(u, 'u')}  {self._fmt(s, 's')}"
               f"  {self._fmt(w, 'w')}  {100 * (u + s) / max(w, 1e-9):.1f}%")
        return txt, now

    def phase(self) -> None:
        txt, now = self._line("\n  Resources for phase:", self._mark)
        print(txt, file=sys.stderr)
        self._mark = now

    def total(self) -> None:
        txt, now = self._line("\nTotal Resources:", self._init)
        # linux ru_maxrss is KB (the reference's /1000000 assumes bytes)
        print(f"{txt}  {print_number(now[3] // 1000)}MB", file=sys.stderr)


def _batch_bases(cfg) -> int:
    """Bases per batch: the -M memory budget at ~24 bytes a base, capped by
    FASTK_TPU_BATCH_BASES (at least 2^20) when it is set."""
    batch_bases = min(256 << 20, int(cfg["M"] * 1e9 / 24))
    env_cap = os.environ.get("FASTK_TPU_BATCH_BASES")
    if env_cap:
        batch_bases = min(batch_bases, max(1 << 20, int(env_cap)))
    return batch_bases


def _gz_density(f: str) -> Optional[float]:
    """Measured expansion of a gzip member from its first 4 MB:
    decompressed bytes / compressed bytes consumed."""
    try:
        with open(f, "rb") as raw:
            with gzip.GzipFile(fileobj=raw) as g:
                data = g.read(4 << 20)
            used = raw.tell()
        if not data or used <= 0:
            return None
        return len(data) / used
    except OSError:
        return None


def _est_base_bytes(f: str, heuristic: List[str]) -> int:
    """Estimated base count of an input: its size corrected for the
    container. gzip expansion is measured from the file's head (sequence is
    about half of FASTQ text, most of FASTA); a Dazzler stub points at a
    2-bit .bps of 4 bases a byte; BAM/CRAM take a x6 guess, and their names
    go into `heuristic`."""
    if not os.path.exists(f):
        return 0
    sz = os.path.getsize(f)
    low = f.lower()
    if low.endswith((".db", ".dam")):
        from fastk_tpu_torch.io.dazz import _hidden

        bps = _hidden(f, ".bps")
        if os.path.exists(bps):
            return os.path.getsize(bps) * 4
        return sz
    if low.endswith(".gz"):
        dens = _gz_density(f)
        if dens is None:
            heuristic.append(os.path.basename(f))
            return sz * 4
        seq_frac = 0.5 if ".fastq" in low or ".fq" in low else 0.9
        return int(sz * dens * seq_frac)
    if low.endswith((".bam", ".cram")):
        heuristic.append(os.path.basename(f))
        return sz * 6
    return sz


def _device_budget(dev: torch.device) -> float:
    """Device bytes the plan may fill: FASTK_TPU_HBM_GB when set, else the
    card's memory (13 GB on the CPU, the JAX CLI's default)."""
    env = os.environ.get("FASTK_TPU_HBM_GB")
    if env:
        return float(env) * 1e9
    if dev.type == "cuda":
        return float(torch.cuda.get_device_properties(dev).total_memory)
    return 13e9


def _incore_bytes(est_bases: int, ratio: float, profiles: bool,
                  fused: bool = False) -> float:
    """The in-core job's device footprint at a dedup ratio of `ratio`
    uniques per position (1 is the worst case). fused: the input is one
    batch with -p, which count_files counts in one fused count_batch
    whatever the ratio."""
    if fused:
        return est_bases * FUSED_BYTES
    if profiles:
        return est_bases * (POSITION_BYTES + ratio * UNIQUE_BYTES)
    return est_bases * ratio * UNIQUE_BYTES


def _slice_positions(M: float, nbytes: int = SLICE_BYTES) -> int:
    """Positions of an out-of-core or mesh job's device slice under -M: the
    largest power of two whose dedup (nbytes a position: SLICE_BYTES, or
    MESH_SLICE_BYTES for a rank of a multi-process job) fits, within
    [2^20, MAX_DEVICE_POSITIONS]."""
    fit = max(1 << 20, int(M * 1e9) // nbytes)
    return min(MAX_DEVICE_POSITIONS, 1 << (fit.bit_length() - 1))


def _ooc_plan(est_bases: int, M: float, profiles: bool, hbm: float) -> tuple:
    """(parts, part_cap) of the worst-case plan; parts == 1 means in core.

    In core when the worst-case footprint fits both the device budget `hbm`
    and -M (the reference's SORT_MEMORY). Otherwise a part merge may hold
    part_cap = M / MERGE_BYTES records (within [2^22, 2^26]), and parts =
    ceil(est_bases / part_cap): the peak stays flat however large the input
    grows."""
    part_cap = min(1 << 26, max(1 << 22, int(M * 1e9) // MERGE_BYTES))
    if _incore_bytes(est_bases, 1.0, profiles) <= min(hbm, M * 1e9):
        return 1, part_cap
    return max(2, math.ceil(est_bases / part_cap)), part_cap


def _measure_dedup(inputs, k, batch_bases, hc, bc, dev,
                   max_size: int = MAX_DEVICE_POSITIONS) -> Optional[float]:
    """The first slice's dedup ratio (uniques / valid positions), counted
    on the device: one bounded batch read, uploaded and put through
    unique_batch, in a slice of at most max_size positions (the CLI passes
    its -M slice, so that the measurement keeps to -M too). None for an
    empty input or one without a valid position; any other failure
    raises. Traced: part of the span plan, and the waits plan_nvalid and
    plan_nuniq."""
    with trace.span("plan"):
        gen = batched_reads(list(inputs), min(batch_bases, 64 << 20), hc=hc,
                            bc=bc)
        first = next(gen, None)
        gen.close()
        if first is None:
            return None
        _off, size, buf = next(_code_slices(first[0].codes, k, max_size))
        res = unique_batch(device_codes(buf, dev), k, size)
        with trace.wait("plan_nvalid"):
            nval = int(res["nvalid"])
        if nval <= 0:
            return None
        with trace.wait("plan_nuniq"):
            return int(res["nuniq"]) / nval


def main(argv=None, device="cuda") -> int:
    cfg = parse_argv(sys.argv[1:] if argv is None else argv)
    for p in cfg["inputs"]:
        if not os.path.exists(p):
            die(f"fastk: cannot open {p}")
    out_base = cfg["N"] or source_root(cfg["inputs"][0])
    joined = dist.is_initialized()
    pid, nprocs = init_from_env(device)
    dev = rank_device(device, pid)
    try:
        trace_dir = os.environ.get("FASTK_TPU_TRACE")
        if not trace_dir:
            with trace.job():
                return _run(cfg, out_base, dev, pid, nprocs)
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        try:
            with trace.job():
                return _run(cfg, out_base, dev, pid, nprocs)
        finally:
            prof.stop()
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(trace_dir, f"fastk.{os.getpid()}.trace.json"))
    finally:
        if not joined and dist.is_initialized():
            dist.destroy_process_group()  # the world this call joined


def _run(cfg, out_base: str, dev: torch.device, pid: int = 0,
         nprocs: int = 1) -> int:
    timer = _Timer()
    rel = None
    if cfg["ptable"]:
        with trace.span("relative_table.read"):
            rel = read_ktab(cfg["ptable"])
        if rel.kmer != cfg["k"]:
            die(f"fastk: -p table k-mer size ({rel.kmer}) != k-mer "
                f"specified ({cfg['k']})")
        if cfg["t"] is not None:
            if cfg["v"]:
                print(f"fastk: Warning: -p:{cfg['ptable']} overides -t "
                      "option", file=sys.stderr)
            cfg["t"] = None

    batch_bases = _batch_bases(cfg)
    heuristic: List[str] = []
    with trace.span("plan"):
        est_bases = sum(_est_base_bytes(f, heuristic) for f in cfg["inputs"])
        hbm = _device_budget(dev)
        parts, part_cap = _ooc_plan(est_bases, cfg["M"], cfg["p"], hbm)
    if cfg["v"] and heuristic:
        print("  base estimate for "
              + ", ".join(heuristic[:4])
              + (" ..." if len(heuristic) > 4 else "")
              + " is a container heuristic (x6); the measured first-batch"
              " plan and part sub-splitting absorb the error",
              file=sys.stderr)
    nparts = max(1, cfg["T"])
    slice_positions = _slice_positions(
        cfg["M"], MESH_SLICE_BYTES if nprocs > 1 else SLICE_BYTES)
    if nprocs > 1:
        try:
            return _run_mesh(cfg, out_base, rel, batch_bases, nparts,
                             part_cap, est_bases, slice_positions, pid,
                             nprocs, dev)
        except BaseException:
            _clean_outputs(out_base if pid == 0 else f"{out_base}.{pid}")
            raise
    ooc_kw = dict(est_bases=est_bases, sort_path=cfg["P"],
                  table_min=cfg["t"], profiles=cfg["p"], hc=cfg["c"],
                  bc=cfg["bc"], batch_bases=batch_bases, verbose=cfg["v"],
                  out_base=out_base, out_nparts=nparts, part_cap=part_cap,
                  slice_positions=slice_positions, device=dev)
    # one batch with -p runs as one fused count_batch (pipeline/count.py)
    fused = (cfg["p"] and rel is None and est_bases <= batch_bases
             and est_bases + pad_needed(cfg["k"]) <= MAX_DEVICE_POSITIONS)

    try:
        measured_incore = False
        if parts > 1 and rel is None and not cfg["R"]:
            # the worst case did not fit: measure the first slice's dedup
            # ratio and stay in core when the measured footprint fits. -R
            # keeps the worst-case plan: its manifest is the out-of-core
            # path's
            ratio = _measure_dedup(cfg["inputs"], cfg["k"], batch_bases,
                                   cfg["c"], cfg["bc"], dev, slice_positions)
            if ratio is not None:
                in_bytes = _incore_bytes(est_bases, ratio, cfg["p"], fused)
                if in_bytes <= min(hbm, cfg["M"] * 1e9):
                    if cfg["v"]:
                        print(f"  measured dedup ratio {ratio:.3f}: "
                              "in-core (footprint "
                              f"{in_bytes / 1e9:.1f}GB fits)",
                              file=sys.stderr)
                    parts = 1
                    measured_incore = True
        if parts > 1 and rel is None:
            if cfg["v"]:
                print(f"  out-of-core: <= {parts} keyspace parts under "
                      f"{cfg['M']}GB budget (measured plan follows)",
                      file=sys.stderr)
            out = count_files_ooc(cfg["inputs"], cfg["k"], None,
                                  resume=cfg["R"], **ooc_kw)
        else:
            out = None
            try:
                out = count_files(
                    cfg["inputs"], cfg["k"], table_min=cfg["t"],
                    profiles=cfg["p"], hc=cfg["c"], bc=cfg["bc"],
                    batch_bases=batch_bases, relative_table=rel,
                    verbose=cfg["v"], out_base=out_base, out_nparts=nparts,
                    device=dev)
            except torch.cuda.OutOfMemoryError:
                # a measured promotion can lose to a tail whose dedup
                # collapses; leaving this clause drops the traceback that
                # holds the attempt's tensors
                if not measured_incore:
                    raise
            if out is None:
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                if cfg["v"]:
                    print("  in-core attempt exhausted device memory;"
                          " falling back to out-of-core", file=sys.stderr)
                _clean_outputs(out_base)
                out = count_files_ooc(cfg["inputs"], cfg["k"], None,
                                      **ooc_kw)

        if out.nshort:
            print(f"Warning: {print_number(out.nshort)} reads are shorter "
                  f"than the k-mer size ({cfg['k']}) and contribute no "
                  "k-mers", file=sys.stderr)
        if cfg["v"]:
            print(f"  {print_number(out.nreads)} reads, "
                  f"{print_number(out.totlen)} bases", file=sys.stderr)
            timer.phase()
        # .ktab and .prof were streamed by the pipeline
        if rel is None:
            with trace.span("hist_write"):
                write_histogram(out_base, out.hist)
            if cfg["t"] is not None and cfg["v"]:
                print(f"  There are {print_number(out.table_entries)} "
                      f"{cfg['k']}-mers that occur {cfg['t']}-or-more "
                      "times", file=sys.stderr)
    except BaseException:
        _clean_outputs(out_base)
        raise
    if cfg["v"]:
        timer.phase()
        timer.total()
    return 0


def _run_mesh(cfg, out_base, rel, batch_bases, nparts, part_cap, est_bases,
              slice_positions, pid, nprocs, dev) -> int:
    """The multi-process job body: every rank runs the same lockstep mesh
    program over its file shard and streams `<out>.<rank>` slice file-sets;
    rank 0 splices them (fastcat) into `<out>` and writes the histogram."""
    from fastk_tpu_torch.parallel.meshooc import count_files_mesh, default_mesh
    from fastk_tpu_torch.parallel.multihost import _barrier

    mesh = default_mesh(dev)
    if cfg["v"] and pid == 0:
        print(f"  multi-process: {nprocs} processes, one {dev.type} device "
              "each", file=sys.stderr)
    if rel is not None:
        from fastk_tpu_torch.parallel.host import relative_profiles_sharded

        out = relative_profiles_sharded(
            cfg["inputs"], rel, mesh, batch_bases=batch_bases,
            verbose=cfg["v"], out_base=out_base, out_nparts=nparts)
    else:
        # per-rank keyspace parts sized so that no phase-2 merge load
        # exceeds the -M-derived part_cap even at a worst-case spill
        ppc = max(1, min(256, -(-est_bases // (nprocs * part_cap))))
        out = count_files_mesh(
            cfg["inputs"], cfg["k"], mesh=mesh, table_min=cfg["t"],
            profiles=cfg["p"], batch_bases=batch_bases, sort_path=cfg["P"],
            out_base=out_base, out_nparts=nparts, part_cap=part_cap,
            parts_per_chip=ppc, hc=cfg["c"], bc=cfg["bc"],
            verbose=cfg["v"], resume=cfg["R"],
            slice_positions=slice_positions)
    _barrier()
    if pid == 0:
        from fastk_tpu_torch.tools.fastcat import (
            cat_profiles_spliced,
            cat_tables_spliced,
            cat_tables_streamed,
        )
        from fastk_tpu_torch.tools.fastrm import remove_set

        slices = [f"{out_base}.{q}" for q in range(nprocs)]
        if rel is None:
            write_histogram(out_base, out.hist)
            if cfg["t"] is not None:
                # destructive splice: O(1) hardlink of slice parts
                if not cat_tables_spliced(slices, out_base, keep=False):
                    cat_tables_streamed(slices, out_base, nparts)
        if cfg["p"]:
            cat_profiles_spliced(slices, out_base, keep=False)
        for s in slices:
            for ext in (".ktab", ".prof"):
                try:
                    remove_set(s + ext, force=True)
                except Exception:
                    pass
        if cfg["v"]:
            print(f"  spliced {nprocs} rank slices into {out_base}",
                  file=sys.stderr)
    # ranks leave together, so slice files outlive every reader
    _barrier()
    return 0


if __name__ == "__main__":
    sys.exit(main())
