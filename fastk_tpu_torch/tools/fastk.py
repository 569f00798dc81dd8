"""The port's ``fastk`` CLI: the counting job on the card, in core or out of
core.

    python -m fastk_tpu_torch.tools.fastk [-k<int(40)>] [-t[<int(1)>]]
        [-p[:<table>[.ktab]]] [-c] [-bc<int>] [-v] [-N<path_name>]
        [-P<dir($TMPDIR)>] [-M<int(12)>] [-T<int(4)>] [-R]
        <source>[.fast[aq][.gz]] ...

Writes <source>.hist (or <path_name>.hist), <source>.ktab with -t and
<source>.prof with -p, each table and profile set in -T parts. With
-p:<table> only the relative profiles are written, and -t is ignored. Flags
and their parsing are the JAX package's (``fastk_tpu.tools.fastk
.parse_argv``), and so is the plan:

- the input's bases are estimated from its files (gzip expansion measured
  from the head, Dazzler's 2-bit .bps, a x6 guess for BAM/CRAM);
- the job runs in core when its worst-case footprint (every position
  unique) fits both -M and the device's memory; otherwise the first slice's
  measured dedup ratio (uniques / valid positions) decides, and if the
  measured footprint still does not fit, the job runs out of core
  (``pipeline/outofcore.py``) with its spills under -P;
- an in-core job that was promoted by the measurement and then runs out of
  device memory (torch.cuda.OutOfMemoryError) is redone out of core;
- -R keeps the out-of-core spill and its manifest when a run fails, and a
  rerun with the same inputs and flags resumes after the last batch that
  was spilled whole. -R also keeps the plan off the measurement.

The device's memory is FASTK_TPU_HBM_GB when set, else the card's own (13 GB
on the CPU, as the JAX CLI assumes). FASTK_TPU_BATCH_BASES caps the batch.
FASTK_TPU_TRACE=<dir> writes a torch.profiler trace of the run (CUDA
activity included on the card) as Chrome trace JSON into <dir>. On failure
the partial file-sets are removed. Multi-host runs (FASTK_TPU_COORD with
FASTK_TPU_NPROCS > 1) are not ported and stop with an error.
"""

from __future__ import annotations

import gc
import gzip
import math
import os
import sys
from typing import List, Optional

import torch

from fastk_tpu.formats.hist import write_histogram
from fastk_tpu.formats.ktab import read_ktab
from fastk_tpu.io.reader import batched_reads
from fastk_tpu.tools._cli import die, print_number, source_root
from fastk_tpu.tools.fastk import _clean_outputs, _Timer, parse_argv
from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.count import unique_batch
from fastk_tpu_torch.ops.pack import upload_packed
from fastk_tpu_torch.pipeline.count import _packed_slices, count_files
from fastk_tpu_torch.pipeline.outofcore import count_files_ooc

# The port's device footprints, peaks of torch.cuda.max_memory_allocated
# on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 11; PERF.md):
# the in-core job per record of its per-batch unique blocks (135.5 B at 600
# Mbp -t3), with -p also per position (68.8 B at 200 Mbp -t3 -p), and one
# out-of-core part merge with want_back per record, operands included
# (142.0 B at 4.4e7 records).
UNIQUE_BYTES = 136
POSITION_BYTES = 69
MERGE_BYTES = 142


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
        from fastk_tpu.io.dazz import _hidden

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


def _incore_bytes(est_bases: int, ratio: float, profiles: bool) -> float:
    """The in-core job's device footprint at a dedup ratio of `ratio`
    uniques per position (1 is the worst case)."""
    if profiles:
        return est_bases * (POSITION_BYTES + ratio * UNIQUE_BYTES)
    return est_bases * ratio * UNIQUE_BYTES


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


def _measure_dedup(inputs, k, batch_bases, hc, bc, dev) -> Optional[float]:
    """The first slice's dedup ratio (uniques / valid positions), counted
    on the device: one bounded batch read, packed, uploaded and put through
    unique_batch. None for an empty input or one without a valid position;
    any other failure raises."""
    gen = batched_reads(list(inputs), min(batch_bases, 64 << 20), hc=hc,
                        bc=bc)
    first = next(gen, None)
    gen.close()
    if first is None:
        return None
    off, size, pw, exc, blen = next(_packed_slices(first[0].codes, k))
    res = unique_batch(upload_packed(pw, exc, blen, dev), k, size)
    nval = int(res["nvalid"])
    if nval <= 0:
        return None
    return int(res["nuniq"]) / nval


def main(argv=None, device="cuda") -> int:
    cfg = parse_argv(sys.argv[1:] if argv is None else argv)
    for p in cfg["inputs"]:
        if not os.path.exists(p):
            die(f"fastk: cannot open {p}")
    if (os.environ.get("FASTK_TPU_COORD")
            and int(os.environ.get("FASTK_TPU_NPROCS", "1")) > 1):
        die("fastk: multi-host runs are not yet ported")
    out_base = cfg["N"] or source_root(cfg["inputs"][0])
    dev = resolve_device(device)
    trace_dir = os.environ.get("FASTK_TPU_TRACE")
    if not trace_dir:
        return _run(cfg, out_base, dev)
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        return _run(cfg, out_base, dev)
    finally:
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(trace_dir, f"fastk.{os.getpid()}.trace.json"))


def _run(cfg, out_base: str, dev: torch.device) -> int:
    timer = _Timer()
    rel = None
    if cfg["ptable"]:
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
    est_bases = sum(_est_base_bytes(f, heuristic) for f in cfg["inputs"])
    if cfg["v"] and heuristic:
        print("  base estimate for "
              + ", ".join(heuristic[:4])
              + (" ..." if len(heuristic) > 4 else "")
              + " is a container heuristic (x6); the measured first-batch"
              " plan and part sub-splitting absorb the error",
              file=sys.stderr)
    hbm = _device_budget(dev)
    parts, part_cap = _ooc_plan(est_bases, cfg["M"], cfg["p"], hbm)
    nparts = max(1, cfg["T"])
    ooc_kw = dict(est_bases=est_bases, sort_path=cfg["P"],
                  table_min=cfg["t"], profiles=cfg["p"], hc=cfg["c"],
                  bc=cfg["bc"], batch_bases=batch_bases, verbose=cfg["v"],
                  out_base=out_base, out_nparts=nparts, part_cap=part_cap,
                  device=dev)

    try:
        measured_incore = False
        if parts > 1 and rel is None and not cfg["R"]:
            # the worst case did not fit: measure the first slice's dedup
            # ratio and stay in core when the measured footprint fits. -R
            # keeps the worst-case plan: its manifest is the out-of-core
            # path's
            ratio = _measure_dedup(cfg["inputs"], cfg["k"], batch_bases,
                                   cfg["c"], cfg["bc"], dev)
            if ratio is not None:
                in_bytes = _incore_bytes(est_bases, ratio, cfg["p"])
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


if __name__ == "__main__":
    sys.exit(main())
