"""Bounded host memory: the peak RSS of the port's out-of-core CLI (-M1)
and of its count_files_mesh as the input grows; the port's counterpart of
``benchmarks/bench_rss.py``.

    python -m fastk_tpu_torch.probes.rss [--sizes MB ...] [-k K] [--mesh]
        [--device cuda|cpu]

FastK's defining claim is bounded memory at any input size: `-M` bounds
it. Each size runs in a fresh subprocess (ru_maxrss is a process-lifetime
maximum) on random bases, and its peak RSS is read as the JAX script reads
it: from the CLI's Total line, or from ru_maxrss after count_files_mesh.
The verdict is the JAX script's: peak_rss(big) - peak_rss(small) of the two
largest sizes must stay under a quarter of the ~5 B a base (1 B codes + 4 B
positions) that a design keeping its input would add. Exit code 0 on PASS,
1 on FAIL.

On the card each run also reports the device peak
(torch.cuda.max_memory_allocated), the pinned-host cache of torch's caching
host allocator (torch.cuda.host_memory_stats: its pinned blocks, in use
and cached, now and at their peak) and the run_hist kernel's launches. Every
result is also set beside the floor that the CUDA runtime alone costs
(``runtime_rss``: a process that imports the port and makes one tensor on
the device). The batches are the -M1 plan's own unless the caller's
environment sets FASTK_TPU_BATCH_BASES.

--device defaults to cuda and raises without a card; a failed subprocess
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np

from fastk_tpu_torch.device import resolve_device

K = 40
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CHILD = ("import sys\n"
          "from fastk_tpu_torch.probes import rss\n"
          "sys.exit(rss._child(sys.argv[1:]))\n")
# A process's ru_maxrss starts at the high-water RSS of the one that started
# it (exec keeps the mark of the address space it replaces), so a small
# process in between starts each measured one.
_LAUNCH = ("import subprocess, sys\n"
           "sys.exit(subprocess.run([sys.executable, *sys.argv[1:]])"
           ".returncode)\n")
_TOTAL = re.compile(r"^Total Resources:.*?([\d,]+)MB\s*$", re.M)


def make_fasta(path: str, nbases: int, seed: int = 0,
               read_len: int = 20_000) -> None:
    """Random ACGT reads of read_len bases (the last one shorter), nbases in
    all: the bytes of benchmarks/bench_rss.py's make_fasta."""
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        done = 0
        i = 0
        while done < nbases:
            n = min(read_len, nbases - done)
            seq = lut[rng.integers(0, 4, n)].tobytes()
            f.write(b">r%d\n%s\n" % (i, seq))
            done += n
            i += 1


def _device_line(device) -> dict:
    """This process's peak RSS (MB of 1000 KB, as the CLI prints it), and
    on the card its device peak, the pinned-host cache's current and peak
    bytes and run_hist's launches."""
    import torch

    from fastk_tpu_torch.ops.histker import run_hist

    dev = torch.device(device)
    line = {"rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            // 1000, "device_peak_bytes": None,
            "pinned_current_bytes": None, "pinned_peak_bytes": None,
            "run_hist_launches": run_hist.launches}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        line["device_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        host = torch.cuda.host_memory_stats()
        line["pinned_current_bytes"] = host["allocated_bytes.current"]
        line["pinned_peak_bytes"] = host["allocated_bytes.peak"]
    return line


def _child(argv) -> int:
    """A measured subprocess: `cli device argv...`, `mesh device fasta k
    workdir` or `runtime device`. Prints its device line as the last line
    of its standard output."""
    mode, device = argv[0], argv[1]
    if mode == "cli":
        from fastk_tpu_torch.tools.fastk import main

        rc = main(argv[2:], device=device)
        if rc != 0:
            return rc
    elif mode == "mesh":
        from fastk_tpu_torch.formats.hist import write_histogram
        from fastk_tpu_torch.parallel.dist import make_mesh
        from fastk_tpu_torch.parallel.meshooc import count_files_mesh
        from fastk_tpu_torch.tools import fastk as cli

        fasta, k, workdir = argv[2], int(argv[3]), argv[4]
        mesh = make_mesh(device=device)  # a world of one, outside any group
        est = os.path.getsize(fasta)
        # the CLI's -M1 plan, as its multi-process job plans a rank
        _parts, part_cap = cli._ooc_plan(est, 1, True,
                                         cli._device_budget(mesh.device))
        out_base = os.path.join(workdir, "mesh")
        out = count_files_mesh(
            [fasta], k, mesh=mesh, table_min=1, profiles=True,
            batch_bases=cli._batch_bases({"M": 1}), sort_path=workdir,
            out_base=out_base, part_cap=part_cap,
            parts_per_chip=max(1, min(256, -(-est // part_cap))),
            slice_positions=cli._slice_positions(1))
        write_histogram(out_base, out.hist)
    elif mode == "runtime":
        import torch

        import fastk_tpu_torch.parallel.meshooc  # noqa: F401
        import fastk_tpu_torch.tools.fastk  # noqa: F401

        torch.ones(1, device=resolve_device(device))
    print(json.dumps(_device_line(device)), flush=True)
    return 0


def _spawn(args, what: str) -> tuple:
    """Run a measured subprocess from the repo's root, started by a small
    one; (its device line, its standard error, wall s). Raises when it
    fails."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _LAUNCH, "-c", _CHILD, *args],
                       capture_output=True, text=True, cwd=REPO)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"{what} failed (rc {r.returncode}):\n"
                           + r.stderr[-2000:])
    return json.loads(r.stdout.strip().splitlines()[-1]), r.stderr, wall


def _result(fasta: str, line: dict, rss_mb: int, wall: float) -> dict:
    return {"input_bases": os.path.getsize(fasta), "peak_rss_mb": rss_mb,
            "device_peak_bytes": line["device_peak_bytes"],
            "pinned_current_bytes": line["pinned_current_bytes"],
            "pinned_peak_bytes": line["pinned_peak_bytes"],
            "run_hist_launches": line["run_hist_launches"],
            "wall_s": wall}


def run_one(fasta: str, workdir: str, k: int, device="cuda") -> dict:
    """The CLI out of core (-k<k> -t1 -v -M1 -P<workdir>) in a fresh
    subprocess, its outputs at <workdir>/out; peak RSS from its Total
    line, and out_of_core: whether the plan put the job out of core."""
    resolve_device(device)
    out_base = os.path.join(workdir, "out")
    line, err, wall = _spawn(
        ["cli", str(device), f"-k{k}", "-t1", "-v", "-M1", f"-P{workdir}",
         fasta, f"-N{out_base}"], f"the CLI on {fasta}")
    m = _TOTAL.search(err)
    if m is None:
        raise RuntimeError("the CLI printed no Total line:\n" + err[-2000:])
    res = _result(fasta, line, int(m.group(1).replace(",", "")), wall)
    res["out_of_core"] = "out-of-core:" in err
    return res


def run_one_mesh(fasta: str, workdir: str, k: int, device="cuda") -> dict:
    """count_files_mesh (table_min=1, profiles, the -M1 plan) in a world of
    one in a fresh subprocess, its outputs at <workdir>/mesh; peak RSS from
    ru_maxrss. On the card its owner counts must launch run_hist."""
    dev = resolve_device(device)
    line, _err, wall = _spawn(["mesh", str(device), fasta, str(k), workdir],
                              f"count_files_mesh on {fasta}")
    if dev.type == "cuda" and line["run_hist_launches"] <= 0:
        raise AssertionError("count_files_mesh launched no run_hist kernel")
    return _result(fasta, line, line["rss_mb"], wall)


def runtime_rss(device="cuda") -> int:
    """Peak RSS (MB) of a process that imports the port and makes one
    tensor on the device: the floor that the runtime alone costs."""
    resolve_device(device)
    return _spawn(["runtime", str(device)], "the runtime floor")[0]["rss_mb"]


def flatness(results, sizes) -> dict:
    """The JAX script's verdict on the two largest sizes (MB): PASS when the
    peak RSS grows by less than a quarter of 5 B a base."""
    small, big = results[-2], results[-1]
    delta = big["peak_rss_mb"] - small["peak_rss_mb"]
    naive = 5 * (sizes[-1] - sizes[-2])  # ~5 B/base if retained
    return {"metric": "peak-RSS delta past the -M part-size plateau",
            "delta_mb": delta, "naive_retained_mb": naive,
            "verdict": "PASS" if delta < naive / 4 else "FAIL"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fastk_tpu_torch.probes.rss")
    ap.add_argument("--sizes", type=int, nargs="+", default=[80, 240],
                    help="MB of bases per run; the two largest are compared")
    ap.add_argument("-k", type=int, default=K)
    ap.add_argument("--mesh", action="store_true",
                    help="measure count_files_mesh in a world of one instead "
                    "of the CLI")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if len(args.sizes) < 2:
        ap.error("--sizes needs two sizes or more")
    resolve_device(args.device)
    floor = runtime_rss(args.device)
    results = []
    for mb in args.sizes:
        with tempfile.TemporaryDirectory(prefix="fkrss") as d:
            fasta = os.path.join(d, "in.fasta")
            make_fasta(fasta, mb << 20)
            res = (run_one_mesh if args.mesh else run_one)(
                fasta, d, args.k, args.device)
        res["label"] = f"{mb}MB"
        res["above_runtime_mb"] = res["peak_rss_mb"] - floor
        print(json.dumps(res), flush=True)
        results.append(res)
    verdict = flatness(results, args.sizes)
    verdict["runtime_rss_mb"] = floor
    verdict["device"] = args.device
    print(json.dumps(verdict))
    return 0 if verdict["verdict"] == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
