"""One run of one cell: whole ``fastk`` jobs through the port's CLI entry, in a
closed loop over a window, then the check of the last job's outputs.

    python3 -m kbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``): the imports, the cell's inputs made from the seed in a
child process (so that its arrays do not count in this process's peak host
memory), CUDA's start, and one warm-up job. The window then runs jobs one
after another, each started when the last returns, until ``--seconds`` have
passed; the job that is running then runs to its end, and the window closes
when it does. Each job reads the inputs, plans, parses, packs, uploads,
counts on the card and writes its ``.hist`` (and ``.ktab``, ``.prof``) under
the same ``-N`` path.

With ``--trace 0`` the last line of standard output is the result with the
end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` with spans around calls into the port, and the result has
the per-layer metrics, the device's busy seconds and a breakdown instead.
After the window: the peaks are read, the port's state is freed, and the
plain reference counts the same inputs; each number compared is printed
beside its limit, on standard error and last in the result.

A cell with ``chips`` above 1 runs the port's multi-process CLI, one process
a card (``kbench/ranks.py``): this process is rank 0 and keeps the window,
its timing and the reference; the other ranks start in set-up, join one
world with it before the warm-up job and stay for the window, and each job
runs on every rank. Its ``device_peak_gb`` is the largest peak of any one
rank (what ``-M`` promises, and what a user sizes each card by), and its
``host_peak_gb`` the sum of the ranks' ``ru_maxrss``: the node's, an upper
bound, since the ranks' peaks need not fall at the same moment. With
``--trace 1`` only rank 0 is profiled: its timeline and its job records, so
a per-Gbp metric there is per Gbp of a rank's share, the job's bases over
its ranks (rank 0's own where the files split evenly among the ranks).

Without a CUDA card (or with fewer than the cell asks for), without the port,
with JAX or the JAX package loaded on any rank when the window has closed,
or when a rank dies or a wait for one passes its limit, the run prints no
result and exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fastk_tpu")
GEN_TIMEOUT_S = 300


class NotRun(Exception):
    """A run that cannot give a result: the reason goes to standard error."""


def loaded_forbidden() -> list:
    """JAX or the JAX package among the loaded modules, by whole top-level
    name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a per-layer metric's reader reads."""

    def __init__(self, spans, window_s, busy_s, jobs, bases):
        self.spans, self.window_s, self.busy_s = spans, window_s, busy_s
        self.jobs, self.bases = jobs, bases


def make_inputs(cell, seed, work, device):
    """Run the generator in a child process; returns its inputs.json."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cmd = [sys.executable, "-m", "kbench.gen", "--cell",
           json.dumps({"name": cell.name, "chips": cell.chips,
                       "config": cell.config, "traffic": cell.traffic}),
           "--seed", str(seed), "--dir", work, "--device", device]
    from kbench.spec import ROOT

    r = subprocess.run(cmd, cwd=ROOT, timeout=GEN_TIMEOUT_S)
    if r.returncode != 0:
        raise NotRun(f"the input generator exited with {r.returncode}")
    with open(os.path.join(work, "inputs.json")) as f:
        return json.load(f)


def run(workload, seed, seconds, trace, device="cuda", sample=None,
        t0=None):
    """One run; returns (result dict, {check name: (value, limit)}).

    device="cpu" runs the port and the reference on the CPU (the tests);
    sample overrides keys of the configuration's sample."""
    t0 = T0 if t0 is None else t0
    from kbench import ranks, spec

    cell = spec.load(workload, sample)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        raise NotRun(f"{workload} needs {cell.chips} CUDA card(s); "
                     f"torch.cuda.is_available() is "
                     f"{torch.cuda.is_available()}")
    try:
        from fastk_tpu_torch.ops import histker
        from fastk_tpu_torch.tools import fastk as cli
    except ImportError as e:
        raise NotRun(f"the port does not import: {e}") from e
    parts = {"import_s": time.perf_counter() - t0}
    # the other ranks start their imports while the inputs are made
    world = (ranks.World(cell.chips, device, spec.ROOT) if cell.chips > 1
             else None)
    try:
        return _measured(cell, seed, seconds, trace, device, t0, parts,
                         world)
    except ranks.Lost as e:
        raise NotRun(f"the world of {cell.chips} ranks was lost: {e}") from e
    finally:
        if world is not None:
            world.kill()


def _measured(cell, seed, seconds, trace, device, t0, parts, world):
    """run() from the inputs on; with world, rank 0 of it."""
    import torch

    from fastk_tpu_torch.ops import histker
    from fastk_tpu_torch.tools import fastk as cli
    from kbench import ranks, spec
    from kbench.roofline import HBM_BYTES_PER_S, power_limit

    work = spec.workdir(cell.name)
    t = time.perf_counter()
    inputs = make_inputs(cell, seed, work, device)
    parts["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if device == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    parts["cuda_s"] = time.perf_counter() - t
    if world is not None:
        t = time.perf_counter()
        world.join()
        parts["ranks_s"] = time.perf_counter() - t

    out_base = os.path.join(work, "out")
    argv = spec.job_argv(cell, inputs, out_base, work)

    def one_job(limit):
        """The job on every rank: each rank's seconds with a world."""
        if world is None:
            return job(cli, argv, device)
        return world.job(argv, lambda: job(cli, argv, device), limit)

    spans = metrics = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from kbench.spans import GAP_NAMES, Spans

        spans = Spans(record_function)
        metrics = {m["name"]: spec.metric_reader(m["name"])
                   for m in cell.per_layer}
        wanted = dict(GAP_NAMES)
        for mod in metrics.values():
            for name, tgt in mod.SPANS.items():
                wanted.setdefault(name, tgt)
        for name, tgt in wanted.items():
            target, bytes_of = (tgt, None) if isinstance(tgt, str) else tgt
            spans.install(name, target, bytes_of)
        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)

    t = time.perf_counter()
    if trace:  # the profiler's first start is slow: pay it in set-up
        with profile(activities=acts):
            one_job(ranks.WARMUP_S)
    else:
        one_job(ranks.WARMUP_S)
    parts["warmup_job_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0

    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if world is not None:
        world.reset_peaks()
    launches0 = histker.run_hist.launches
    hist_blobs = []
    attempted = failed = 0
    prof = None
    if trace:
        for st in spans.stats.values():
            st.__init__()
        prof = profile(activities=acts)
        prof.start()
        window_span = record_function("kbench:window")
        window_span.__enter__()
    job_s, job_cpu_s, rank_job_s = [], [], []
    w0 = time.perf_counter()
    while True:
        attempted += 1
        j0, c0 = time.perf_counter(), _cpu_s()
        try:
            if trace:
                with record_function("kbench:job"):
                    rank_s = one_job(ranks.JOB_S)
            else:
                rank_s = one_job(ranks.JOB_S)
        except ranks.Lost:
            raise
        except Exception as e:  # a failed job ends the window
            print(f"kbench: job {attempted} failed: {e!r}", file=sys.stderr)
            failed += 1
            break
        job_s.append(time.perf_counter() - j0)
        job_cpu_s.append([b - a for a, b in zip(c0, _cpu_s())])
        rank_job_s.append(rank_s)
        if "hist" in cell.traffic["outputs"]:
            with open(out_base + ".hist", "rb") as f:
                hist_blobs.append(f.read())
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    if trace:
        window_span.__exit__(None, None, None)
        prof.stop()
        spans.uninstall()
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    dev_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if world is not None:
        # the fullest card, and the node: every rank's own high-water mark
        # summed, an upper bound, since the ranks' peaks need not coincide
        others = world.close()
        for r, (_, _, found) in enumerate(others, 1):
            if found:
                raise NotRun(f"rank {r} loaded {', '.join(found)}")
        rank_peaks = [[dev_peak, host_peak]] + [[p, rss]
                                                for p, rss, _ in others]
        dev_peak = max(p for p, _ in rank_peaks)
        host_peak = sum(rss for _, rss in rank_peaks)
    launches = histker.run_hist.launches - launches0
    jobs = attempted - failed
    bases = jobs * inputs["bases"]

    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": {},
              "device": device_field(torch, device, dev_peak, cell.chips)}
    if trace:
        from kbench.spans import reduce_trace

        path = os.path.join(work, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        red = reduce_trace(path, spans.stats)
        os.unlink(path)
        # the records are rank 0's: per Gbp of a rank's share of the bases
        ctx = Context(spans.stats, red["window_s"], red["busy_s"], jobs,
                      bases / cell.chips)
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        for name, mod in metrics.items():
            value = mod.read(ctx)
            if value is not None:
                result["metrics"][name] = {"value": value,
                                           "unit": units[name]}
        result["device"]["busy_s"] = red["busy_s"]
        result["device"]["window_s"] = red["window_s"]
        result["breakdown"] = red["breakdown"]
        result["traced_bases_per_s"] = bases / window_s
    else:
        result["metrics"] = {
            "bases_per_s": {"value": bases / window_s, "unit": "bases/s"},
            "device_peak_gb": {"value": dev_peak / 1e9, "unit": "GB"},
            "host_peak_gb": {"value": host_peak / 1e9, "unit": "GB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    result["jobs"] = jobs
    result["window_s"] = window_s
    result["job_s"] = job_s
    result["job_cpu_s"] = job_cpu_s
    if world is not None:
        result["rank_job_s"] = rank_job_s  # rank 0's first
        result["rank_peaks"] = rank_peaks  # bytes: [device, ru_maxrss]
    result["setup_parts"] = parts
    result["run_hist_launches"] = launches
    result["hbm_peak_bytes_per_s"] = HBM_BYTES_PER_S
    result["power_limit"] = power_limit() if device == "cuda" else None

    # the reference, once the peaks are read and the port's state is freed
    from kbench.reference import compare

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    want = compare.expected(cell.traffic, cell.config["k"], inputs, device)
    checks = compare.judge(cell.config["k"], want, out_base, hist_blobs,
                           device)
    result["reference_s"] = time.perf_counter() - t
    limits = {n: (v, compare.LIMITS[n]) for n, v in checks.items()}
    result["correct"] = failed == 0 and jobs > 0 and all(
        v <= lim for v, lim in limits.values())
    shutil.rmtree(work, ignore_errors=True)
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in limits.items()}
    return result, limits


def _cpu_s():
    """(user, system) CPU seconds of this process so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime, ru.ru_stime


def job(cli, argv, device) -> None:
    """One fastk job of this process (one rank's share of it in a world),
    waited for on the card."""
    rc = cli.main(list(argv), device=device)
    if rc != 0:
        raise RuntimeError(f"fastk returned {rc}")
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def device_field(torch, device, peak, chips) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, limits = run(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    except NotRun as e:
        print(f"kbench: no result: {e}", file=sys.stderr)
        return 2
    found = loaded_forbidden()
    if found:
        print(f"kbench: no result: loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, (value, limit) in limits.items():
        print(f"kbench check {name}: {value} (limit {limit})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
