"""CPU tests of runs on more than one rank (kbench/ranks.py) and of samples
written as several read files: a trial cell of four ranks, injected through
a monkeypatched spec.benchmark, run in a gloo world.

    python3 -m pytest kbench/tests/test_ranks.py -q
"""

from __future__ import annotations

import copy
import gzip
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from kbench import ranks, run, spec
from kbench.reference import compare

TRIAL = "trial-mesh4"
# four files of 20 reads each: equal files, so each rank reads one, in order
SAMPLE = {"genome_length": 32000, "read_length": 2000, "coverage": 5,
          "files": 4}
TINY = {"hifi50x-k40": {"genome_length": 30000, "read_length": 2000,
                        "coverage": 5},
        "illumina40x-k21": {"genome_length": 30000, "coverage": 5}}
# sha256 of every input file (names and bytes) of each cell at TINY sizes,
# seed 2**33 + 7, as the generator wrote them before samples could be split
INPUT_SHA256 = {
    "hifi50x-k40-hist":
        "b9624b69d05073a009a39728cb69f7fd2a667f50bcbfe242fde6b26ff90b0101",
    "hifi50x-k40-t4p":
        "b9624b69d05073a009a39728cb69f7fd2a667f50bcbfe242fde6b26ff90b0101",
    "illumina40x-k21-hist":
        "cc92d968b5e8a37dfd4d8d50185a573f7e2ee877b6b926ba4f10427ab069f44c",
    "hifi50x-k40-asmprof":
        "fa3a278a3d5e838eeb795c813236f7610e4cc7c0c028740af84e5bcde090f158",
}
BENCH = spec.benchmark()


def _with_trial(traffic: str):
    def benchmark():
        b = copy.deepcopy(BENCH)
        b["workloads"].append({"name": TRIAL, "config": "hifi50x-k40",
                               "traffic": traffic, "chips": 4,
                               "why": "a trial of four ranks"})
        return b

    return benchmark


@pytest.fixture
def trial(tmp_path, monkeypatch):
    """The trial cell in BENCHMARK.json, and every World the run makes."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(spec, "benchmark", _with_trial("t4p"))
    worlds = []

    class Recorded(ranks.World):
        def __init__(self, *args, **kwargs):
            worlds.append(self)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(ranks, "World", Recorded)
    return worlds


def _planted(fault: str) -> tuple:
    """ranks.COMMAND for a rank process whose run.job is replaced by
    `fault` (the source of a function job(cli, argv, device))."""
    code = ("import sys\n"
            "import kbench.run\n"
            f"{fault}\n"
            "kbench.run.job = job\n"
            "from kbench import ranks\n"
            "sys.exit(ranks.main())\n")
    return ("-c", code)


def _all_ended(worlds) -> bool:
    return all(p.poll() is not None and not os.path.exists(f"/proc/{p.pid}")
               for w in worlds for p in w._procs)


def test_four_rank_run_is_correct(trial):
    result, limits = run.run(TRIAL, 2 ** 31 + 17, 0.3, False, device="cpu",
                             sample=SAMPLE)
    assert result["correct"], result["checks"]
    assert set(limits) == {"hist_off", "ktab_off", "prof_off"}
    assert result["failed"] == 0 and result["jobs"] >= 1
    # every rank ran every job, the warm-up aside
    assert [len(s) for s in result["rank_job_s"]] == [4] * result["jobs"]
    # the fullest card's peak, and the node's: the ranks' sum
    peaks = result["rank_peaks"]
    assert len(peaks) == 4 and all(rss > 0 for _, rss in peaks)
    assert result["metrics"]["host_peak_gb"]["value"] == pytest.approx(
        sum(rss for _, rss in peaks) / 1e9)
    assert result["metrics"]["device_peak_gb"]["value"] == max(
        p for p, _ in peaks) / 1e9
    assert result["device"]["memory_peak_bytes"] == max(p for p, _ in peaks)
    assert "ranks_s" in result["setup_parts"]
    assert list(result)[-1] == "checks"
    (world,) = trial
    assert len(world._procs) == 3 and _all_ended(trial)
    assert not dist.is_initialized()


def test_failed_job_on_a_rank_ends_the_window(trial, monkeypatch):
    # rank 1 raises in its first job of the window, after the warm-up
    monkeypatch.setattr(ranks, "COMMAND", _planted(
        "import os\n"
        "from kbench.run import job as real\n"
        "n = [0]\n"
        "def job(cli, argv, device):\n"
        "    n[0] += 1\n"
        "    if os.environ['FASTK_TPU_PROC'] == '1' and n[0] == 2:\n"
        "        raise RuntimeError('planted')\n"
        "    real(cli, argv, device)\n"))
    result, _ = run.run(TRIAL, 5, 5.0, False, device="cpu", sample=SAMPLE)
    assert not result["correct"]
    assert (result["attempted"], result["failed"]) == (1, 1)
    assert _all_ended(trial)
    assert not dist.is_initialized()


def test_failed_job_on_rank_0_ends_the_window(trial, monkeypatch):
    # rank 0 raises in its first job of the window: the others, which wait
    # in a collective for it, are killed at once, not at the job's limit
    real, n = run.job, [0]

    def job(cli, argv, device):
        n[0] += 1
        if n[0] == 2:
            raise RuntimeError("planted")
        real(cli, argv, device)

    monkeypatch.setattr(run, "job", job)
    t = time.monotonic()
    result, _ = run.run(TRIAL, 6, 5.0, False, device="cpu", sample=SAMPLE)
    assert not result["correct"]
    assert (result["attempted"], result["failed"]) == (1, 1)
    assert time.monotonic() - t < ranks.JOB_S
    assert _all_ended(trial)
    assert not dist.is_initialized()


def test_traced_run_reads_per_gbp_of_a_rank_share(trial, monkeypatch):
    """--trace 1 profiles rank 0 alone: its per-Gbp metrics divide by a
    rank's share of the window's bases."""
    seen = []

    class Seen(run.Context):
        def __init__(self, *args):
            super().__init__(*args)
            seen.append(self)

    with_trial = spec.benchmark

    def benchmark():
        b = with_trial()
        for m in b["per_layer"]:
            if m["name"] == "reader.raw_s_per_gbp":
                m["workloads"].append(TRIAL)
        return b

    monkeypatch.setattr(spec, "benchmark", benchmark)
    monkeypatch.setattr(run, "Context", Seen)
    result, _ = run.run(TRIAL, 8, 0.3, True, device="cpu", sample=SAMPLE)
    assert result["correct"], result["checks"]
    (ctx,) = seen
    bases = result["traced_bases_per_s"] * result["window_s"]
    assert ctx.bases == pytest.approx(bases / 4)
    assert "reader.raw_s_per_gbp" in result["metrics"]
    assert _all_ended(trial)


def test_hung_rank_gives_no_result_within_the_limit(tmp_path):
    """Rank 2 never returns from its warm-up job: at the limit every rank is
    killed, and the run prints no result and exits non-zero."""
    tag = f"kbench-hung-rank-{os.getpid()}-{time.monotonic_ns()}"
    hang = _planted(f"# {tag}\n"
                    "import time\n"
                    "from kbench.run import job as real\n"
                    "def job(cli, argv, device):\n"
                    "    import os\n"
                    "    if os.environ['FASTK_TPU_PROC'] == '2':\n"
                    "        time.sleep(3600)\n"
                    "    real(cli, argv, device)\n")
    code = ("import sys\n"
            "from kbench import ranks, run, spec\n"
            "bench = spec.benchmark()\n"
            f"bench['workloads'].append({{'name': '{TRIAL}', "
            "'config': 'hifi50x-k40', 'traffic': 'hist', 'chips': 4})\n"
            "spec.benchmark = lambda: bench\n"
            "ranks.WARMUP_S = 15.0\n"
            f"ranks.COMMAND = {hang!r}\n"
            "real = run.run\n"
            f"run.run = lambda *a: real(*a, device='cpu', sample={SAMPLE!r})\n"
            f"sys.exit(run.main(['--workload', '{TRIAL}', '--seed', '3', "
            "'--seconds', '1']))\n")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    t = time.monotonic()
    r = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    took = time.monotonic() - t
    assert r.returncode != 0, r.stderr[-2000:]
    assert r.stdout.strip() == ""
    assert "no result" in r.stderr and "lost" in r.stderr
    assert took < 15.0 + ranks.GRACE_S + 60
    time.sleep(1.0)
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if tag.encode() in f.read():
                    left.append(pid)
        except OSError:
            pass
    assert not left


# --- samples in several files -------------------------------------------------

@pytest.mark.parametrize("config", sorted(TINY))
def test_split_sample_is_the_same_sample(config, tmp_path):
    cell = next(w["name"] for w in BENCH["workloads"]
                if w["config"] == config)
    one = spec.load(cell, TINY[config])
    four = spec.load(cell, dict(TINY[config], files=4))
    traffic = dict(one.traffic, outputs=["hist", "ktab", "prof"],
                   table_min=2)
    a = spec.make_inputs(one, 41, str(tmp_path / "one"), "cpu")
    b = spec.make_inputs(four, 41, str(tmp_path / "four"), "cpu")
    fmt = one.config["sample"]["format"]
    assert [os.path.basename(p) for p in a["reads"]] == [f"reads.{fmt}"]
    assert [os.path.basename(p) for p in b["reads"]] == [
        f"reads.{i}.{fmt}" for i in range(4)]
    assert a["bases"] == b["bases"]

    def text(paths):
        opener = gzip.open if fmt.endswith(".gz") else open
        return b"".join(opener(p, "rb").read() for p in paths)

    # the same records, split into contiguous blocks of whole records
    assert text(b["reads"]) == text(a["reads"])
    sizes = [len(text([p])) for p in b["reads"]]
    assert max(sizes) - min(sizes) <= max(sizes) // 10
    k = one.config["k"]
    want_a = compare.expected(traffic, k, a, "cpu")
    want_b = compare.expected(traffic, k, b, "cpu")
    assert want_a["hist"][0] == want_b["hist"][0]
    assert np.array_equal(want_a["hist"][1], want_b["hist"][1])
    assert want_a["ktab"][0] == want_b["ktab"][0]
    for x, y in zip(want_a["ktab"][1:], want_b["ktab"][1:]):
        assert all(torch.equal(u, v) for u, v in zip(
            x if isinstance(x, tuple) else (x,),
            y if isinstance(y, tuple) else (y,)))
    assert all(torch.equal(x, y) for x, y in zip(want_a["prof"],
                                                 want_b["prof"]))


@pytest.mark.parametrize("cell", sorted(INPUT_SHA256))
def test_inputs_without_files_are_unchanged(cell, tmp_path):
    c = spec.load(cell, TINY[next(w["config"] for w in BENCH["workloads"]
                                  if w["name"] == cell)])
    assert "files" not in c.config["sample"]
    spec.make_inputs(c, 2 ** 33 + 7, str(tmp_path), "cpu")
    h = hashlib.sha256()
    for name in sorted(os.listdir(tmp_path)):
        h.update(name.encode())
        h.update((tmp_path / name).read_bytes())
    assert h.hexdigest() == INPUT_SHA256[cell]


def test_generator_takes_the_cell_whole(tmp_path):
    """The generator's process reads no BENCHMARK.json: an injected cell's
    inputs are made as the run's own."""
    cell = spec.load("hifi50x-k40-hist", dict(TINY["hifi50x-k40"], files=3))
    inputs = run.make_inputs(cell, 9, str(tmp_path / "w"), "cpu")
    assert [os.path.basename(p) for p in inputs["reads"]] == [
        f"reads.{i}.fasta" for i in range(3)]
    assert json.load(open(tmp_path / "w" / "inputs.json")) == inputs
