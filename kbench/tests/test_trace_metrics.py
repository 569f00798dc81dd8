"""The readers of the port's own job records (kbench/jobtrace.py and the
per-layer metrics whose source is program_span), on fake records of
fastk_tpu_torch.trace.jobs(): the window's slice, None with too few records
or none of a metric's spans, and the units.

    python3 -m pytest kbench/tests/test_trace_metrics.py -q
"""

from __future__ import annotations

import sys

import pytest

import fastk_tpu_torch
from fastk_tpu_torch import trace
from kbench import run, spec

CELLS = ["hifi50x-k40-hist", "hifi50x-k40-t4p", "illumina40x-k21-hist",
         "hifi50x-k40-asmprof"]
# name: (unit, cells)
METRICS = {
    "reader.raw_s_per_gbp": ("s/Gbp", CELLS),
    "reader.parse_wait_s_per_gbp": ("s/Gbp", CELLS),
    "upload.host_ms_per_gbp": ("ms/Gbp", CELLS),
    "host_blocked_ms_per_job": ("ms/job", CELLS),
    "plan.host_ms_per_job": ("ms/job", ["hifi50x-k40-t4p"]),
    "table_out.host_s_per_gbp": ("s/Gbp", ["hifi50x-k40-t4p"]),
    "prof_out.encode_s_per_gbp": ("s/Gbp", ["hifi50x-k40-t4p",
                                            "hifi50x-k40-asmprof"]),
}


def _job(scale: float) -> dict:
    """A record whose seconds are `scale` times a window job's."""
    def s(host, main=None):
        return dict(calls=1, host_s=host * scale,
                    main_s=(host if main is None else main) * scale,
                    self_s=host * scale)

    return dict(wall_s=10.0 * scale, host_blocked_s=0.25 * scale,
                counters={}, events=[],
                spans={"reader.raw": s(0.5), "reader.wait": s(0.75),
                       "reader.parse": s(2.0, 0.0), "upload": s(0.125),
                       "plan": s(0.375), "table_out": s(1.0),
                       "ktab_write": s(0.5), "prof_out.encode": s(1.5)})


# a window job's reading at 1 Gbp a job
WANT = {"reader.raw_s_per_gbp": 0.5, "reader.parse_wait_s_per_gbp": 0.75,
        "upload.host_ms_per_gbp": 125.0, "host_blocked_ms_per_job": 250.0,
        "plan.host_ms_per_job": 375.0, "table_out.host_s_per_gbp": 1.5,
        "prof_out.encode_s_per_gbp": 1.5}


def _ctx(jobs: int, bases_per_job: float = 1e9):
    return run.Context({}, 20.0, 1.0, jobs, jobs * bases_per_job)


@pytest.fixture
def records(monkeypatch):
    """trace.jobs() as a warm-up job that took 100 times as long, then
    the window's jobs."""
    held = []
    monkeypatch.setattr(trace, "jobs", lambda: list(held))
    return held


def test_benchmark_entries():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name, (unit, cells) in METRICS.items():
        m = entries[name]
        assert (m["unit"], m["workloads"]) == (unit, cells)
        assert m["source"] == "program_span"
        assert m["moves"] == "bases_per_s" and m["better"] == "lower"
        assert spec.metric_reader(name).SPANS == {}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reads_the_window_in_its_unit(name, records):
    records.extend([_job(100.0), _job(1.0), _job(1.0), _job(1.0)])
    got = spec.metric_reader(name).read(_ctx(3))
    assert got == pytest.approx(WANT[name])
    # half the bases a job: per gigabase doubles, per job stays
    got = spec.metric_reader(name).read(_ctx(3, 5e8))
    per_gbp = name.split("_")[-1] == "gbp"
    assert got == pytest.approx(WANT[name] * (2 if per_gbp else 1))


@pytest.mark.parametrize("name", sorted(METRICS))
def test_none_with_too_few_records(name, records):
    records.extend([_job(1.0), _job(1.0)])
    reader = spec.metric_reader(name)
    assert reader.read(_ctx(3)) is None
    assert reader.read(_ctx(0)) is None
    records.clear()
    assert reader.read(_ctx(1)) is None


@pytest.mark.parametrize("name", sorted(set(METRICS)
                                        - {"host_blocked_ms_per_job"}))
def test_none_without_its_spans(name, records):
    job = _job(1.0)
    job["spans"] = {}
    records.extend([job, job])
    assert spec.metric_reader(name).read(_ctx(2)) is None


@pytest.mark.parametrize("name", sorted(METRICS))
def test_none_without_the_ports_module(name, monkeypatch):
    monkeypatch.delattr(fastk_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "fastk_tpu_torch.trace", None)
    assert spec.metric_reader(name).read(_ctx(2)) is None


def test_a_traced_cpu_run_reads_every_metric_of_its_cell(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    sample = {"genome_length": 30000, "read_length": 2000, "coverage": 5}
    result, _ = run.run("hifi50x-k40-t4p", 5, 0.2, True, device="cpu",
                        sample=sample)
    assert result["correct"]
    got = result["metrics"]
    for name, (unit, cells) in METRICS.items():
        assert got[name]["unit"] == unit and got[name]["value"] > 0, name
    assert len(trace.jobs()) >= result["jobs"] + 1  # the warm-up job first
