"""The port's host-memory check (fastk_tpu_torch/probes/rss.py) against
benchmarks/bench_rss.py on the CPU at toy size: the same input bytes, its
CLI and mesh runs writing the same file-sets as the JAX package's on the
same input, the JAX script's verdict, and no silent fallback to the CPU."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from fastk_tpu.formats.hist import write_histogram as jax_write_histogram
from fastk_tpu.parallel.meshooc import count_files_mesh as jax_mesh
from fastk_tpu.tools.fastk import main as jax_fastk_main
from fastk_tpu_torch.probes import rss
from fastk_tpu_torch.tools import fastk as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NBASES = 200_000  # ten reads of 20 kb


def _bench_rss():
    spec = importlib.util.spec_from_file_location(
        "bench_rss", os.path.join(REPO, "benchmarks", "bench_rss.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(d, base):
    """{name: bytes} of the file-set `base` in directory d, hidden parts
    included, the base in each name replaced by '@'."""
    out = {}
    for name in sorted(os.listdir(d)):
        stem = name[1:] if name.startswith(".") else name
        if stem.startswith(base + "."):
            with open(os.path.join(d, name), "rb") as f:
                out[name.replace(base, "@", 1)] = f.read()
    return out


@pytest.fixture
def ooc_env(monkeypatch):
    """A device budget of 200 kB, so that the -M1 plan goes out of core."""
    monkeypatch.setenv("FASTK_TPU_HBM_GB", "0.0002")
    monkeypatch.setenv("FASTK_TPU_BATCH_BASES", str(1 << 20))


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rssin") / "in.fasta")
    rss.make_fasta(path, NBASES, seed=3)
    return path


@pytest.mark.parametrize("nbases,seed,read_len", [
    (60_000, 0, 20_000),     # whole reads
    (45_001, 7, 20_000),     # a last read of 5001 bases
    (12_345, 1, 1000),       # many short reads, the last of 345
])
def test_make_fasta_matches_bench_rss(tmp_path, nbases, seed, read_len):
    a, b = str(tmp_path / "port.fasta"), str(tmp_path / "jax.fasta")
    rss.make_fasta(a, nbases, seed=seed, read_len=read_len)
    _bench_rss().make_fasta(b, nbases, seed=seed, read_len=read_len)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        got, want = fa.read(), fb.read()
    assert got == want
    seqs = got.split(b"\n")[1::2]
    assert sum(map(len, seqs)) == nbases
    assert len(seqs[-1]) == (nbases % read_len or read_len)


def test_run_one_matches_jax_cli(tmp_path, fasta, ooc_env):
    port, jax = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax.mkdir()
    res = rss.run_one(fasta, str(port), 40, device="cpu")
    assert res["peak_rss_mb"] > 0 and res["out_of_core"]
    assert res["input_bases"] == os.path.getsize(fasta)
    assert res["device_peak_bytes"] is None
    assert res["run_hist_launches"] == 0
    assert jax_fastk_main(["-k40", "-t1", "-v", "-M1", f"-P{jax}", fasta,
                           f"-N{jax}/out"]) == 0
    got = _files(str(port), "out")
    assert {"@.hist", "@.ktab", ".@.ktab.1"} <= set(got)
    assert got == _files(str(jax), "out")
    assert not [n for n in os.listdir(port) if n.startswith("fastk_tpu_ooc")]


def test_run_one_mesh_matches_jax_mesh(tmp_path, fasta, ooc_env):
    port, jax = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax.mkdir()
    res = rss.run_one_mesh(fasta, str(port), 40, device="cpu")
    assert res["peak_rss_mb"] > 0 and res["wall_s"] > 0
    assert res["pinned_peak_bytes"] is None
    out = jax_mesh([fasta], 40, table_min=1, profiles=True,
                   batch_bases=cli._batch_bases({"M": 1}),
                   sort_path=str(jax), out_base=f"{jax}/mesh",
                   parts_per_chip=1, part_cap=1 << 23)
    jax_write_histogram(f"{jax}/mesh", out.hist)
    got = _files(str(port), "mesh")
    assert {"@.hist", "@.ktab", "@.prof", ".@.pidx.1"} <= set(got)
    assert got == _files(str(jax), "mesh")


def test_runtime_rss_on_cpu():
    assert rss.runtime_rss("cpu") > 0


def test_peak_is_not_the_parents():
    """A process started by a large one inherits its high-water RSS as the
    floor of its ru_maxrss: each measured process is started by a small
    one, so a parent 600 MB larger leaves the floor where it was."""
    import resource

    big = np.ones(600_000_000 // 8)
    parent = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1000
    floor = rss.runtime_rss("cpu")
    assert big.sum() > 0
    assert 0 < floor < parent - 500


def _runs(*mb):
    return [{"peak_rss_mb": m} for m in mb]


@pytest.mark.parametrize("peaks,sizes,verdict", [
    ((1000, 1199), (80, 240), "PASS"),   # 199 < 800 / 4
    ((1000, 1200), (80, 240), "FAIL"),   # 200 is not below 800 / 4
    ((1000, 900), (80, 240), "PASS"),    # a smaller peak at the big size
    ((500, 1000, 1049), (8, 40, 80), "PASS"),  # the two largest: 49 < 50
    ((500, 1000, 1050), (8, 40, 80), "FAIL"),
])
def test_flatness_is_the_jax_rule(peaks, sizes, verdict):
    v = rss.flatness(_runs(*peaks), list(sizes))
    assert v["verdict"] == verdict
    assert v["delta_mb"] == peaks[-1] - peaks[-2]
    assert v["naive_retained_mb"] == 5 * (sizes[-1] - sizes[-2])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("call", ["run_one", "run_one_mesh", "runtime_rss",
                                  "main"])
def test_default_device_refuses_the_cpu(tmp_path, fasta, call):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        if call == "runtime_rss":
            rss.runtime_rss()
        elif call == "main":
            rss.main(["--sizes", "1", "2"])
        else:
            getattr(rss, call)(fasta, str(tmp_path), 40)
    assert os.listdir(tmp_path) == []


def test_main_on_cpu_prints_the_jax_lines(capsys, monkeypatch):
    """main at two toy sizes on the CPU: a JSON line a size with the JAX
    script's keys, then its verdict line with the floor and the device."""
    monkeypatch.setenv("FASTK_TPU_HBM_GB", "0.0002")
    real = rss.make_fasta  # 1/64 of each size: 16 and 32 kb
    monkeypatch.setattr(rss, "make_fasta",
                        lambda path, nbases: real(path, nbases // 64))
    rc = rss.main(["--sizes", "1", "2", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 3
    for line, label in zip(lines, ("1MB", "2MB")):
        assert line["label"] == label and line["peak_rss_mb"] > 0
        assert line["above_runtime_mb"] == (line["peak_rss_mb"]
                                            - lines[2]["runtime_rss_mb"])
    v = lines[2]
    assert {"metric", "delta_mb", "naive_retained_mb", "verdict",
            "runtime_rss_mb", "device"} <= set(v)
    assert v["device"] == "cpu" and v["naive_retained_mb"] == 5
    assert rc == (0 if v["verdict"] == "PASS" else 1)
