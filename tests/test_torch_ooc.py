"""The port's out-of-core job against fastk_tpu's (exact): every scenario of
tests/test_ooc.py through the port's count_files_ooc and CLI, compared with
JAX's count_files_ooc and CLI on the same input, the CLI's plan with the
port's constants, and its out-of-memory demotion."""

import glob
import io
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import fastk_tpu_torch.ops.count as tcount
import fastk_tpu_torch.pipeline.count as tpipe
import fastk_tpu_torch.pipeline.outofcore as tooc
import fastk_tpu_torch.tools.fastk as cli_mod
from fastk_tpu.io.reader import batched_reads
from fastk_tpu.pipeline.outofcore import count_files_ooc as jax_ooc
from fastk_tpu.tools.fastk import main as jax_fastk_main
from fastk_tpu_torch.pipeline.outofcore import count_files_ooc
from fastk_tpu_torch.tools.fastk import main as fastk_main

from test_torch_table import file_set


def _write(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    return str(path)


def _shotgun(rng, genome, n, length):
    return ["".join("acgt"[c] for c in
                    genome[s: s + length])
            for s in rng.integers(0, len(genome) - length, n)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_ooc.py's input: 60 reads of 120 bases from a 3 kb genome,
    half reverse-complemented, a fifth with one N."""
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=3000)
    reads = []
    for _ in range(60):
        s = int(rng.integers(0, len(genome) - 120))
        r = genome[s: s + 120].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        seq = "".join("acgt"[c] for c in r)
        if rng.random() < 0.2:
            i = int(rng.integers(0, len(seq)))
            seq = seq[:i] + "N" + seq[i + 1:]
        reads.append(seq)
    return _write(tmp_path_factory.mktemp("ooc") / "in.fasta", reads)


def _same(got, want):
    assert got.hist == want.hist
    assert (got.nreads, got.totlen, got.nshort, got.table_entries) == (
        want.nreads, want.totlen, want.nshort, want.table_entries)
    assert (got.table is None) == (want.table is None)
    if want.table is not None:
        assert np.array_equal(got.table.packed, want.table.packed)
        assert np.array_equal(got.table.counts, want.table.counts)
        assert got.table.minval == want.table.minval
    assert (got.profiles is None) == (want.profiles is None)
    if want.profiles is not None:
        assert len(got.profiles) == len(want.profiles)
        for x, y in zip(got.profiles, want.profiles):
            assert np.array_equal(x, y)


def _both(paths, tmp_path, **kw):
    """(port, JAX) count_files_ooc on the same arguments, each with its own
    sort directory."""
    for d in ("port", "jax"):
        os.makedirs(tmp_path / d, exist_ok=True)
    got = count_files_ooc(paths, sort_path=str(tmp_path / "port"),
                          device="cpu", **kw)
    want = jax_ooc(paths, sort_path=str(tmp_path / "jax"), **kw)
    return got, want


def _no_spill_left(d):
    assert not glob.glob(os.path.join(str(d), "fastk_tpu_ooc.*"))


@pytest.mark.parametrize("parts", [1, 3])
def test_ooc_matches_jax(data, tmp_path, parts):
    got, want = _both([data], tmp_path, k=21, parts=parts, table_min=1,
                      profiles=True, batch_bases=2000)
    _same(got, want)
    assert len(got.table) > 0
    _no_spill_left(tmp_path / "port")


def test_ooc_cli_trigger_matches_jax(data, tmp_path, monkeypatch, capsys):
    """A huge size estimate sends both CLIs out of core; the file-sets
    match byte for byte."""
    real_getsize = cli_mod.os.path.getsize
    monkeypatch.setattr(cli_mod.os.path, "getsize",
                        lambda p: real_getsize(p) * 10_000_000)
    for d in ("jax", "port", "sp", "sj"):
        os.mkdir(tmp_path / d)
    argv = ["-k21", "-t1", "-p", "-T2"]
    assert jax_fastk_main(argv + [f"-P{tmp_path}/sj", data,
                                  f"-N{tmp_path}/jax/o"]) == 0
    capsys.readouterr()
    assert fastk_main(argv + ["-v", f"-P{tmp_path}/sp", data,
                              f"-N{tmp_path}/port/o"], device="cpu") == 0
    assert "out-of-core:" in capsys.readouterr().err
    got = file_set(tmp_path / "port")
    assert got == file_set(tmp_path / "jax")
    assert {"o.hist", "o.ktab", "o.prof"} <= set(got)
    assert os.listdir(tmp_path / "sp") == []


@pytest.mark.parametrize("parts", [1, 3])
def test_ooc_streamed_outputs_match_jax(data, tmp_path, parts):
    """out_base streams .ktab and .prof file-sets byte-identical to JAX's,
    and returns no table or profiles."""
    for d in ("port", "jax"):
        os.makedirs(tmp_path / "out" / d)
    kw = dict(k=21, parts=parts, table_min=1, profiles=True,
              batch_bases=2000, out_nparts=2)
    got = count_files_ooc([data], sort_path=str(tmp_path), device="cpu",
                          out_base=str(tmp_path / "out" / "port" / "st"),
                          **kw)
    want = jax_ooc([data], sort_path=str(tmp_path),
                   out_base=str(tmp_path / "out" / "jax" / "st"), **kw)
    assert got.table is None and got.profiles is None
    _same(got, want)
    gset = file_set(tmp_path / "out" / "port")
    assert gset == file_set(tmp_path / "out" / "jax")
    assert ".st.prof.2" in gset and ".st.ktab.2" in gset


def test_part_overflow_subsplit_matches_jax(data, tmp_path, capsys):
    """A part above part_cap is sub-split at word0 quantiles; the outputs
    do not change."""
    got, want = _both([data], tmp_path, k=21, parts=2, table_min=1,
                      profiles=True, batch_bases=2000, part_cap=50,
                      verbose=True)
    _same(got, want)
    assert "sub-split into" in capsys.readouterr().out


def test_skewed_input_matches_jax(tmp_path):
    """One k-mer holding most instances (maximal skew) counts exactly."""
    p = _write(tmp_path / "skew.fasta",
               ["a" * 500] * 30 + ["acgtacgtacgtacgtacgtacgtacgt"])
    got, want = _both([p], tmp_path, k=21, parts=3, table_min=1,
                      batch_bases=1000, part_cap=200)
    _same(got, want)
    i = got.table.find("a" * 21)
    assert got.table.counts[i] == min(14400, 32767)


def _dying_after(monkeypatch, n_ok: int):
    """Make the port's unique_batch_inst raise on call n_ok + 1; returns
    the call counter."""
    calls = {"n": 0}
    real = tcount.unique_batch_inst

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] > n_ok:
            raise KeyboardInterrupt("simulated kill")
        return real(*a, **kw)

    monkeypatch.setattr(tooc, "unique_batch_inst", dying)
    return calls


def test_resume_after_crash_matches_jax(data, tmp_path, monkeypatch):
    """Killed in phase 1, a resumed run skips the batches already spilled
    and writes JAX's outputs; the spill is gone afterwards."""
    kw = dict(k=21, parts=3, table_min=1, profiles=True, batch_bases=2000)
    want = jax_ooc([data], sort_path=str(tmp_path), **kw)
    sort = str(tmp_path / "port")
    os.mkdir(sort)
    _dying_after(monkeypatch, 2)
    with pytest.raises(KeyboardInterrupt):
        count_files_ooc([data], sort_path=sort, resume=True, device="cpu",
                        **kw)
    assert glob.glob(os.path.join(sort, "fastk_tpu_ooc.*", "manifest.json"))
    calls = _dying_after(monkeypatch, 1 << 30)
    got = count_files_ooc([data], sort_path=sort, resume=True, device="cpu",
                          **kw)
    nbatches = sum(1 for _ in batched_reads([data], 2000))
    assert calls["n"] == nbatches - 1  # the first batch was not redone
    _same(got, want)
    _no_spill_left(sort)


def test_resume_multislice_batch_matches_jax(tmp_path, monkeypatch):
    """A batch counted in several device slices enters the manifest only
    once its last slice is spilled: a kill between two slices of one batch
    resumes exactly. The slice size is read from the port's pipeline at
    call time."""
    monkeypatch.setattr(tpipe, "MAX_DEVICE_POSITIONS", 1 << 15)
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, size=4000)
    p = _write(tmp_path / "big.fasta", _shotgun(rng, genome, 500, 150))
    kw = dict(k=21, parts=3, table_min=1, profiles=True,
              batch_bases=90_000)
    want = jax_ooc([p], sort_path=str(tmp_path), **kw)
    sort = str(tmp_path / "port")
    os.mkdir(sort)
    _dying_after(monkeypatch, 1)  # dies on the second slice of batch 1
    with pytest.raises(KeyboardInterrupt):
        count_files_ooc([p], sort_path=sort, resume=True, device="cpu", **kw)
    monkeypatch.setattr(tooc, "unique_batch_inst", tcount.unique_batch_inst)
    got = count_files_ooc([p], sort_path=sort, resume=True, device="cpu",
                          **kw)
    _same(got, want)


def _planned(log: str) -> int:
    return int(re.search(r"planning (\d+) parts", log).group(1))


@pytest.mark.parametrize("profiles", [False, True])
def test_measured_plan_matches_jax(tmp_path, profiles):
    """parts=None plans from the first slice's dedup ratio as JAX does: a
    high-coverage table job plans several-fold fewer parts than the worst
    case, a profile job is bounded by its instances."""
    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, size=400)  # ~20X coverage
    p = _write(tmp_path / "hi.fasta", _shotgun(rng, genome, 80, 100))
    est = os.path.getsize(p)
    logs = []
    outs = []
    for fn, extra in ((count_files_ooc, dict(device="cpu")), (jax_ooc, {})):
        buf = io.StringIO()
        with redirect_stdout(buf):
            outs.append(fn([p], 17, None, sort_path=str(tmp_path),
                           table_min=1, profiles=profiles, batch_bases=2000,
                           part_cap=400, est_bases=est, verbose=True,
                           **extra))
        logs.append(buf.getvalue())
    _same(*outs)
    assert _planned(logs[0]) == _planned(logs[1])
    worst = -(-est // 400)
    if profiles:
        assert _planned(logs[0]) >= worst
    else:
        assert _planned(logs[0]) <= worst // 3


def test_part_consolidation_matches_jax(data, tmp_path, capsys):
    """An over-provisioned plan merges consecutive near-empty parts in one
    device merge each; the outputs do not change."""
    calls = {"n": 0}
    real = tooc.merge_unique_blocks

    def spy(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    tooc.merge_unique_blocks = spy
    try:
        got, want = _both([data], tmp_path, k=17, parts=16, table_min=1,
                          profiles=True, batch_bases=4000, verbose=True)
    finally:
        tooc.merge_unique_blocks = real
    _same(got, want)
    m = re.search(r"16 parts consolidated into (\d+) merges",
                  capsys.readouterr().out)
    assert m and calls["n"] == int(m.group(1)) < 16


def test_ooc_plan_bounds_with_port_constants():
    """In core only when the worst case fits both the device and -M;
    otherwise part_cap keeps a part merge under -M at the port's bytes a
    record, flat as the input grows."""
    plan = cli_mod._ooc_plan
    hbm = 80e9
    parts, cap = plan(10_000_000, 12, False, hbm)
    assert parts == 1
    big = int(2e9 / cli_mod.UNIQUE_BYTES)  # 2 GB of worst-case uniques
    parts1, cap1 = plan(big, 1, False, hbm)
    assert parts1 > 1 and cap1 * cli_mod.MERGE_BYTES <= 1e9
    parts3, cap3 = plan(3 * big, 1, False, hbm)
    assert cap3 == cap1 and parts3 >= 3 * parts1 - 2
    # profile jobs go out of core earlier (per-position state)
    n = int(10e9 / (cli_mod.POSITION_BYTES + cli_mod.UNIQUE_BYTES))
    assert n * cli_mod.UNIQUE_BYTES <= 12e9
    assert plan(n, 12, False, hbm)[0] == 1
    assert plan(2 * n, 12, True, hbm)[0] > 1
    # the device budget binds below -M
    assert plan(n, 12, False, 1e9)[0] > 1
    # part_cap stays within [2^22, 2^26]
    assert plan(big, 1000, False, hbm)[1] == 1 << 26
    assert plan(big * 100, 0, False, hbm)[1] == 1 << 22


def test_device_budget(monkeypatch):
    monkeypatch.delenv("FASTK_TPU_HBM_GB", raising=False)
    assert cli_mod._device_budget(torch.device("cpu")) == 13e9
    monkeypatch.setenv("FASTK_TPU_HBM_GB", "2.5")
    assert cli_mod._device_budget(torch.device("cpu")) == 2.5e9


def _oom(*a, **kw):
    raise torch.cuda.OutOfMemoryError("injected: CUDA out of memory")


def test_oom_demotes_measured_incore_to_ooc(data, tmp_path, monkeypatch,
                                            capsys):
    """The measured plan promotes the job in core; the in-core attempt runs
    out of device memory; the job is redone out of core and writes JAX's
    file-sets."""
    for d in ("jax", "port", "sort"):
        os.mkdir(tmp_path / d)
    argv = ["-k21", "-t1", "-p", "-T2"]
    assert jax_fastk_main(argv + [data, f"-N{tmp_path}/jax/o"]) == 0
    # the worst case does not fit; the measured ratio does
    monkeypatch.setattr(cli_mod, "_ooc_plan",
                        lambda est, M, profiles, hbm: (2, 1 << 22))
    ooc_calls = {"n": 0}
    real_ooc = cli_mod.count_files_ooc

    def ooc_spy(*a, **kw):
        ooc_calls["n"] += 1
        return real_ooc(*a, **kw)

    monkeypatch.setattr(cli_mod, "count_files", _oom)
    monkeypatch.setattr(cli_mod, "count_files_ooc", ooc_spy)
    capsys.readouterr()
    assert fastk_main(argv + ["-v", f"-P{tmp_path}/sort", data,
                              f"-N{tmp_path}/port/o"], device="cpu") == 0
    err = capsys.readouterr().err
    assert "in-core (footprint" in err
    assert "falling back to out-of-core" in err
    assert ooc_calls["n"] == 1
    assert file_set(tmp_path / "port") == file_set(tmp_path / "jax")


@pytest.mark.parametrize("argv", [["-k21", "-t1"], ["-k21", "-t1", "-R"]])
def test_oom_without_measured_promotion_raises(data, tmp_path, monkeypatch,
                                               argv):
    """Only a measured promotion demotes: an in-core plan from the worst
    case (or under -R) lets the error through and removes its outputs."""
    if "-R" in argv:
        monkeypatch.setattr(cli_mod, "_ooc_plan",
                            lambda est, M, profiles, hbm: (2, 1 << 22))
        # -R keeps the worst-case plan: it goes out of core, and there the
        # injected error strikes the part merge
        monkeypatch.setattr(tooc, "merge_unique_blocks", _oom)
    else:
        monkeypatch.setattr(cli_mod, "count_files", _oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        fastk_main(argv + [f"-P{tmp_path}", data, f"-N{tmp_path}/o"],
                   device="cpu")
    assert not glob.glob(str(tmp_path / "*o.*"))


def test_measure_dedup_lets_errors_through(data, monkeypatch):
    """Only an empty input gives no measurement; a failing device call
    raises instead of falling back to the worst-case plan."""
    assert cli_mod._measure_dedup([data], 21, 2000, False, 0,
                                  torch.device("cpu")) > 0

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(cli_mod, "unique_batch", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        cli_mod._measure_dedup([data], 21, 2000, False, 0,
                               torch.device("cpu"))


def test_measure_dedup_empty_input(tmp_path):
    empty = tmp_path / "empty.fasta"
    empty.write_text("")
    assert cli_mod._measure_dedup([str(empty)], 21, 2000, False, 0,
                                  torch.device("cpu")) is None


def test_cli_resume_matches_jax(data, tmp_path, monkeypatch):
    """-R: a CLI run killed in phase 1 keeps its spill; the rerun resumes
    (the resume line is printed) and writes JAX's file-sets."""
    for d in ("jax", "port", "sort"):
        os.mkdir(tmp_path / d)
    argv = ["-k21", "-t1", "-p", "-T2", data]
    assert jax_fastk_main(argv + [f"-N{tmp_path}/jax/o"]) == 0
    real_getsize = cli_mod.os.path.getsize
    monkeypatch.setattr(cli_mod.os.path, "getsize",
                        lambda p: real_getsize(p) * 10_000_000)
    # batches of 2000 bases, so that the run has batches to resume after
    monkeypatch.setattr(cli_mod, "_batch_bases", lambda cfg: 2000)
    argv += ["-R", f"-P{tmp_path}/sort", f"-N{tmp_path}/port/o"]
    _dying_after(monkeypatch, 2)
    with pytest.raises(KeyboardInterrupt):
        fastk_main(argv, device="cpu")
    assert os.listdir(tmp_path / "port") == []
    assert glob.glob(str(tmp_path / "sort" / "fastk_tpu_ooc.*"
                         / "manifest.json"))
    calls = _dying_after(monkeypatch, 1 << 30)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert fastk_main(argv + ["-v"], device="cpu") == 0
    assert "resume: phase 1 re-enters after batch 1" in buf.getvalue()
    assert calls["n"] == sum(1 for _ in batched_reads([data], 2000)) - 1
    assert file_set(tmp_path / "port") == file_set(tmp_path / "jax")
    assert os.listdir(tmp_path / "sort") == []
