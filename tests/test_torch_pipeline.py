"""The port's job end to end on the CPU: byte-identical .hist files against
the oracle goldens and against fastk_tpu's own pipeline, and the port's CLI
and kmermap against fastk_tpu's (file-sets, -p:<table>, the batch-size cap,
cleanup of partial outputs, the multi-process mode, tracing, beds)."""

import json
import os

import numpy as np
import pytest

import fastk_tpu_torch.pipeline.count as tpipe
import fastk_tpu_torch.tools.fastk as cli_mod
from fastk_tpu.formats.hist import write_histogram
from fastk_tpu.formats.ktab import read_ktab
from fastk_tpu.pipeline.count import count_files as jax_count_files
from fastk_tpu.tools._cli import print_number
from fastk_tpu.tools.fastk import main as jax_fastk_main
from fastk_tpu.tools.kmermap import main as jax_kmermap_main
from fastk_tpu_torch.pipeline.count import count_files
from fastk_tpu_torch.tools.fastk import main as fastk_main
from fastk_tpu_torch.tools.kmermap import main as kmermap_main

import gen_data
import torch_dist_worker as tw
from test_torch_table import file_set

HERE = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(HERE, "golden", "inputs")


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("golden,hc", [("small_k40", False),
                                       ("small_k40_c", True)])
@pytest.mark.parametrize("batch_bases", [64 << 20, 100_000])
def test_hist_matches_golden(tmp_path, golden, hc, batch_bases):
    out = count_files([os.path.join(INPUTS, "small.fasta")], 40, hc=hc,
                      batch_bases=batch_bases, device="cpu")
    write_histogram(str(tmp_path / "small"), out.hist)
    assert _bytes(str(tmp_path / "small.hist")) == _bytes(
        os.path.join(HERE, "golden", golden, "small.hist"))
    assert out.nreads == 1000


@pytest.fixture(scope="module")
def multi_input(tmp_path_factory):
    """Shotgun reads with N runs, mixed case and errors (tests/gen_data)."""
    rng = np.random.default_rng(11)
    genome = gen_data.make_genome(rng, 8000)
    reads = gen_data.sample_reads(rng, genome, 10, 300, n_rate=0.2,
                                  upper_rate=0.3, err_rate=0.01)
    reads += [b"acg", b"ttttttttttttttttttttttttttttttttttttttttttttt"]
    path = str(tmp_path_factory.mktemp("multi") / "multi.fasta")
    gen_data.write_fasta(path, reads)
    return path


@pytest.mark.parametrize("k", [17, 40])
def test_multi_batch_matches_jax_pipeline(tmp_path, multi_input, k):
    want = jax_count_files([multi_input], k, batch_bases=20_000)
    got = count_files([multi_input], k, batch_bases=20_000, device="cpu")
    write_histogram(str(tmp_path / "jax"), want.hist)
    write_histogram(str(tmp_path / "port"), got.hist)
    assert _bytes(str(tmp_path / "port.hist")) == _bytes(
        str(tmp_path / "jax.hist"))
    assert (got.nreads, got.totlen, got.nshort) == (
        want.nreads, want.totlen, want.nshort)
    single = count_files([multi_input], k, device="cpu")
    assert single.hist == got.hist


def test_cli_writes_golden_hist(tmp_path):
    rc = fastk_main(["-k40", f"-N{tmp_path}/cli",
                     os.path.join(INPUTS, "small.fasta")], device="cpu")
    assert rc == 0
    assert _bytes(str(tmp_path / "cli.hist")) == _bytes(
        os.path.join(HERE, "golden", "small_k40", "small.hist"))


@pytest.mark.parametrize("nprocs", ["2", "4"])
def test_cli_unported_modes_die(tmp_path, nprocs):
    """F3, repaired: with FASTK_TPU_COORD, FASTK_TPU_NPROCS > 1 and
    FASTK_TPU_PROC the port's CLI runs one job across that many processes
    (gloo on the CPU) to the end, as the JAX CLI does: rank 0 splices the
    slices, whose .hist equals the JAX CLI's over the same global read
    order byte for byte and whose table and profiles equal its decoded
    ones; no slice file-set is left."""
    from fastk_tpu.formats.prof import read_profiles
    from fastk_tpu.parallel.multihost import shard_files

    world = int(nprocs)
    inputs = [os.path.join(INPUTS, f) for f in
              ("small.fasta", "small2.fasta", "tiny.fasta")]
    out = str(tmp_path / "mh")
    rcs = tw.run_cli(world, tmp_path, ["-k40", "-t1", "-p", f"-P{tmp_path}",
                                       f"-N{out}", *inputs],
                     env={"FASTK_TPU_BATCH_BASES": str(1 << 20)})
    assert rcs == [0] * world
    order = [p for r in range(world) for p in shard_files(inputs, r, world)]
    want = str(tmp_path / "jax")
    assert jax_fastk_main(["-k40", "-t1", "-p", f"-N{want}", *order]) == 0
    assert _bytes(out + ".hist") == _bytes(want + ".hist")
    ta, tb = read_ktab(out), read_ktab(want)
    assert np.array_equal(ta.packed, tb.packed)
    assert np.array_equal(ta.counts, tb.counts)
    pa, pb = read_profiles(out), read_profiles(want)
    assert len(pa) == len(pb)
    assert all(np.array_equal(a, b) for a, b in zip(pa, pb))
    assert not [f for f in os.listdir(tmp_path) if f.startswith(
        tuple(f"{p}mh.{r}." for r in range(world) for p in ("", ".")))]


def test_cli_single_process_env_runs(tmp_path, monkeypatch):
    """FASTK_TPU_NPROCS=1 is a single-host run, as in the JAX CLI."""
    monkeypatch.setenv("FASTK_TPU_COORD", "localhost:12355")
    monkeypatch.setenv("FASTK_TPU_NPROCS", "1")
    assert fastk_main(["-k40", f"-N{tmp_path}/cli",
                       os.path.join(INPUTS, "small.fasta")], device="cpu") == 0
    assert _bytes(str(tmp_path / "cli.hist")) == _bytes(
        os.path.join(HERE, "golden", "small_k40", "small.hist"))


def test_cli_trace_writes_chrome_trace(tmp_path, monkeypatch):
    """FASTK_TPU_TRACE=<dir> writes a torch.profiler trace of the run."""
    monkeypatch.setenv("FASTK_TPU_TRACE", str(tmp_path / "trace"))
    assert fastk_main(["-k40", f"-N{tmp_path}/t",
                       os.path.join(INPUTS, "tiny.fasta")], device="cpu") == 0
    (name,) = os.listdir(tmp_path / "trace")
    assert name.endswith(".trace.json")
    with open(tmp_path / "trace" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("sort" in str(ev.get("name", "")) for ev in events)
    assert os.path.exists(tmp_path / "t.hist")


@pytest.mark.parametrize("flag", [None, "-m"])
def test_kmermap_matches_jax(tmp_path, small_table, flag):
    """The port's kmermap writes the JAX tool's bed, with and without -m
    (the JAX tool's beds equal the reference KmerMap's goldens)."""
    target = os.path.join(INPUTS, "small2.fasta")
    suffix = "kmers.merge.bed" if flag else "kmers.bed"
    beds = []
    for name, fn, kw in (("jax", jax_kmermap_main, {}),
                         ("port", kmermap_main, dict(device="cpu"))):
        args = ([flag] if flag else []) + ["-T1", small_table, target,
                                           str(tmp_path / name)]
        assert fn(args, **kw) == 0
        beds.append(_bytes(str(tmp_path / f"{name}.small2.{suffix}")))
    assert beds[0] == beds[1]
    assert beds[1].count(b"\n") > 10


@pytest.mark.parametrize("argv", [["-k40", "-t3", "-p", "-T3"],
                                  ["-k32", "-t", "-T2", "-c"],
                                  ["-k40", "-p"]])
def test_cli_file_sets_match_jax(tmp_path, argv, capsys):
    small = os.path.join(INPUTS, "small.fasta")
    for name in ("jax", "port"):
        os.mkdir(tmp_path / name)
    assert jax_fastk_main(argv + [f"-N{tmp_path}/jax/s", small]) == 0
    assert fastk_main(argv + ["-v", f"-N{tmp_path}/port/s", small],
                      device="cpu") == 0
    got = file_set(tmp_path / "port")
    assert got == file_set(tmp_path / "jax")
    assert "s.hist" in got and ("s.prof" in got) == ("-p" in argv)
    err = capsys.readouterr().err
    if "-t3" in argv:
        n = len(read_ktab(f"{tmp_path}/port/s"))
        assert (f"There are {print_number(n)} 40-mers that occur "
                "3-or-more times") in err


@pytest.fixture(scope="module")
def small_table(tmp_path_factory):
    """small.fasta's k=40 table at -t2, as the JAX CLI writes it."""
    d = tmp_path_factory.mktemp("ptable")
    assert jax_fastk_main(["-k40", "-t2", f"-N{d}/tab",
                           os.path.join(INPUTS, "small.fasta")]) == 0
    return f"{d}/tab.ktab"


def test_cli_relative_profiles_match_jax(tmp_path, small_table, capsys):
    """-p:<table> writes only the .prof set, and overrides -t."""
    inp = os.path.join(INPUTS, "small2.fasta")
    for name in ("jax", "port"):
        os.mkdir(tmp_path / name)
    argv = ["-k40", f"-p:{small_table}", "-t3", "-T2"]
    assert jax_fastk_main(argv + [f"-N{tmp_path}/jax/r", inp]) == 0
    assert fastk_main(argv + ["-v", f"-N{tmp_path}/port/r", inp],
                      device="cpu") == 0
    got = file_set(tmp_path / "port")
    assert got == file_set(tmp_path / "jax")
    assert "r.prof" in got and "r.hist" not in got and "r.ktab" not in got
    assert "overides -t" in capsys.readouterr().err


def test_cli_relative_table_k_mismatch_dies(tmp_path, small_table, capsys):
    with pytest.raises(SystemExit) as e:
        fastk_main(["-k32", f"-p:{small_table}", f"-N{tmp_path}/x",
                    os.path.join(INPUTS, "small.fasta")], device="cpu")
    assert e.value.code != 0
    assert "-p table k-mer size (40) != k-mer specified (32)" in (
        capsys.readouterr().err)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("env,want", [(None, 256 << 20),
                                      ("2000000", 2_000_000),
                                      ("1000", 1 << 20)])
def test_cli_honours_batch_bases_cap(tmp_path, monkeypatch, env, want):
    """FASTK_TPU_BATCH_BASES caps the batch size (at least 2^20 bases), as
    the JAX CLI does."""
    if env is None:
        monkeypatch.delenv("FASTK_TPU_BATCH_BASES", raising=False)
    else:
        monkeypatch.setenv("FASTK_TPU_BATCH_BASES", env)
    seen = {}
    real = cli_mod.count_files

    def spy(*args, **kw):
        seen["batch_bases"] = kw["batch_bases"]
        return real(*args, **kw)

    monkeypatch.setattr(cli_mod, "count_files", spy)
    assert fastk_main(["-k40", f"-N{tmp_path}/x",
                       os.path.join(INPUTS, "tiny.fasta")], device="cpu") == 0
    assert seen["batch_bases"] == want


def test_cli_removes_partial_outputs(tmp_path, monkeypatch):
    """A job that fails after its .ktab set was written and its .prof set
    begun leaves no file of either set, nor a .hist."""
    def fail(self, boff, rlen, pos_counts):
        assert any(".ktab." in n for n in os.listdir(tmp_path))
        raise RuntimeError("injected failure")

    monkeypatch.setattr(tpipe._ProfSink, "add_batch", fail)
    with pytest.raises(RuntimeError, match="injected failure"):
        fastk_main(["-k40", "-t3", "-p", f"-N{tmp_path}/x",
                    os.path.join(INPUTS, "small.fasta")], device="cpu")
    assert os.listdir(tmp_path) == []
