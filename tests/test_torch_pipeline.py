"""The port's histogram job end to end on the CPU: byte-identical .hist
files against the oracle goldens and against fastk_tpu's own pipeline."""

import os

import numpy as np
import pytest

from fastk_tpu.formats.hist import write_histogram
from fastk_tpu.pipeline.count import count_files as jax_count_files
from fastk_tpu_torch.pipeline.count import count_files
from fastk_tpu_torch.tools.fastk import main as fastk_main

import gen_data

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


@pytest.mark.parametrize("flag", ["-t", "-t3", "-p", "-p:x.ktab", "-R"])
def test_cli_unported_modes_die(tmp_path, flag, capsys):
    with pytest.raises(SystemExit) as e:
        fastk_main([flag, f"-N{tmp_path}/x",
                    os.path.join(INPUTS, "tiny.fasta")], device="cpu")
    assert e.value.code != 0
    assert "not yet ported" in capsys.readouterr().err
