"""The port of benchmarks/_r3decomp.py, _r3walk_res.py and _walk_ab.py
(fastk_tpu_torch/probes/decomp.py) on the CPU: the old (bincount) step and
the walk (run-length kernel's plain version) step against the JAX package's
hist_batch on the bench's batch, the keys and the sort against their JAX
expressions; a round whose steps differ raises; main's lines; no silent
fallback to the CPU."""

import io
import os
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastk_tpu.ops.count as jcount
from fastk_tpu.ops.kmers import canonical_kmers
from fastk_tpu.ops.pack import unpack_words
from fastk_tpu_torch.probes import decomp
from fastk_tpu_torch.probes.common import K, bench_batch, same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SIZE = 1 << 16
NAMES = ["h2d 16.8MB", "keys only (h2d+unpack+canon)",
         "sort3 only (resident)", "full step (h2d+all)",
         "walk step (h2d+all)", "full step resident", "old resident",
         "walk resident", "old", "walk"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel workers, where
    torch's thread pools would only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _want(size: int) -> dict:
    pw, exc, total = bench_batch(size)
    codes = unpack_words(jnp.asarray(pw), jnp.asarray(exc), total)
    words, invalid = canonical_kmers(codes, K, size)
    f = jcount.fold_invalid(words, invalid)
    hist = jcount.hist_batch(codes, K, size)
    stacked = np.stack([np.asarray(hist["hist"])] * decomp.NB)
    return {"h2d 16.8MB": pw.view(np.int32),
            "keys only (h2d+unpack+canon)": (
                f, jnp.sum(invalid.astype(jnp.int32))),
            "sort3 only (resident)": jax.lax.sort(f, num_keys=len(f)),
            "full step (h2d+all)": hist, "walk step (h2d+all)": hist,
            "full step resident": hist, "old resident": hist,
            "walk resident": hist, "old": stacked, "walk": stacked}


@pytest.fixture(scope="module")
def run():
    return dict(port=dict(decomp.cases(CPU, SIZE)), want=_want(SIZE))


@pytest.mark.parametrize("name", NAMES)
def test_case_matches_jax(run, name):
    got = run["port"][name]()
    assert same(got, run["want"][name])
    if name in ("old", "walk"):
        assert int(got[:, 1:].sum()) > 0


def test_case_names():
    assert [n for n, _ in decomp.cases(CPU, 1 << 12)] == NAMES


@pytest.mark.parametrize("seed", [0, 1])
def test_old_step_matches_jax_on_random_codes(seed):
    """old_hist_batch on codes with runs of every length, invalid windows
    and an invalid tail, against the JAX package's hist_batch."""
    size = 1 << 13
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 300, dtype=np.uint8)
    c = np.concatenate([genome[s: s + 60] for s in rng.integers(
        0, 240, size // 60 + 3)])[: size + decomp.K + 16].copy()
    c[rng.random(len(c)) < 0.002] = 4
    c[size - 100:] = 4
    got = decomp.old_hist_batch(torch.from_numpy(c), decomp.K, size)
    want = jcount.hist_batch(jnp.asarray(c), decomp.K, size)
    assert same(got, want)
    assert int(got["hist"][2:].sum()) > 0


def test_main_cpu_lines(monkeypatch):
    for name, value in (("REPS", 2), ("ROUNDS", 2), ("NB", 2)):
        monkeypatch.setattr(decomp, name, value)
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = decomp.main("cpu", size=SIZE)
    lines = buf.getvalue().splitlines()
    assert all(ln.endswith("[cpu]") for ln in lines)
    assert [re.split(r"\s{2,}", ln)[0] for ln in lines[:6]] == NAMES[:6]
    assert [ln.split(":")[0] for ln in lines[6:]] == [
        "old  resident", "walk resident", "old ", "walk"]
    assert [len(out[n]) for n in NAMES[:6]] == [decomp.REPS] * 6
    assert all(len(out[n]) == decomp.ROUNDS for n in NAMES[6:])
    for script, names in (("_r3decomp.py", NAMES[:6]),
                          ("_r3walk_res.py", ["old  resident:",
                                              "walk resident:"]),
                          ("_walk_ab.py", ['"old :', '"walk:'])):
        with open(os.path.join(REPO, "benchmarks", script)) as f:
            src = f.read()
        assert all(n in src for n in names), script


def test_a_round_that_differs_raises(monkeypatch):
    monkeypatch.setattr(decomp, "REPS", 1)
    real = decomp.hist_batch

    def off_by_one(codes, k, size):
        out = real(codes, k, size)
        out["hist"] = out["hist"].clone()
        out["hist"][1] += 1
        return out

    monkeypatch.setattr(decomp, "hist_batch", off_by_one)
    with redirect_stdout(io.StringIO()), pytest.raises(
            AssertionError, match="round 0"):
        decomp.main("cpu", size=1 << 12)


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(RuntimeError, match="cuda"):
        decomp.main()
    assert buf.getvalue() == ""
