"""The port's bench (fastk_tpu_torch/bench.py), its fused-job probe
(probes/profiles.py), its stage timer (probes/stages.py) and
ops/tables.sort_counted against the JAX package on the CPU: the same numpy
inputs through both, compared exactly; the bench's analytic exceptions
against pack_stream's; its device probe; its JSON lines; and no silent
fallback to the CPU."""

import importlib.util
import io
import json
import os
import subprocess
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastk_tpu.ops import tables as jax_tables
from fastk_tpu.ops.count import count_batch as jax_count_batch
from fastk_tpu.ops.count import hist_batch as jax_hist_batch
from fastk_tpu.ops.count import segmented_count as jax_segmented_count
from fastk_tpu.ops.count import sort_records as jax_sort_records
from fastk_tpu.ops.kmers import canonical_kmers as jax_canonical_kmers
from fastk_tpu.ops.pack import unpack_stream as jax_unpack_stream
from fastk_tpu.ops.pack import unpack_words as jax_unpack_words
from fastk_tpu_torch import bench
from fastk_tpu_torch.ops import tables
from fastk_tpu_torch.ops.count import fold_invalid
from fastk_tpu_torch.ops.pack import pack_stream
from fastk_tpu_torch.probes import profiles, stages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SIZE, READ_LEN, GENOME = 1 << 16, 1000, 20_000  # tests/test_bench.py's
STAGE_SIZE = 1 << 15  # two of prof_stages.py's sentinels, at 0 and 20001


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(
        rel.replace("/", "_")[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _source(rel: str) -> str:
    with open(os.path.join(REPO, rel)) as f:
        return f.read()


@pytest.fixture(scope="module")
def batch():
    """The bench's toy batch, and the JAX package's codes unpacked from it."""
    pw, exc, total, nreads = bench.bench_input(SIZE, GENOME, READ_LEN)
    codes = jax_unpack_words(jnp.asarray(pw), jnp.asarray(exc), total)
    return dict(pw=pw, exc=exc, total=total, nreads=nreads, jax_codes=codes)


@pytest.fixture
def toy_bench(monkeypatch):
    """The bench's constants at toy size: 3 trials of 4 batches each."""
    for name, value in (("SIZE", SIZE), ("READ_LEN", READ_LEN),
                        ("GENOME", GENOME), ("HEADLINE_BASES", 4 * SIZE),
                        ("FUSED_BASES", 4 * SIZE), ("HEADLINE_BUDGET_S", 0),
                        ("FUSED_BUDGET_S", 0)):
        monkeypatch.setattr(bench, name, value)


def _lines(fn, *args) -> list:
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def test_constants_are_bench_py_s():
    jb = _load("bench.py")
    for name in ("K", "SIZE", "READ_LEN", "GENOME", "BASELINE_BASES_PER_SEC",
                 "BASELINE_FUSED"):
        assert getattr(bench, name) == getattr(jb, name), name
    src = _source("bench.py")
    for metric in (bench.METRIC, bench.FUSED_METRIC):
        assert f'"metric": "{metric}"' in src
    assert f'"metric": "{profiles.METRIC}"' in _source(
        "benchmarks/bench_profiles.py")


@pytest.mark.parametrize("step", ["headline", "fused"])
def test_step_matches_jax(batch, step):
    """The bench's timed step on the CPU against the JAX bench's on the same
    packed words and exceptions: histogram and nvalid (headline), nvalid,
    nseg and pos_counts (fused), exact."""
    args = (batch["pw"], batch["exc"], batch["total"], SIZE, CPU)
    nvalid_expect = batch["nreads"] * (READ_LEN - bench.K + 1)
    if step == "headline":
        hist, nvalid = bench.headline_step(*args)
        want = jax_hist_batch(batch["jax_codes"], bench.K, SIZE)
        assert np.array_equal(hist.numpy(), np.asarray(want["hist"]))
        assert nvalid == int(want["nvalid"]) == nvalid_expect
        counts = np.arange(len(hist))
        assert int((counts * hist.numpy()).sum()) == nvalid
    else:
        nvalid, nseg, pos_counts = bench.fused_step(*args)
        want = jax_count_batch(batch["jax_codes"], bench.K, SIZE, True, False)
        assert int(nvalid) == int(want["nvalid"]) == nvalid_expect
        assert int(nseg) == int(want["nseg"])
        assert np.array_equal(pos_counts.numpy().view(np.uint16),
                              np.asarray(want["pos_counts"]))


@pytest.mark.parametrize("size,read_len", [
    (SIZE, READ_LEN), (1 << 14, 777), (3 * 4096 + 5, 100)])
def test_analytic_exceptions_are_pack_stream_s(size, read_len):
    pw, exc, total, nreads = bench.bench_input(size, 5000, read_len, seed=3)
    block, _, _ = bench.synth_hifi(size, 5000, read_len, seed=3)
    codes = np.concatenate([block, np.full(total - len(block), 4, np.uint8)])
    packed, want = pack_stream(codes)
    assert np.array_equal(exc, want)
    # the production words are the numpy packer's bytes, padded to a word
    assert np.array_equal(pw.view(np.uint8)[: len(packed)], packed)
    assert not pw.view(np.uint8)[len(packed):].any()


def test_synth_hifi_is_seeded_with_sentinels_every_stride():
    a, nreads, stride = bench.synth_hifi(SIZE, GENOME, READ_LEN, seed=5)
    b, _, _ = bench.synth_hifi(SIZE, GENOME, READ_LEN, seed=5)
    c, _, _ = bench.synth_hifi(SIZE, GENOME, READ_LEN, seed=6)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert (nreads, stride) == (SIZE // (READ_LEN + 1), READ_LEN + 1)
    assert len(a) == nreads * stride and a.dtype == np.uint8
    assert np.array_equal(np.flatnonzero(a >= 4),
                          np.arange(stride - 1, len(a), stride))
    assert a.max() == 4


@pytest.mark.parametrize("failure", ["exit", "hang"])
def test_wait_for_device_never_raises(monkeypatch, failure):
    """A failing or hanging probe is retried, and never raises: the bench
    goes on to its own error."""
    calls, sleeps = [], []

    class Failed:
        returncode = 1
        stderr = b"no device"

    def run(*a, **kw):
        calls.append(a[0])
        if failure == "hang":
            raise subprocess.TimeoutExpired(a[0], kw["timeout"])
        return Failed()

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(bench.time, "sleep", sleeps.append)
    bench._wait_for_device(tries=3, probe_timeout=1)
    assert len(calls) == 3 and sleeps == [90, 90]
    assert "cuda" in calls[0][-1]


def test_bench_main_cpu_lines(toy_bench):
    lines = [json.loads(ln) for ln in _lines(bench.main, "cpu")]
    fused, diag, head = lines
    cpu = {"platform": "cpu", "name": "cpu", "count": 0, "power_limit": None}
    assert fused["metric"] == bench.FUSED_METRIC
    assert head["metric"] == bench.METRIC
    for line in (fused, head):
        assert line["unit"] == "bases/sec" and line["value"] > 0
        assert line["batch_size"] == SIZE
        assert line["band"]["n_trials"] == 3
        assert line["band"]["min"] <= line["band"]["median"] \
            <= line["band"]["max"] == line["value"]
    assert head["vs_baseline"] == round(
        head["value"] / bench.BASELINE_BASES_PER_SEC, 3)
    assert head["fused_value"] == fused["value"]
    assert head["fused_band"] == fused["band"]
    assert head["fused_vs_baseline"] == round(
        fused["value"] / bench.BASELINE_FUSED, 3)
    assert all(line["device"] == cpu for line in lines)
    # no device numbers from a CPU run, and no diagnostic steps: the
    # warm-up and 3 trials of 4 batches; the plain binning counts no launch
    assert diag["host_syncs"] is diag["pin_ms"] is diag["step_ms"] is None
    assert diag["host_blocked_ms"] is diag["sync_sites"] is None
    assert diag["steps"] == 1 + 3 * 4 and diag["run_hist_launches"] == 0


def test_bench_headline_survives_a_fused_failure(toy_bench, monkeypatch):
    def broken(*a):
        raise RuntimeError("fused broke")

    monkeypatch.setattr(bench, "fused_step", broken)
    lines = [json.loads(ln) for ln in _lines(bench.main, "cpu")]
    assert len(lines) == 2 and lines[-1]["metric"] == bench.METRIC
    assert "fused_value" not in lines[-1]


@pytest.mark.parametrize("module", [bench, profiles, stages])
def test_main_raises_without_a_card(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "_wait_for_device", lambda: None)
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(RuntimeError, match="cuda"):
        module.main()
    assert buf.getvalue() == ""


def test_profiles_match_jax(toy_bench):
    codes, nreads = profiles.batch_codes(SIZE, GENOME, READ_LEN)
    nvalid, pos_counts, hist = profiles.step(torch.from_numpy(codes), SIZE)
    want = jax_count_batch(jnp.asarray(codes), bench.K, SIZE, True, True)
    assert int(nvalid) == int(want["nvalid"]) == nreads * (
        READ_LEN - bench.K + 1)
    assert np.array_equal(pos_counts.numpy().view(np.uint16),
                          np.asarray(want["pos_counts"]))
    assert np.array_equal(hist.numpy(), np.asarray(want["hist"]))
    (line,) = [json.loads(ln) for ln in _lines(profiles.main, "cpu")]
    assert line["metric"] == profiles.METRIC and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / profiles.BASELINE, 3)
    assert line["device"]["name"] == "cpu"


@pytest.fixture(scope="module")
def stage_run():
    """The port's stages at STAGE_SIZE, and the JAX calls of
    prof_stages.py on the same input."""
    codes, packed, exc = stages.stage_input(STAGE_SIZE)
    total = len(codes)
    j = {}
    j["codes"] = jax_unpack_stream(jnp.asarray(packed), jnp.asarray(exc),
                                   total)
    j["words"], j["invalid"] = jax_canonical_kmers(j["codes"], stages.K,
                                                   STAGE_SIZE)
    j["s_words"], j["s_inv"], _ = jax_sort_records(j["words"], j["invalid"])
    return dict(port=dict(stages.stages(CPU, STAGE_SIZE)), jax=j,
                packed=packed, total=total)


def _eq(t, a) -> bool:
    return np.array_equal(np.asarray(t), np.asarray(a).astype(np.int64))


STAGES = ["null (sync latency)", "unpack_stream", "canonical_kmers",
          "sort_records (1+3 keys)", "lax.sort 1 key (ref point)",
          "lax.sort 3 keys no values", "segmented_count(hist+compaction)",
          "seg hist only (no compaction)", "count_batch full (hist)"]


@pytest.mark.parametrize("name", STAGES)
def test_stage_matches_jax(stage_run, name):
    """Each stage's output on the CPU against the JAX stage of the same
    name in benchmarks/prof_stages.py, on its input, exact."""
    j = stage_run["jax"]
    got = stage_run["port"][name]()
    size, K = STAGE_SIZE, stages.K
    if name == "null (sync latency)":
        assert _eq(got, stage_run["packed"][:1])
    elif name == "unpack_stream":
        assert _eq(got, j["codes"])
    elif name == "canonical_kmers":
        words, invalid = got
        assert all(_eq(w, jw) for w, jw in zip(words, j["words"]))
        assert _eq(invalid, j["invalid"])
    elif name == "sort_records (1+3 keys)":
        s_words, (s_pos,) = got
        assert all(_eq(w, jw) for w, jw in zip(s_words, j["s_words"]))
        folded = fold_invalid(*stage_run["port"]["canonical_kmers"]())
        assert all(torch.equal(f[s_pos.long()], w)
                   for f, w in zip(folded, s_words))
    elif name == "lax.sort 1 key (ref point)":
        values, _ = got
        assert _eq(values, jax.lax.sort((j["words"][0],), num_keys=1)[0])
    elif name == "lax.sort 3 keys no values":
        s_words, values = got
        assert values == ()
        want = jax.lax.sort(j["words"], num_keys=3)
        assert all(_eq(w, jw) for w, jw in zip(s_words, want))
    elif name == "segmented_count(hist+compaction)":
        want = jax_segmented_count(j["s_words"], j["s_inv"], size,
                                   want_hist=True)
        for key in ("hist", "nseg", "seg_counts", "seg_valid", "overflow"):
            assert _eq(got[key], want[key]), key
        n = int(got["nseg"])
        assert all(_eq(w[:n], jw[:n])
                   for w, jw in zip(got["seg_words"], want["seg_words"]))
    elif name == "seg hist only (no compaction)":
        hist, valid_end = got
        want = jax_hist_batch(j["codes"], K, size)
        assert _eq(hist, want["hist"]) and valid_end == int(want["nvalid"])
    else:
        want = jax_count_batch(j["codes"], K, size, False, True)
        for key in ("hist", "nvalid", "nseg", "seg_counts", "overflow"):
            assert _eq(got[key], want[key]), key


def test_stages_main_cpu_lines(monkeypatch):
    monkeypatch.setattr(stages, "SIZE", STAGE_SIZE)
    monkeypatch.setattr(stages, "RUNS", 1)
    lines = _lines(stages.main, "cpu")
    assert [ln[:38].rstrip() for ln in lines] == STAGES
    for ln in lines:
        ms, unit, rate, rate_unit, dev = ln[38:].split()
        assert float(ms) > 0 and unit == "ms" and rate_unit == "Mpos/s"
        assert dev == "[cpu]"


@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("force_device", [False, True])
def test_sort_counted_matches_jax(monkeypatch, W, force_device):
    """tests/test_tables_device.py's input through both packages' sort_counted,
    below DEVICE_MIN_ROWS (numpy) and above it (the device sort)."""
    if force_device:
        monkeypatch.setattr(jax_tables, "DEVICE_MIN_ROWS", 0)
        monkeypatch.setattr(tables, "DEVICE_MIN_ROWS", 0)
    rng = np.random.default_rng(2)
    w = rng.integers(0, 1 << 32, size=(700, 3), dtype=np.int64
                     ).astype(np.uint32)
    c = rng.integers(1, 100, size=700).astype(np.uint16)
    w = np.ascontiguousarray(w[:, :W])
    assert len(np.unique(w, axis=0)) == len(w)  # distinct keys
    got_w, got_c = tables.sort_counted(w, c, device="cpu")
    want_w, want_c = jax_tables.sort_counted(w, c)
    assert np.array_equal(got_w, want_w) and got_w.dtype == want_w.dtype
    assert np.array_equal(got_c, want_c) and got_c.dtype == want_c.dtype
