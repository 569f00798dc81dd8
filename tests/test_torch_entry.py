"""The port's entry points (fastk_tpu_torch/entry.py) against the
JAX package's (__graft_entry__.py) on the CPU: the example codes, the
single-card step, and dryrun_multichip in gloo worlds of 1, 2 and 4
processes, its refusals, and a world whose rank fails."""

import os
import time

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import fastk_tpu.ops.count as jcount
from fastk_tpu_torch import entry
from fastk_tpu_torch.convert import words_to_numpy
from fastk_tpu_torch.parallel import launch

import torch_dist_worker as tw


@pytest.mark.parametrize("n,k,seed", [(4096, 24, 1), (1 << 17, 40, 0),
                                      (1000, 5, 3), (2000, 160, 7)])
def test_example_codes_match_jax(n, k, seed):
    got = entry._example_codes(n, k, seed)
    want = jentry._example_codes(n, k, seed)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)


def test_entry_step_matches_jax():
    """entry(device="cpu")'s step equals the JAX entry's on the same codes
    (segments, counts, pos_counts), and its histogram equals JAX's
    count_batch with the histogram on."""
    fn, (codes,) = entry.entry(device="cpu")
    jfn, (jcodes,) = jentry.entry()
    assert codes.device.type == "cpu"
    assert np.array_equal(codes.numpy(), jcodes)
    got = fn(codes)
    want = jfn(jcodes)
    for key in ("nseg", "nvalid", "overflow"):
        assert int(got[key]) == int(want[key]), key
    for key in ("seg_counts", "seg_valid"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    for g, w in zip(words_to_numpy(got["seg_words"]), want["seg_words"]):
        assert np.array_equal(g, np.asarray(w))
    assert np.array_equal(got["pos_counts"].numpy().view(np.uint16),
                          np.asarray(want["pos_counts"]))
    hist = jcount.count_batch(jcodes, entry.ENTRY_K, entry.ENTRY_SIZE, True,
                              True)["hist"]
    assert np.array_equal(got["hist"].numpy(),
                          np.asarray(hist).astype(np.int64))
    assert int(got["hist"][1:].sum()) > 0


@pytest.mark.parametrize("world", [1, 2, 4])
def test_dryrun_multichip_gloo_worlds(world, monkeypatch):
    runs = []
    real = entry.run_dryrun
    monkeypatch.setattr(entry, "run_dryrun",
                        lambda *a: runs.append(real(*a)) or runs[-1])
    assert entry.dryrun_multichip(world, device="cpu") is None
    (reports,) = runs
    assert [r["rank"] for r in reports] == list(range(world))
    assert all(r["world"] == world and r["device"] == "cpu"
               for r in reports)
    # the mesh job walked several batches on every rank
    assert all(sum(r["mesh_stats"]["phase_s"]) > 0 for r in reports)


def test_dryrun_multichip_needs_the_card():
    assert not torch.cuda.is_available()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        entry.entry()
    assert time.monotonic() - t0 < 5


def test_dryrun_multichip_refuses_more_ranks_than_cards(monkeypatch):
    """Two ranks on a one-card machine: refused, naming the counts, with
    no world started (no CPU world and no smaller one in its place)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def started(*a, **kw):
        raise AssertionError("a world was started")

    monkeypatch.setattr(launch, "run_world", started)
    with pytest.raises(ValueError, match=r"needs 2 cards.*has 1"):
        entry.dryrun_multichip(2)


def test_dryrun_multichip_failed_rank_surfaces(monkeypatch):
    """A world of 2 whose rank 1 fails in its second step
    (tests/torch_dist_worker.py task "dryrun"): dryrun_multichip raises
    WorldFailed with that rank's standard error, well within the bound,
    instead of hanging."""
    monkeypatch.setattr(entry, "WORKER", tw.COMMAND)
    t0 = time.monotonic()
    with pytest.raises(launch.WorldFailed) as err:
        entry.dryrun_multichip(2, device="cpu")
    # the peer's collective fails when rank 1 is gone, before any timeout
    assert time.monotonic() - t0 < launch.PG_TIMEOUT_S
    text = str(err.value)
    assert "rank 1 made to fail" in text
    assert "--- rank 1 (rc 1)" in text
    assert os.path.basename(tw.COMMAND[1]) == "torch_dist_worker.py"
