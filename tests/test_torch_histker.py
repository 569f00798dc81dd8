"""Port's run-length histogram (fastk_tpu_torch/ops/histker.py).

On the CPU, run_hist takes its plain torch version; it is held against a
numpy count, the Pallas kernel in interpreter mode and fastk_tpu's
hist_batch, all exactly. The CUDA kernel itself is held against the plain
version in tests/test_torch_gpu.py, which imports no JAX so that it runs on
the machine with the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import fastk_tpu.ops.histker as jhk
from fastk_tpu.ops.count import fold_invalid as jax_fold
from fastk_tpu.ops.count import hist_batch as jax_hist_batch
from fastk_tpu.ops.kmers import canonical_kmers as jax_canonical
from fastk_tpu_torch.convert import codes_from_numpy, words_from_numpy
from fastk_tpu_torch.ops import histker
from fastk_tpu_torch.ops.count import hist_batch
from fastk_tpu_torch.ops.kmers import pad_needed

K = 40
CASES = chip_smoke.crafted_masks()


def _numpy_run_hist(words: np.ndarray, valid_end: int) -> np.ndarray:
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    bits = bits[:valid_end].astype(bool)
    if valid_end:
        bits[0] = True
    pos = np.flatnonzero(bits)
    lens = np.diff(np.append(pos, valid_end))
    return np.bincount(np.minimum(lens, 32767), minlength=32768)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_run_hist_on_cpu_is_the_plain_version(case):
    _name, words, valid_end = case
    before = histker.run_hist.launches
    t = torch.from_numpy(np.ascontiguousarray(words))
    got, nvalid = histker.run_hist(t, valid_end)
    assert histker.run_hist.launches == before
    ref, _ = histker.run_hist_ref(t, valid_end)
    assert nvalid == valid_end
    assert got.dtype == torch.int64 and got.shape == (32768,)
    assert torch.equal(got, ref)
    assert np.array_equal(got.numpy(), _numpy_run_hist(words, valid_end))


def test_run_hist_rejects_bad_input():
    with pytest.raises(ValueError):
        histker.run_hist(torch.zeros(4, dtype=torch.int64), 0)
    with pytest.raises(ValueError):
        histker.run_hist(torch.zeros(4, dtype=torch.int32), 129)


def test_pack_starts_layout():
    rng = np.random.default_rng(0)
    starts = rng.random(4096) < 0.3
    got = histker.pack_starts(torch.from_numpy(starts))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), chip_smoke.pack_mask(starts))


def test_matches_pallas_kernel_interpreted(monkeypatch):
    """The case of tests/test_histker.py:test_kernel_interpret_small."""
    monkeypatch.setattr(jhk, "_INTERPRET", True)
    S = 4096
    rng = np.random.default_rng(1)
    c = rng.integers(0, 4, S + pad_needed(K)).astype(np.uint8)
    c[::211] = 4
    c[S - 40:] = 0
    c[S:] = 4
    want = jhk.hist_batch_fast(jnp.asarray(c), K, S)
    got = hist_batch(codes_from_numpy(c, "cpu"), K, S)
    assert np.array_equal(got["hist"].numpy()[1:], want["hist"][1:])
    assert got["hist"][0] == 0
    assert got["nvalid"] == want["nvalid"]


def _edge_codes(name: str) -> np.ndarray:
    """Code streams at S = 2^15 whose sorted keys hold the runs named."""
    S = 1 << 15
    rng = np.random.default_rng(7)
    c = rng.integers(0, 4, S + pad_needed(K)).astype(np.uint8)
    if name == "empty":
        c[:] = 4
    elif name == "one_run_clipped":
        c[:] = 0  # 32768 copies of A^40
    elif name == "runs_2046_2047":
        c[: 2046 + 39] = 0
        c[2046 + 39] = 4
        c[2086: 2086 + 2047 + 39] = 1
        c[2086 + 2047 + 39] = 4
    elif name in ("run_32766", "run_32767"):
        n = int(name[4:])
        c[: n + 39] = 0
        c[n + 39] = 4
    elif name == "invalid_tail":
        c[rng.random(len(c)) < 0.01] = 4
        c[S - 3000:] = 4
    elif name == "singletons":
        c[S:] = 4
    return c


EDGE = ["empty", "singletons", "one_run_clipped", "runs_2046_2047",
        "run_32766", "run_32767", "invalid_tail"]


@pytest.mark.parametrize("name", EDGE)
def test_edge_cases_match_jax_hist_batch(name):
    S = 1 << 15
    c = _edge_codes(name)
    want = jax_hist_batch(jnp.asarray(c), K, S)
    want_hist = np.asarray(want["hist"]).astype(np.int64)
    want_nvalid = int(want["nvalid"])

    # the JAX package's own sorted keys, binned by the port
    words, invalid = jax_canonical(jnp.asarray(c), K, S)
    folded = jax_fold(words, invalid)
    s_words = jax.lax.sort(folded, num_keys=len(folded))
    valid_end = S - int(np.asarray(invalid).sum())
    sw = histker.start_words(
        words_from_numpy([np.asarray(w) for w in s_words], "cpu"), valid_end)
    hist, nvalid = histker.run_hist(sw, valid_end)
    assert nvalid == want_nvalid
    assert np.array_equal(hist.numpy(), want_hist)

    # and the port's whole device path
    got = hist_batch(codes_from_numpy(c, "cpu"), K, S)
    assert got["nvalid"] == want_nvalid
    assert np.array_equal(got["hist"].numpy(), want_hist)
    if name == "one_run_clipped":
        assert want_hist[32767] == 1 and want_nvalid == S
