"""The port's table ops against fastk_tpu (exact): merge_unique_blocks with
want_back, the merge operands (pad_counted against JAX's pad_counted_pow2)
and merge_counted on both of its paths."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fastk_tpu.ops.count as jcount
import fastk_tpu.ops.tables as jtables
from fastk_tpu_torch.convert import words_from_numpy, words_to_numpy
from fastk_tpu_torch.ops import count as tcount
from fastk_tpu_torch.ops import tables as ttables
from fastk_tpu_torch.ops.kmers import nwords

SIZE = 4096


def _keys(rng, n: int, k: int) -> np.ndarray:
    """n random packed k-mer word rows (uint32 (n, W)): the last word holds
    only its 2L high bits, as ops/kmers.py packs it."""
    W = nwords(k)
    words = rng.integers(0, 1 << 32, (n, W), dtype=np.uint64).astype(
        np.uint32)
    L = k - 16 * (W - 1)
    words[:, -1] &= np.uint32(((1 << (2 * L)) - 1) << (32 - 2 * L))
    return words


def _blocks(k: int, seed: int):
    """SIZE records drawn from 600 keys (so keys repeat across the input),
    a fifth of them empty slots (all-ones, count 0), and counts up to 20000,
    so that some merged counts pass 32767."""
    rng = np.random.default_rng(seed)
    pool = _keys(rng, 600, k)
    words = pool[rng.integers(0, len(pool), SIZE)]
    counts = rng.integers(1, 40, SIZE).astype(np.int32)
    counts[rng.random(SIZE) < 0.02] = 20000
    empty = rng.random(SIZE) < 0.2
    words[empty] = 0xFFFFFFFF
    counts[empty] = 0
    return words, counts


@pytest.mark.parametrize("k", [17, 32, 40, 64])
@pytest.mark.parametrize("want_back", [False, True])
def test_merge_unique_blocks_matches_jax(k, want_back):
    words, counts = _blocks(k, k)
    cols = tuple(words[:, j] for j in range(words.shape[1]))
    want = jcount.merge_unique_blocks(
        tuple(jnp.asarray(c) for c in cols), jnp.asarray(counts), SIZE, k,
        want_back=want_back)
    got = tcount.merge_unique_blocks(words_from_numpy(cols, "cpu"),
                                     torch.from_numpy(counts),
                                     want_back=want_back)
    assert int(got["nuniq"]) == int(want["nuniq"])
    assert np.array_equal(got["seg_counts"].numpy(),
                          np.asarray(want["seg_counts"]))
    for g, w in zip(words_to_numpy(got["seg_words"]), want["seg_words"]):
        assert np.array_equal(g, np.asarray(w))
    assert np.array_equal(got["hist"].numpy(),
                          np.asarray(want["hist"]).astype(np.int64))
    assert ("rec_counts" in got) == want_back
    if want_back:
        rec = got["rec_counts"].numpy()
        assert np.array_equal(rec, np.asarray(want["rec_counts"]))
        assert rec.max() == 32767 and (rec[counts == 0] == 0).all()


@pytest.mark.parametrize("n", [0, 1, 5000])
def test_pad_counted_matches_jax_operands(n):
    """The port's operands are JAX's pad_counted_pow2 operands without the
    pow2 tail: the same records, and one empty slot when there are none."""
    rng = np.random.default_rng(n)
    words = _keys(rng, n, 40)
    counts = rng.integers(1, 100, n).astype(np.uint32)
    jw, jc, cap = jtables.pad_counted_pow2(words, counts, 3)
    tw, tc = ttables.pad_counted(words, counts, "cpu")
    m = max(n, 1)
    assert cap >= m and tc.numel() == m
    for g, w in zip(words_to_numpy(tw), jw):
        assert np.array_equal(g, np.asarray(w)[:m])
    assert np.array_equal(tc.numpy(), np.asarray(jc)[:m])
    assert (np.asarray(jc)[m:] == 0).all()


@pytest.mark.parametrize("device_path", [False, True])
def test_merge_counted_matches_jax(monkeypatch, device_path):
    """Both paths of merge_counted (the device merge from DEVICE_MIN_ROWS
    rows on, numpy below) give JAX's rows and summed counts."""
    if device_path:
        monkeypatch.setattr(jtables, "DEVICE_MIN_ROWS", 1000)
        monkeypatch.setattr(ttables, "DEVICE_MIN_ROWS", 1000)
    rng = np.random.default_rng(5)
    pool = _keys(rng, 700, 40)
    words_list, counts_list = [], []
    for n in (900, 1300, 50):
        words_list.append(pool[rng.integers(0, len(pool), n)])
        counts_list.append(rng.integers(1, 1 << 20, n).astype(np.int64))
    want_w, want_c = jtables.merge_counted(words_list, counts_list)
    used = {"n": 0}
    real = ttables.merge_unique_blocks

    def spy(*a, **kw):
        used["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(ttables, "merge_unique_blocks", spy)
    got_w, got_c = ttables.merge_counted(words_list, counts_list,
                                         device="cpu")
    assert used["n"] == int(device_path)
    assert got_w.dtype == np.uint32 and got_c.dtype == np.int64
    assert np.array_equal(got_w, want_w)
    assert np.array_equal(got_c, want_c)
    assert len(got_c) < sum(len(c) for c in counts_list)
