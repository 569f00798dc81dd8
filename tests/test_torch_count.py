"""Port's counting ops against fastk_tpu.ops.count (exact): hist_batch,
unique_batch, merge_unique_blocks and the key sort."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fastk_tpu.ops.count as jcount
from fastk_tpu.ops.kmers import canonical_kmers as jax_canonical
from fastk_tpu_torch.convert import (
    codes_from_numpy,
    words_from_numpy,
    words_to_numpy,
)
from fastk_tpu_torch.ops import count as tcount
from fastk_tpu_torch.ops.kmers import canonical_kmers, pad_needed

SIZE = 2048
KS = [5, 17, 32, 33, 40, 64]


def _codes(k: int, seed: int) -> np.ndarray:
    """Reads sampled from a short genome, half reverse-complemented, so that
    keys repeat: runs of many lengths, and an invalid tail."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 400).astype(np.uint8)
    parts = []
    while sum(len(p) for p in parts) < SIZE:
        s = int(rng.integers(0, 300))
        r = genome[s: s + int(rng.integers(k, 100 + k))].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        parts += [r, np.array([4], np.uint8)]
    c = np.full(SIZE + pad_needed(k), 4, np.uint8)
    body = np.concatenate(parts)[: SIZE - 50]
    c[: len(body)] = body
    return c


@pytest.mark.parametrize("k", KS)
def test_sort_keys_matches_lax_sort(k):
    c = _codes(k, 1)
    words, invalid = jax_canonical(jnp.asarray(c), k, SIZE)
    folded = jcount.fold_invalid(words, invalid)
    want = jax.lax.sort(folded, num_keys=len(folded))
    tw, tinv = canonical_kmers(codes_from_numpy(c, "cpu"), k, SIZE)
    got, _ = tcount.sort_keys(tcount.fold_invalid(tw, tinv))
    for g, w in zip(words_to_numpy(got), want):
        assert np.array_equal(g, np.asarray(w))
    assert int(tcount.is_invalid_key(got).sum()) == int(np.asarray(
        invalid).sum())


@pytest.mark.parametrize("k", KS)
def test_hist_batch_matches_jax(k):
    c = _codes(k, 2)
    want = jcount.hist_batch(jnp.asarray(c), k, SIZE)
    got = tcount.hist_batch(codes_from_numpy(c, "cpu"), k, SIZE)
    assert np.array_equal(got["hist"].numpy(),
                          np.asarray(want["hist"]).astype(np.int64))
    assert got["nvalid"] == int(want["nvalid"])
    assert got["hist"][2:].sum() > 0  # the input does repeat keys


def _unique_matches(got, want):
    for key in ("nseg", "nuniq", "nvalid"):
        assert int(got[key]) == int(want[key]), key
    assert np.array_equal(got["seg_counts"].numpy(),
                          np.asarray(want["seg_counts"]))
    for g, w in zip(words_to_numpy(got["seg_words"]), want["seg_words"]):
        assert np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("k", KS)
def test_unique_batch_and_merge_match_jax(k):
    blocks = []
    for seed in (3, 4):
        c = _codes(k, seed)
        want = jcount.unique_batch(jnp.asarray(c), k, SIZE)
        got = tcount.unique_batch(codes_from_numpy(c, "cpu"), k, SIZE)
        _unique_matches(got, want)
        blocks.append(want)
    # merge the JAX blocks in both packages
    words = tuple(np.concatenate([np.asarray(b["seg_words"][j])
                                  for b in blocks])
                  for j in range(len(blocks[0]["seg_words"])))
    counts = np.concatenate([np.asarray(b["seg_counts"]) for b in blocks])
    want = jcount.merge_unique_blocks(
        tuple(jnp.asarray(w) for w in words), jnp.asarray(counts),
        2 * SIZE, k)
    got = tcount.merge_unique_blocks(words_from_numpy(words, "cpu"),
                                     torch.from_numpy(counts))
    assert int(got["nuniq"]) == int(want["nuniq"])
    assert np.array_equal(got["seg_counts"].numpy(),
                          np.asarray(want["seg_counts"]))
    for g, w in zip(words_to_numpy(got["seg_words"]), want["seg_words"]):
        assert np.array_equal(g, np.asarray(w))
    assert np.array_equal(got["hist"].numpy(),
                          np.asarray(want["hist"]).astype(np.int64))


ONES = tcount.ONES


def _sorted_records(case: str) -> np.ndarray:
    """Sorted two-word keys [size, 2] of one segment layout."""
    rng = np.random.default_rng(22)
    if case == "one_run":
        keys = np.tile([[5, 9]], (11, 1))
    elif case == "all_distinct":
        keys = np.stack([np.zeros(13), np.arange(13) * 3 + 1], axis=1)
    elif case == "trailing_ones":
        lens = rng.integers(1, 5, size=6)
        keys = np.concatenate([np.tile([[i // 2, i]], (n, 1))
                               for i, n in enumerate(lens)]
                              + [np.full((4, 2), ONES)])
    elif case == "all_ones":
        keys = np.full((6, 2), ONES)
    else:  # size_one
        keys = np.array([[7, 3]])
    return keys.astype(np.int64)


def _plain_segments(keys: np.ndarray, weights: np.ndarray):
    """(nseg, counts, words [nseg, 2]) by a loop over the records."""
    starts = [0] + [i for i in range(1, len(keys))
                    if (keys[i] != keys[i - 1]).any()]
    ends = starts[1:] + [len(keys)]
    counts = [int(weights[s:e].sum()) for s, e in zip(starts, ends)]
    return len(starts), counts, keys[starts]


@pytest.mark.parametrize("weighted", [False, True], ids=["runs", "weights"])
@pytest.mark.parametrize("case", ["one_run", "all_distinct", "trailing_ones",
                                  "all_ones", "size_one"])
def test_segment_reduce_against_a_plain_segment_sum(case, weighted):
    """segment_reduce's dump slot sits past the last end bound: the run
    starts' scatter never writes the bound, which keeps its fill."""
    keys = _sorted_records(case)
    size = len(keys)
    weights = (np.random.default_rng(size).integers(1, 6, size).astype(
        np.int32) if weighted else np.ones(size, np.int32))
    nseg, counts, words = _plain_segments(keys, weights)
    s_words = tuple(torch.from_numpy(keys[:, j].copy()) for j in range(2))
    got = tcount.segment_reduce(
        s_words, weights=torch.from_numpy(weights) if weighted else None)
    assert int(got["nseg"]) == nseg
    want_counts = np.zeros(size, np.int32)
    want_counts[:nseg] = counts
    assert got["seg_counts"].dtype == torch.int32
    assert np.array_equal(got["seg_counts"].numpy(), want_counts)
    for j, w in enumerate(got["seg_words"]):
        want = np.full(size, ONES, np.int64)
        want[:nseg] = words[:, j]
        assert np.array_equal(w.numpy(), want)
