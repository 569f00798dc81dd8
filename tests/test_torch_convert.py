"""The port's host-device copies (fastk_tpu_torch/convert.py) on the CPU: key
words round-trip exactly through their int32 wire form, real keys stay in
[0, 2^32), and each fetch records the wait site its caller names."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fastk_tpu_torch import trace
from fastk_tpu_torch.convert import (
    device_codes,
    fetch,
    fetch_async,
    fetch_u16,
    words_from_numpy,
    words_to_numpy,
    words_to_numpy_async,
)
from fastk_tpu_torch.ops.count import ONES
from fastk_tpu_torch.ops.kmers import canonical_kmers, nwords, pad_needed

SIZE = 1024
KS = [5, 16, 17, 21, 40, 64, 65, 127]


def _words(k: int, m: int) -> np.ndarray:
    """(W, m) uint32 words: random, with bit 31 set in a quarter of them,
    all-ones slots (an invalid record or an empty slot), and 0x7FFFFFFF and
    0x80000000 beside them."""
    rng = np.random.default_rng(k)
    w = rng.integers(0, 1 << 32, (nwords(k), m), dtype=np.uint64)
    w[:, rng.random(m) < 0.25] |= 1 << 31
    w[:, m - 3] = ONES
    w[:, m // 2] = ONES
    w[:, 0] = 0x7FFFFFFF
    w[:, 1] = 0x80000000
    return w.astype(np.uint32)


@pytest.mark.parametrize("n", ["all", "none", "some"])
@pytest.mark.parametrize("k", KS)
def test_words_round_trip(k, n):
    host = _words(k, SIZE)
    n = {"all": None, "none": 0, "some": SIZE - 5}[n]
    words = words_from_numpy(tuple(host), "cpu")
    assert len(words) == nwords(k)
    for w, h in zip(words, host):
        assert w.dtype == torch.int64 and w.shape == (SIZE,)
        assert np.array_equal(w.numpy(), h.astype(np.int64))
    assert int(words[0][SIZE - 3]) == ONES
    want = host[:, :n] if n is not None else host
    got = words_to_numpy(words, n)
    assert got.dtype == np.uint32 and got.shape == want.shape
    assert np.array_equal(got, want)
    # the rows of a (W, n) array go up as the same words
    again = words_from_numpy(got, "cpu")
    assert all(np.array_equal(w.numpy(), h.astype(np.int64))
               for w, h in zip(again, want))
    # the async form, with int32 counts as one more row
    counts = torch.arange(SIZE, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.job():
            rec = words_to_numpy_async(words + (counts,), len(want[0]),
                                       "slice_records")()
    assert "wait.slice_records" in trace.jobs()[-1]["spans"]
    assert np.array_equal(rec[:-1], want)
    assert np.array_equal(rec[-1], np.arange(len(want[0])))


@pytest.mark.parametrize("k", KS)
def test_keys_stay_32_bit(k):
    """Canonical keys, invalid windows folded to all-ones, fill their int64
    words with 32-bit values, so that their int32 bits carry them."""
    rng = np.random.default_rng(100 + k)
    c = rng.integers(0, 4, SIZE + pad_needed(k)).astype(np.uint8)
    c[rng.random(len(c)) < 0.01] = 4
    words, invalid = canonical_kmers(device_codes(c, "cpu"), k, SIZE)
    words = tuple(torch.where(invalid, ONES, w) for w in words)
    for w in words:
        assert 0 <= int(w.min()) and int(w.max()) <= ONES
    host = words_to_numpy(words)
    assert all(np.array_equal(w.numpy(), h.astype(np.int64))
               for w, h in zip(words, host))
    back = words_from_numpy(host, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, words))


def _recorded(site, fn):
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.job():
            out = fn()
    assert trace.jobs()[-1]["spans"]["wait." + site]["calls"] == 1
    return out


@pytest.mark.parametrize("case", ["scalar", "u16_counts", "i32_words"])
def test_fetch_records_its_site(case):
    if case == "scalar":
        t = torch.tensor(12345678901, dtype=torch.int64)
        got = _recorded("later", lambda: fetch_async(t, "later")())
        assert got.shape == () and int(got) == 12345678901
        assert int(_recorded("plan_nuniq", lambda: fetch(t, "plan_nuniq"))) \
            == 12345678901
    elif case == "u16_counts":
        c = torch.tensor([0, 1, 255, 256, 32767, 40000], dtype=torch.int32)
        c = torch.clamp(c, max=32767)
        got = _recorded("fetch_u16", lambda: fetch_u16(c))
        assert got.dtype == np.uint16
        assert got.tolist() == [0, 1, 255, 256, 32767, 32767]
    else:
        w = torch.tensor([0, 1, -1, -(1 << 31), (1 << 31) - 1],
                         dtype=torch.int32)
        got = _recorded("table_words",
                        lambda: fetch_async(w, "table_words")())
        assert got.dtype == np.int32
        assert got.view(np.uint32).tolist() == [0, 1, ONES, 1 << 31,
                                                (1 << 31) - 1]
