"""Port's 2-bit packed transfer against fastk_tpu.ops.pack (exact)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fastk_tpu.ops.pack as jpack
import fastk_tpu_torch.ops.pack as tpack
from fastk_tpu import native


def _stream(n, seed):
    """Random codes with N runs, read sentinels (4) and a sentinel tail."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, n).astype(np.uint8)
    c[rng.random(n) < 0.02] = 4
    for p in rng.integers(0, max(n - 6, 1), 3):
        c[p: p + 5] = 4
    c[-min(n, 7):] = 4
    return c


@pytest.mark.parametrize("n", [1, 17, 1000, 4099, 70001])
def test_unpack_words_matches_jax(n):
    codes = _stream(n, n)
    pw, exc = tpack.pack_stream_words(codes, cap_step=64)
    jpw, jexc = jpack.pack_stream_words(codes, cap_step=64)
    assert np.array_equal(pw, jpw) and np.array_equal(exc, jexc)
    assert (exc == tpack.EXC_PAD).any()  # pad entries reach the dump slot
    want = np.asarray(jpack.unpack_words(jnp.asarray(jpw), jnp.asarray(jexc),
                                         n))
    got = tpack.upload_packed(pw, exc, n, torch.device("cpu"))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.minimum(codes, 4))


def test_numpy_packer_matches_native(monkeypatch):
    codes = _stream(5000, 3)
    native_out = tpack.pack_stream_words(codes)
    monkeypatch.setattr(native, "pack2", lambda *a, **kw: None)
    numpy_out = tpack.pack_stream_words(codes)
    for a, b in zip(native_out, numpy_out):
        assert np.array_equal(a, b)
