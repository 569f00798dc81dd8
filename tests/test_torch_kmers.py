"""Port's canonical k-mer keys against fastk_tpu.ops.kmers (exact)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastk_tpu.ops.kmers import canonical_kmers as jax_canonical
from fastk_tpu_torch.convert import codes_from_numpy, words_to_numpy
from fastk_tpu_torch.ops.kmers import canonical_kmers, nwords, pad_needed

SIZE = 2048


@pytest.mark.parametrize("k", [5, 16, 17, 31, 32, 33, 40, 64, 96, 127])
def test_canonical_kmers_match_jax(k):
    rng = np.random.default_rng(k)
    c = rng.integers(0, 4, SIZE + pad_needed(k)).astype(np.uint8)
    c[rng.random(len(c)) < 0.002] = 4
    c[SIZE // 2: SIZE // 2 + 2 * k] = 0  # A^n: fwd and rc windows tie-break
    c[SIZE - 3:] = 4
    want_words, want_inv = jax_canonical(jnp.asarray(c), k, SIZE)
    words, inv = canonical_kmers(codes_from_numpy(c, "cpu"), k, SIZE)
    assert len(words) == nwords(k)
    assert inv.dtype == torch.bool
    assert np.array_equal(inv.numpy(), np.asarray(want_inv) != 0)
    for got, want in zip(words_to_numpy(words), want_words):
        assert np.array_equal(got, np.asarray(want))
