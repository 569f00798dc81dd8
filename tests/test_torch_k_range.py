"""The port's single-card path across the k range the CLI accepts (k up
to 256) against the JAX package's: count_reads (the histogram job, -t1 and
-t1 -p) at k = 65, 128, 129, 160 and 256, and canonical_kmers at k =
128-256. The multi-device path builds its keys with the same code."""

import numpy as np
import pytest
import torch

from fastk_tpu.ops.kmers import canonical_kmers as jax_kmers
from fastk_tpu.pipeline.count import count_reads as jax_count_reads
from fastk_tpu_torch.convert import codes_from_numpy, words_to_numpy
from fastk_tpu_torch.ops.kmers import canonical_kmers, pad_needed
from fastk_tpu_torch.pipeline.count import count_reads

import gen_data


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(256)
    genome = gen_data.make_genome(rng, 3000)
    rs = gen_data.sample_reads(rng, genome, 24, 400, n_rate=0.2,
                               upper_rate=0.3, err_rate=0.01)
    return rs + [b"acgt" * 70, b"a" * 300, b"ac"]


def _same(got, want):
    fields = ("kmer", "low", "high", "ilowcnt", "ihighcnt")
    assert [getattr(got.hist, f) for f in fields] == [
        getattr(want.hist, f) for f in fields]
    assert np.array_equal(got.hist.counts, want.hist.counts)
    assert (got.nreads, got.totlen, got.nshort) == (
        want.nreads, want.totlen, want.nshort)
    assert (got.table is None) == (want.table is None)
    if want.table is not None:
        assert np.array_equal(got.table.packed, want.table.packed)
        assert np.array_equal(got.table.counts, want.table.counts)
    assert (got.profiles is None) == (want.profiles is None)
    if want.profiles is not None:
        assert len(got.profiles) == len(want.profiles)
        assert all(np.array_equal(a, b)
                   for a, b in zip(got.profiles, want.profiles))


@pytest.mark.parametrize("k", [65, 128, 129, 160, 256])
@pytest.mark.parametrize("job", ["hist", "t1", "t1p"])
def test_count_reads_matches_jax(reads, k, job):
    kw = dict(table_min=1 if job != "hist" else None,
              profiles=job == "t1p")
    got = count_reads(reads, k, device="cpu", **kw)
    want = jax_count_reads(reads, k, **kw)
    _same(got, want)
    assert want.hist.total_instances() > 0


@pytest.mark.parametrize("k", [128, 129, 143, 160, 191, 200, 224, 255, 256])
def test_canonical_kmers_match_jax(k):
    rng = np.random.default_rng(k)
    size = 2048
    codes = rng.integers(0, 4, size + pad_needed(k)).astype(np.uint8)
    codes[rng.integers(0, size, 6)] = 4
    codes[300: 300 + k] = codes[1000: 1000 + k]  # a repeat
    words, invalid = canonical_kmers(codes_from_numpy(codes, torch.device(
        "cpu")), k, size)
    jw, jinv = jax_kmers(codes, k, size)
    assert np.array_equal(invalid.numpy(), np.asarray(jinv) != 0)
    for a, b in zip(words_to_numpy(words), jw):
        assert np.array_equal(a, np.asarray(b))
