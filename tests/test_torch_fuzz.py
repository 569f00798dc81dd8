"""Seeded fuzz of the port's pipeline (count_reads on the CPU): random k,
read shapes, N placement, case mixing and duplicated reads, held against
the brute-force model (tests/util_bruteforce.py) and against the JAX
package's count_reads on the same reads: the histogram, the table's keys
and counts, and every profile, exactly. The cases are
tests/test_fuzz.py's, seed for seed."""

import numpy as np
import pytest

from fastk_tpu.pipeline.count import count_reads as jax_count_reads
from fastk_tpu_torch.formats.ktab import pack_kmer
from fastk_tpu_torch.pipeline.count import count_reads

from test_fuzz import _random_case
from util_bruteforce import count_kmers, profiles_of, sorted_table


def _check(reads, k, seed, hc=False, **kw):
    raw = [r.encode() for r in reads]
    got = count_reads(raw, k, table_min=1, profiles=True, hc=hc,
                      device="cpu", **kw)
    want = count_kmers(reads, k, hc=hc)

    # against the brute-force model
    keys, counts = sorted_table(want)
    packed = (np.stack([pack_kmer(s) for s in keys]) if keys
              else np.zeros((0, (k + 3) // 4), np.uint8))
    assert np.array_equal(got.table.packed, packed), f"seed {seed} (k={k})"
    assert np.array_equal(got.table.counts, np.array(counts, np.uint16))
    total = int(got.hist.total_instances()) if want else 0
    assert total == sum(want.values())
    refs = profiles_of(reads, k, want, hc=hc)
    assert len(got.profiles) == len(refs)
    for i, ref in enumerate(refs):
        assert np.array_equal(np.asarray(got.profiles[i]), ref), \
            f"seed {seed} read {i} (k={k})"

    # against the JAX package
    jax = jax_count_reads(raw, k, table_min=1, profiles=True, hc=hc, **kw)
    fields = ("kmer", "low", "high", "ilowcnt", "ihighcnt")
    assert [getattr(got.hist, f) for f in fields] == [
        getattr(jax.hist, f) for f in fields]
    assert np.array_equal(got.hist.counts, jax.hist.counts)
    assert np.array_equal(got.table.packed, jax.table.packed)
    assert np.array_equal(got.table.counts, jax.table.counts)
    assert len(got.profiles) == len(jax.profiles)
    assert all(np.array_equal(a, b)
               for a, b in zip(got.profiles, jax.profiles))


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_pipeline(seed):
    rng = np.random.default_rng(1000 + seed)
    k, reads = _random_case(rng)
    _check(reads, k, seed, batch_bases=int(rng.integers(64, 4000)))


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_homopolymer(seed):
    rng = np.random.default_rng(2000 + seed)
    k, reads = _random_case(rng)
    _check(reads, min(k, 21), seed, hc=True)
