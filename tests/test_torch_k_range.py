"""The port's single-card path across the k range the CLI accepts (k up
to 256): count_reads (the histogram job, -t1 and -t1 -p) at k = 65, 128,
129, 160 and 256, and canonical_kmers at k = 128-256, against the JAX
package's; count_reads at k = 5-256 against the brute-force model
(tests/util_bruteforce.py) and the JAX package, as tests/test_k_range.py
holds the JAX package; and the CLI at k = 135. The multi-device path
builds its keys with the same code."""

import numpy as np
import pytest
import torch

from fastk_tpu.ops.kmers import canonical_kmers as jax_kmers
from fastk_tpu.pipeline.count import count_reads as jax_count_reads
from fastk_tpu_torch.convert import device_codes, words_to_numpy
from fastk_tpu_torch.formats.hist import HIST_HIGH
from fastk_tpu_torch.ops.kmers import canonical_kmers, pad_needed
from fastk_tpu_torch.pipeline.count import count_reads

import gen_data
from test_k_range import _reads
from util_bruteforce import count_kmers


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
    words, invalid = canonical_kmers(device_codes(codes, torch.device(
        "cpu")), k, size)
    jw, jinv = jax_kmers(codes, k, size)
    assert np.array_equal(invalid.numpy(), np.asarray(jinv) != 0)
    for a, b in zip(words_to_numpy(words), jw):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("k", [5, 16, 17, 31, 32, 33, 63, 64, 65, 128, 129,
                               160, 256])
def test_counts_match_bruteforce(k):
    """tests/test_k_range.py's case through the port: the histogram, the
    table's size and spot checks of find and fetch_count against the
    brute-force model, and the histogram and table against the JAX
    package."""
    reads = _reads(k, length=max(200, k + 60))
    out = count_reads(reads, k, table_min=1, device="cpu")
    want = count_kmers([r.decode() for r in reads], k)
    counts = np.array(sorted(want.values()), dtype=np.int64)
    bins = np.bincount(np.clip(counts, 0, HIST_HIGH),
                       minlength=HIST_HIGH + 1)[1:]
    assert np.array_equal(np.asarray(out.hist.as_unique().counts), bins)
    assert len(out.table) == len(want)
    items = sorted(want.items())
    for i in [0, len(items) // 2, len(items) - 1]:
        km, c = items[i]
        j = out.table.find(km)
        assert j is not None
        assert out.table.fetch_count(j) == min(c, HIST_HIGH)
    jax = jax_count_reads(reads, k, table_min=1)
    assert np.array_equal(out.hist.counts, jax.hist.counts)
    assert np.array_equal(out.table.packed, jax.table.packed)
    assert np.array_equal(out.table.counts, jax.table.counts)


def test_cli_k_beyond_reference(tmp_path):
    """The port's CLI at k=135 (-t1 -p): its outputs load through the
    port's readers and its tabex, and agree with the brute-force model."""
    from fastk_tpu_torch.formats.hist import read_histogram
    from fastk_tpu_torch.formats.ktab import read_ktab
    from fastk_tpu_torch.formats.prof import read_profiles
    from fastk_tpu_torch.tools import fastk, tabex

    reads = [r.decode() for r in _reads(7, n=20, length=300)]
    src = str(tmp_path / "in.fasta")
    with open(src, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    base = str(tmp_path / "out")
    assert fastk.main(["-k135", "-t1", "-p", f"-P{tmp_path}", src,
                       f"-N{base}"], device="cpu") == 0

    want = count_kmers(reads, 135)
    h = read_histogram(base)
    assert int(np.asarray(h.as_unique().counts).sum()) == len(want)
    t = read_ktab(base)
    assert t.kmer == 135 and len(t.counts) == len(want)
    assert int(t.counts.astype(np.int64).sum()) == sum(want.values())
    profs = read_profiles(base)
    assert len(profs) == len(reads)
    for r, p in zip(reads, profs):
        assert len(p) == len(r) - 135 + 1
    assert tabex.main(["-t1", base + ".ktab", "0-3"]) == 0
