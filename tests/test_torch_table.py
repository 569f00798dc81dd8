"""The port's -t table against fastk_tpu (exact): host key packing,
compact_table_min, and the .hist/.ktab/.prof outputs of the pipeline
against the oracle goldens and against fastk_tpu's own pipeline."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fastk_tpu.ops.count as jcount
import fastk_tpu.ops.kmers as jkmers
from fastk_tpu.formats import ktab as K
from fastk_tpu.formats import prof as P
from fastk_tpu.formats.hist import write_histogram
from fastk_tpu.pipeline.count import count_files as jax_count_files
from fastk_tpu_torch.convert import words_from_numpy, words_to_numpy
from fastk_tpu_torch.ops import count as tcount
from fastk_tpu_torch.ops import kmers as tkmers
from fastk_tpu_torch.pipeline.count import count_files

import gen_data
from test_torch_count import KS, SIZE, _codes

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
INPUTS = os.path.join(GOLDEN, "inputs")

# the rows of tests/test_pipeline.py CASES:
# (golden dir, input, k, table_min, hc, has profiles)
CASES = [
    ("tiny_k12_t1", "tiny.fasta", 12, 1, False, True),
    ("small_k40", "small.fasta", 40, 1, False, True),
    ("small_k40_t3", "small.fasta", 40, 3, False, False),
    ("smallq_k32", "smallq.fastq", 32, 1, False, True),
    ("small_k40_c", "small.fasta", 40, 1, True, True),
]


def file_set(d) -> dict:
    """{file name: bytes} of every file in directory d, hidden parts
    included."""
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("k", KS)
def test_words_packed_round_trip_matches_jax(k):
    rng = np.random.default_rng(k)
    W = tkmers.nwords(k)
    words = rng.integers(0, 1 << 32, (300, W), dtype=np.uint64).astype(
        np.uint32)
    L = k - 16 * (W - 1)
    words[:, -1] &= np.uint32(((1 << (2 * L)) - 1) << (32 - 2 * L))
    packed = tkmers.words_to_packed(words, k)
    assert np.array_equal(packed, jkmers.words_to_packed(words, k))
    assert packed.shape == (300, (k + 3) // 4)
    back = tkmers.packed_to_words(packed, k)
    assert np.array_equal(back, words)
    assert np.array_equal(back, jkmers.packed_to_words(packed, k))
    empty = tkmers.words_to_packed(words[:0], k)
    assert empty.shape == (0, (k + 3) // 4)
    assert tkmers.packed_to_words(empty, k).shape == (0, W)


@pytest.mark.parametrize("tmin", [1, 2, 3])
@pytest.mark.parametrize("k", KS)
def test_compact_table_min_matches_jax(k, tmin):
    u = jcount.unique_batch(jnp.asarray(_codes(k, 5)), k, SIZE)
    words = tuple(np.asarray(w) for w in u["seg_words"])
    counts = np.asarray(u["seg_counts"]).copy()
    counts[3] = 40000  # clipped at 32767 on the way
    want = jcount.compact_table_min(tuple(jnp.asarray(w) for w in words),
                                    jnp.asarray(counts), tmin)
    got = tcount.compact_table_min(words_from_numpy(words, "cpu"),
                                   torch.from_numpy(counts), tmin)
    n = int(want["nkeep"])
    assert int(got["nkeep"]) == n
    assert 0 < n < int(u["nuniq"]) or tmin == 1
    for g, w in zip(words_to_numpy(got["words"]), want["words"]):
        assert np.array_equal(g[:n], np.asarray(w)[:n])
    assert np.array_equal(got["counts"][:n].numpy(),
                          np.asarray(want["counts"])[:n].astype(np.int32))
    assert int(got["counts"].max()) == 32767


@pytest.mark.parametrize("batch_bases", [64 << 20, 30_000])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pipeline_matches_golden(tmp_path, case, batch_bases):
    d, inp, k, tmin, hc, has_prof = case
    stem = inp.split(".")[0]
    base = os.path.join(GOLDEN, d, stem)
    nparts = K._read_stub(base)[1]
    out = count_files([os.path.join(INPUTS, inp)], k, table_min=tmin,
                      profiles=has_prof, hc=hc, batch_bases=batch_bases,
                      out_base=str(tmp_path / stem), out_nparts=nparts,
                      device="cpu")
    assert out.table is None and out.profiles is None
    write_histogram(str(tmp_path / stem), out.hist)
    got, want = file_set(tmp_path), file_set(os.path.join(GOLDEN, d))
    # the oracle cuts .ktab parts its own way (fastk_tpu's differ too), so
    # the parts are held to the oracle's entry stream and the stub's bytes
    for name in (f"{stem}.hist", f"{stem}.ktab"):
        assert got[name] == want[name], name
    mine, ref = K.read_ktab(str(tmp_path / stem)), K.read_ktab(base)
    assert np.array_equal(mine.packed, ref.packed)
    assert np.array_equal(mine.counts, ref.counts)
    assert out.table_entries == len(ref)
    if has_prof:
        mine, ref = P.ProfileIndex(str(tmp_path / stem)), P.ProfileIndex(base)
        assert mine.nreads == ref.nreads
        for i in range(ref.nreads):
            assert np.array_equal(mine.fetch(i), ref.fetch(i)), f"read {i}"


@pytest.fixture(scope="module")
def multi_input(tmp_path_factory):
    """Shotgun reads with N runs, mixed case and errors (tests/gen_data)."""
    rng = np.random.default_rng(12)
    genome = gen_data.make_genome(rng, 6000)
    reads = gen_data.sample_reads(rng, genome, 8, 300, n_rate=0.2,
                                  upper_rate=0.3, err_rate=0.01)
    reads += [b"acg", b"ttttttttttttttttttttttttttttttttttttttttttttt"]
    path = str(tmp_path_factory.mktemp("table") / "multi.fasta")
    gen_data.write_fasta(path, reads)
    return path


@pytest.mark.parametrize("tmin", [1, 3])
@pytest.mark.parametrize("k", [17, 40])
def test_multi_batch_table_matches_jax(tmp_path, multi_input, k, tmin):
    """-t without -p, in several batches: .hist and .ktab file-sets
    byte-identical to fastk_tpu's, and the in-memory table equal."""
    for name, fn, kw in (("jax", jax_count_files, {}),
                         ("port", count_files, dict(device="cpu"))):
        os.mkdir(tmp_path / name)
        out = fn([multi_input], k, table_min=tmin, batch_bases=15_000,
                 out_base=str(tmp_path / name / "m"), out_nparts=3, **kw)
        write_histogram(str(tmp_path / name / "m"), out.hist)
    assert file_set(tmp_path / "port") == file_set(tmp_path / "jax")
    got = count_files([multi_input], k, table_min=tmin, batch_bases=15_000,
                      device="cpu")
    want = K.read_ktab(str(tmp_path / "jax" / "m"))
    assert got.table_entries == len(want) > 0
    assert np.array_equal(got.table.packed, want.packed)
    assert np.array_equal(got.table.counts, want.counts)
    assert got.table.minval == tmin
