"""The port's profiles (-p, -p:<table>) against fastk_tpu (exact): the scan
helpers, count_batch, unique_batch_inst, the sort-merge joins, and the
.hist/.ktab/.prof file-sets of both pipelines on the same inputs."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fastk_tpu.ops.count as jcount
import fastk_tpu.pipeline.count as jpipe
import fastk_tpu_torch.pipeline.count as tpipe
from fastk_tpu.formats import ktab as K
from fastk_tpu.formats import prof as P
from fastk_tpu.formats.hist import write_histogram
from fastk_tpu_torch.convert import (
    codes_from_numpy,
    words_from_numpy,
    words_to_numpy,
)
from fastk_tpu_torch.ops import count as tcount
from fastk_tpu_torch.ops.kmers import canonical_kmers, pad_needed

import gen_data
from test_torch_count import KS, SIZE, _codes
from test_torch_table import file_set
from util_bruteforce import count_kmers

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
INPUTS = os.path.join(GOLDEN, "inputs")


def _u16(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("size", [1, 7, 2048])
def test_scans_match_jax(size):
    rng = np.random.default_rng(size)
    markers = rng.random(size) < 0.1
    markers[-1] = True  # at least one marker, after position 0 when size > 1
    values = rng.integers(0, 1 << 20, size).astype(np.int32)
    got = tcount.fill_forward(torch.from_numpy(markers),
                              torch.from_numpy(values))
    want = jcount.fill_forward(jnp.asarray(markers), jnp.asarray(values),
                               size)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if size > 1 and not markers[0]:
        assert int(got[0]) == -1
    got = tcount.next_start_after(torch.from_numpy(markers))
    want = jcount.next_start_after(jnp.asarray(markers), size)
    assert np.array_equal(got.numpy(), np.asarray(want))
    pos = rng.permutation(size).astype(np.uint32)
    got = tcount.positions_inverse(torch.from_numpy(pos.astype(np.int32)),
                                   torch.from_numpy(values))
    want = jcount.positions_inverse(jnp.asarray(pos), jnp.asarray(values))
    assert np.array_equal(got.numpy(), np.asarray(want))


def _count_batch_matches(c: np.ndarray, k: int, size: int):
    want = jcount.count_batch(jnp.asarray(c), k, size, True, True)
    got = tcount.count_batch(codes_from_numpy(c, "cpu"), k, size, True, True)
    for key in ("nseg", "nvalid", "overflow"):
        assert int(got[key]) == int(want[key]), key
    for key in ("seg_counts", "seg_valid"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    for g, w in zip(words_to_numpy(got["seg_words"]), want["seg_words"]):
        assert np.array_equal(g, np.asarray(w))
    assert np.array_equal(got["hist"].numpy(),
                          np.asarray(want["hist"]).astype(np.int64))
    assert np.array_equal(_u16(got["pos_counts"]),
                          np.asarray(want["pos_counts"]))
    return got


@pytest.mark.parametrize("k", KS)
def test_count_batch_matches_jax(k):
    got = _count_batch_matches(_codes(k, 6), k, SIZE)
    assert int(got["pos_counts"].max()) > 1


def test_count_batch_clips_at_32767():
    """One k-mer 40000 times: the histogram's last bin, the overflow and
    the clipped per-position counts."""
    k, size = 12, 1 << 16
    c = np.full(size + pad_needed(k), 4, np.uint8)
    c[:40000] = 0
    c[40001:40500] = np.random.default_rng(0).integers(0, 4, 499)
    got = _count_batch_matches(c, k, size)
    assert int(got["overflow"]) == 40000 - k + 1 - 32767
    assert int(got["hist"][32767]) == 1
    assert int(got["pos_counts"][0]) == 32767


def _sorted_pairs(s_words, s_pos) -> np.ndarray:
    rows = np.stack([np.asarray(w).astype(np.int64) for w in s_words]
                    + [np.asarray(s_pos).astype(np.int64)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("k", KS)
def test_unique_batch_inst_matches_jax(k):
    c = _codes(k, 7)
    want = jcount.unique_batch_inst(jnp.asarray(c), k, SIZE)
    got = tcount.unique_batch_inst(codes_from_numpy(c, "cpu"), k, SIZE)
    for key in ("nseg", "nuniq", "nvalid"):
        assert int(got[key]) == int(want[key]), key
    assert np.array_equal(got["seg_counts"].numpy(),
                          np.asarray(want["seg_counts"]))
    for g, w in zip(words_to_numpy(got["seg_words"]), want["seg_words"]):
        assert np.array_equal(g, np.asarray(w))
    s_words = words_to_numpy(got["s_words"])
    for g, w in zip(s_words, want["s_words"]):
        assert np.array_equal(g, np.asarray(w))
    # equal keys may list their positions in any order: compare the pairs
    assert np.array_equal(_sorted_pairs(s_words, got["s_pos"].numpy()),
                          _sorted_pairs(want["s_words"], want["s_pos"]))
    assert got["s_pos"].dtype == torch.int32
    real = sum(t.numel() * t.element_size()
               for t in (*got["s_words"], got["s_pos"]))
    assert tpipe._inst_bytes(SIZE, k) == real


def _table_and_queries(k: int):
    """A table of the keys seen at least twice in one stream (JAX layout:
    [SIZE] slots, all-ones and 0 beyond the entries), and a query stream
    that shares its first half with that stream."""
    c = _codes(k, 8)
    u = jcount.unique_batch(jnp.asarray(c), k, SIZE)
    kept = jcount.compact_table_min(u["seg_words"], u["seg_counts"], 2)
    n = int(kept["nkeep"])
    words = tuple(np.where(np.arange(SIZE) < n, np.asarray(w), 0xFFFFFFFF
                           ).astype(np.uint32) for w in kept["words"])
    counts = np.where(np.arange(SIZE) < n, np.asarray(kept["counts"]), 0
                      ).astype(np.int32)
    q = c.copy()
    q[SIZE // 2:] = _codes(k, 9)[SIZE // 2:]
    return words, counts, q


@pytest.mark.parametrize("k", KS)
def test_profile_joins_match_jax(k):
    words, counts, q = _table_and_queries(k)
    jt = (tuple(jnp.asarray(w) for w in words), jnp.asarray(counts))
    tt = (words_from_numpy(words, "cpu"), torch.from_numpy(counts))
    want = np.asarray(jcount.profile_join(*jt, jnp.asarray(q), k, SIZE))
    got = tcount.profile_join(*tt, codes_from_numpy(q, "cpu"), k, SIZE)
    assert got.dtype == torch.int16
    assert np.array_equal(_u16(got), want)
    assert (want > 1).any() and (want == 0).any()

    ji = jcount.unique_batch_inst(jnp.asarray(q), k, SIZE)
    want_i = np.asarray(jcount.profile_join_inst(*jt, ji["s_words"],
                                                 ji["s_pos"]))
    ti = tcount.unique_batch_inst(codes_from_numpy(q, "cpu"), k, SIZE)
    got_i = tcount.profile_join_inst(*tt, ti["s_words"], ti["s_pos"])
    assert np.array_equal(_u16(got_i), want_i)
    assert np.array_equal(want_i, want)


@pytest.mark.parametrize("k", [12, 40])
def test_join_table_entry_leads_its_segment(k):
    """A key in the table and at many positions, among absent keys: every
    one of its positions gets the table's count, whatever order the sort
    gives equal keys."""
    size = 1 << 15
    rng = np.random.default_rng(k)
    c = np.full(size + pad_needed(k), 4, np.uint8)
    c[: size - 100] = rng.integers(0, 4, size - 100)
    c[1000:9000] = 0  # A^k at 8000 - k + 1 positions
    words, invalid = canonical_kmers(codes_from_numpy(c, "cpu"), k, size)
    key = tuple(w[1000: 1001] for w in words)
    table = (key, torch.tensor([7], dtype=torch.int32))
    want = np.zeros(size, np.uint16)
    want[1000: 9000 - k + 1] = 7
    assert not invalid[: size - 100 - k + 1].any()
    got = tcount.profile_join(*table, codes_from_numpy(c, "cpu"), k, size)
    assert np.array_equal(_u16(got), want)
    inst = tcount.unique_batch_inst(codes_from_numpy(c, "cpu"), k, size)
    got = tcount.profile_join_inst(*table, inst["s_words"], inst["s_pos"])
    assert np.array_equal(_u16(got), want)
    jt = (tuple(jnp.asarray(np.asarray(w).astype(np.uint32)) for w in key),
          jnp.asarray([7], dtype=jnp.int32))
    assert np.array_equal(
        np.asarray(jcount.profile_join(*jt, jnp.asarray(c), k, size)), want)


@pytest.fixture(scope="module")
def multi_input(tmp_path_factory):
    """Shotgun reads with N runs, mixed case and errors (tests/gen_data)."""
    rng = np.random.default_rng(13)
    genome = gen_data.make_genome(rng, 6000)
    reads = gen_data.sample_reads(rng, genome, 8, 300, n_rate=0.2,
                                  upper_rate=0.3, err_rate=0.01)
    reads += [b"acg", b"ttttttttttttttttttttttttttttttttttttttttttttt"]
    path = str(tmp_path_factory.mktemp("prof") / "multi.fasta")
    gen_data.write_fasta(path, reads)
    return path


def _both(tmp_path, paths, k, **kw):
    """Run fastk_tpu's and the port's count_files on the same input, each
    streaming into its own directory; returns the two file-sets and the
    port's output."""
    outs = {}
    for name, fn, extra in (("jax", jpipe.count_files, {}),
                            ("port", tpipe.count_files,
                             dict(device="cpu"))):
        os.mkdir(tmp_path / name)
        base = str(tmp_path / name / "o")
        out = fn(paths, k, out_base=base, **kw, **extra)
        if out.hist is not None:
            write_histogram(base, out.hist)
        outs[name] = out
    return file_set(tmp_path / "jax"), file_set(tmp_path / "port"), outs


SCENARIOS = {
    # name: (batch_bases, instance budget in bytes)
    "single": (64 << 20, 4 << 30),
    "multi_budget_0": (15_000, 0),
    "multi_unlimited": (15_000, 1 << 40),
}


@pytest.mark.parametrize("tmin", [None, 1, 3])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_file_sets_match_jax(tmp_path, multi_input, monkeypatch, scenario,
                             tmin):
    batch_bases, budget = SCENARIOS[scenario]
    monkeypatch.setenv("FASTK_TPU_INST_HBM", str(budget))
    jax_set, port_set, outs = _both(
        tmp_path, [multi_input], 40, table_min=tmin, profiles=True,
        batch_bases=batch_bases, out_nparts=3)
    assert port_set == jax_set
    assert any(".prof." in n for n in port_set)
    assert any(".ktab." in n for n in port_set) == (tmin is not None)
    assert outs["port"].table_entries == outs["jax"].table_entries


def test_long_read_slicing(tmp_path, monkeypatch):
    """A read far longer than the device cap is counted and joined in
    slices with a k-1 halo; both instance-budget branches."""
    for mod in (jpipe, tpipe):
        monkeypatch.setattr(mod, "MAX_DEVICE_POSITIONS", 1 << 15)
    rng = np.random.default_rng(5)
    genome = "".join("acgt"[c] for c in rng.integers(0, 4, size=40_000))
    reads = [genome + genome[:30_000]]  # 70 kb, repeats across slices
    reads += ["".join("acgt"[c] for c in rng.integers(0, 4, size=80))
              for _ in range(5)]
    path = str(tmp_path / "long.fasta")
    gen_data.write_fasta(path, [r.encode() for r in reads])
    for budget in (0, 1 << 40):
        monkeypatch.setenv("FASTK_TPU_INST_HBM", str(budget))
        d = tmp_path / f"b{budget}"
        os.mkdir(d)
        jax_set, port_set, outs = _both(d, [path], 21, table_min=1,
                                        profiles=True, out_nparts=2)
        assert port_set == jax_set
    got = tpipe.count_files([path], 21, table_min=1, profiles=True,
                            device="cpu")
    want = count_kmers(reads, 21)
    assert len(got.table) == len(want)
    prof = got.profiles[0]
    assert len(prof) == 70_000 - 20 and (prof >= 1).all()
    assert (prof[:10_000] >= 2).all()  # the repeated start


EDGE_READS = [
    b"acgtacgtacg",  # k-1 bases: no k-mer, an empty profile
    b"acgtacgtacgt",  # one k-mer
    b"NNNNNNNNNNNNNNN",  # all invalid
    b"acgtacgtacgtNacgtacgtacgt",  # an N splits the read
    b"t" * 40,  # homopolymer; its canonical k-mer is all-a
]


@pytest.mark.parametrize("batch_bases", [64 << 20, 20])
def test_edge_reads(tmp_path, batch_bases):
    k = 12
    path = str(tmp_path / "edge.fasta")
    gen_data.write_fasta(path, EDGE_READS)
    jax_set, port_set, outs = _both(tmp_path, [path], k, table_min=1,
                                    profiles=True, batch_bases=batch_bases,
                                    out_nparts=2)
    assert port_set == jax_set
    out = tpipe.count_reads(EDGE_READS, k, table_min=1, profiles=True,
                            batch_bases=batch_bases, device="cpu")
    model = count_kmers([r.decode() for r in EDGE_READS], k)
    assert out.hist.total_instances() == sum(model.values())
    assert len(out.table) == len(model)
    assert [len(p) for p in out.profiles] == [0, 1, 4, 14, 29]
    assert out.profiles[4][0] == model["a" * 12] == 29


@pytest.mark.parametrize("batch_bases", [64 << 20, 30_000])
def test_relative_profiles_match_golden(batch_bases):
    base = os.path.join(GOLDEN, "rel_smallq_vs_small", "smallq")
    table = K.read_ktab(os.path.join(GOLDEN, "small_k40", "small"))
    out = tpipe.count_files([os.path.join(INPUTS, "smallq.fastq")], 40,
                            relative_table=table, profiles=True,
                            batch_bases=batch_bases, device="cpu")
    assert out.hist is None and out.table is None
    pi = P.ProfileIndex(base)
    assert pi.nreads == len(out.profiles)
    for i in range(pi.nreads):
        assert np.array_equal(pi.fetch(i), out.profiles[i]), f"read {i}"


@pytest.mark.parametrize("batch_bases", [64 << 20, 15_000])
def test_relative_profiles_match_jax(tmp_path, multi_input, batch_bases):
    """-p:<table> against a table of the input's own k-mers at -t2: equal
    to fastk_tpu's file-set, and wherever the table holds a key, equal to
    the input's own profile."""
    own = tpipe.count_files([multi_input], 40, table_min=1, profiles=True,
                            device="cpu")
    t2 = K.KmerTable(40, 2, own.table.packed[own.table.counts >= 2],
                     own.table.counts[own.table.counts >= 2])
    jax_set, port_set, outs = _both(tmp_path, [multi_input], 40,
                                    relative_table=t2, profiles=True,
                                    batch_bases=batch_bases, out_nparts=2)
    assert port_set == jax_set
    assert not any(n.endswith((".hist", ".ktab")) for n in port_set)
    got = tpipe.count_files([multi_input], 40, relative_table=t2,
                            profiles=True, batch_bases=batch_bases,
                            device="cpu").profiles
    for rel, prof in zip(got, own.profiles):
        assert np.array_equal(rel, np.where(prof >= 2, prof, 0))
