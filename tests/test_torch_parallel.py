"""The port's multi-device counting (fastk_tpu_torch.parallel.dist and
.host) against the JAX package's on the CPU.

The JAX references run in this process on conftest's 8-device virtual CPU
mesh; the port runs worlds of 2 and 4 gloo processes
(tests/torch_dist_worker.py) and a world of one in this process. Results
are compared exactly: words, counts, histogram, overflow and pos_counts.
"""

import numpy as np
import pytest
import torch

from fastk_tpu.parallel import dist as jdist
from fastk_tpu.parallel import host as jhost
from fastk_tpu.parallel.multihost import shard_files as jax_shard_files
from fastk_tpu_torch.convert import device_codes, words_to_numpy
from fastk_tpu_torch.ops.count import count_batch, positions_inverse
from fastk_tpu_torch.ops.kmers import canonical_kmers, nwords, pad_needed
from fastk_tpu_torch.parallel import dist as tdist
from fastk_tpu_torch.parallel import host as thost

import torch_dist_worker as tw

KS = [17, 40, 65, 160]
CPU = torch.device("cpu")


def _stream(seed=0, n=20000):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[::997] = 4
    # repeats, so that counts above 1 occur
    codes[n // 2: n // 2 + 3000] = codes[:3000]
    return codes


def _skewed():
    """A uniform training stream, then a stream whose k-mers crowd the low
    keyspace (mostly A/C), as tests/test_parallel.py's rebalance case."""
    rng = np.random.default_rng(11)
    train = rng.integers(0, 4, 4096).astype(np.uint8)
    skew = rng.choice(np.array([0, 1], np.uint8), 16384, p=[0.8, 0.2])
    return train, np.concatenate([skew, np.full(64, 4, np.uint8)])


CODES = _stream()


def _mesh_of(size):
    """A mesh object of `size` chips in this process, for the helpers that
    read only its size and device (no collective runs)."""
    m = tdist.Mesh(CPU)
    m.size = size
    return m


@pytest.fixture(scope="module")
def jax_refs():
    mesh = jdist.make_mesh(8)
    refs = {(k, wp): jhost.sharded_count(CODES, k, mesh, want_positions=wp)
            for k in KS for wp in (False, True)}
    train, skew = _skewed()
    refs["skew"] = jhost.sharded_count(skew, 24, jdist.make_mesh(1))
    return refs


@pytest.fixture(scope="module")
def port_worlds(tmp_path_factory):
    train, skew = _skewed()
    args = dict(codes=CODES.tolist(), ks=KS, train=train.tolist(),
                skew=skew.tolist())
    out = {1: [tw.TASKS["sharded_count"](args)]}
    for world in (2, 4):
        out[world] = tw.run_world("sharded_count", world,
                                  tmp_path_factory.mktemp(f"sc{world}"), args)
    return out


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("want_positions", [False, True])
def test_sharded_count_matches_jax(jax_refs, port_worlds, world, k,
                                   want_positions):
    want = jax_refs[k, want_positions]
    for rank, res in enumerate(port_worlds[world]):
        w, c, h, o, pc = res[k, want_positions]
        assert np.array_equal(w, want[0]), rank
        assert np.array_equal(c, want[1])
        assert np.array_equal(h, want[2])
        assert o == want[3]
        if want_positions:
            assert np.array_equal(pc, want[4])
        else:
            assert pc is None


@pytest.mark.parametrize("k", KS)
def test_sharded_count_equals_count_batch(port_worlds, k):
    """The sharded result at every world equals the port's single-card
    count_batch on the same stream."""
    size = 1 << 15
    buf = np.full(size + pad_needed(k), 4, np.uint8)
    buf[: len(CODES)] = CODES
    res = count_batch(device_codes(buf, CPU), k, size, True, True)
    ns = int(res["nseg"])
    v = res["seg_valid"][:ns]
    words = np.stack(words_to_numpy(w[:ns][v] for w in res["seg_words"]),
                     axis=1)
    for world in (1, 2, 4):
        w, c, h, o, pc = port_worlds[world][0][k, True]
        assert np.array_equal(w, words)
        assert np.array_equal(c, res["seg_counts"][:ns][v].numpy())
        assert np.array_equal(h, res["hist"].numpy())
        assert o == int(res["overflow"])
        assert np.array_equal(pc, res["pos_counts"][: len(CODES)].numpy())


@pytest.mark.parametrize("world", [2, 4])
def test_route_overflow_auto_rebalance(jax_refs, port_worlds, world):
    """A composition shift between the training sample and the stream
    overflows the routing at slack 1.05; without the ladder it raises, with
    it the splitters retrain and the result equals JAX's."""
    res = port_worlds[world][0]
    assert "bucket capacity exceeded" in res["no_rebalance"]
    assert res["retrained"]
    want = jax_refs["skew"]
    got = res["rebalanced"]
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)
    assert got[3] == want[3]


@pytest.mark.parametrize("ndev", [2, 3, 4, 8])
def test_splitter_helpers_match_jax(ndev):
    assert np.array_equal(tdist.default_splitters(ndev),
                          jdist.default_splitters(ndev))
    rng = np.random.default_rng(ndev)
    ph = rng.integers(0, 50, 1 << 10)
    ph[:100] = 0
    assert np.array_equal(tdist.splitters_from_prefix_hist(ph, ndev),
                          jdist.splitters_from_prefix_hist(ph, ndev))


@pytest.mark.parametrize("k", [17, 40])
@pytest.mark.parametrize("bits", [8, 10])
def test_prefix_histogram_matches_jax(k, bits):
    size = 1 << 15
    buf = np.full(size + pad_needed(k), 4, np.uint8)
    buf[: len(CODES)] = CODES
    got = tdist.prefix_histogram(device_codes(buf, CPU), k, size, bits)
    want = np.asarray(jdist.prefix_histogram(buf, k, size, bits))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("ndev", [4, 8])
def test_train_splitters_matches_jax(exact, ndev):
    got = thost.train_splitters(CODES, 40, _mesh_of(ndev), exact=exact)
    want = jhost.train_splitters(CODES, 40, jdist.make_mesh(ndev),
                                 exact=exact)
    assert np.array_equal(got, want)


def _blocks(send_words, send_valid, extra=()):
    """Each destination's used slots as a sorted set of rows."""
    lanes = [np.asarray(x).astype(np.int64) for x in
             (*send_words, *extra, send_valid)]
    out = []
    for d in range(lanes[0].shape[0]):
        used = lanes[-1][d] > 0
        rows = np.stack([ln[d][used] for ln in lanes], axis=1)
        out.append(rows[np.lexsort(rows.T[::-1])])
    return out


@pytest.mark.parametrize("k", [17, 40])
@pytest.mark.parametrize("slack", [1.6, 0.4])
def test_route_chip_matches_jax_scatter(k, slack):
    """_route_chip at D = 4 in one process: each destination block holds
    the same records (key words, source position, validity) as JAX's
    scatter route, and the overflow agrees. Within a block the port keeps
    position order and JAX's unstable sort does not, so blocks compare as
    sorted rows. When a block overflows, which records it keeps follows
    that order, so only its fill and the overflow compare."""
    import jax.numpy as jnp

    from fastk_tpu.ops.kmers import canonical_kmers as jkmers

    D, size = 4, 1 << 15
    cap = int(size // D * slack)
    buf = np.full(size + pad_needed(k), 4, np.uint8)
    buf[: len(CODES)] = CODES
    spl = jhost.train_splitters(CODES, k, jdist.make_mesh(D))
    jw, jinv = jkmers(jnp.asarray(buf), k, size)
    want = jdist._route_chip(jw, jinv, jnp.arange(size, dtype=jnp.uint32),
                             jnp.asarray(spl), D, cap, size, impl="scatter",
                             carry_pos=True)
    words, invalid = canonical_kmers(device_codes(buf, CPU), k, size)
    for impl in ("scatter", "merge"):
        got = tdist._route_chip(
            words, invalid, torch.arange(size, dtype=torch.int32),
            torch.from_numpy(spl.astype(np.int64)), D, cap, size,
            impl=impl, carry_pos=True)
        assert int(got[2]) == int(want[2])
        gb = _blocks(got[0], got[1], (got[5],))
        wb = _blocks(want[0], want[1], (want[5],))
        for a, b in zip(gb, wb):
            if int(want[2]):
                assert a.shape == b.shape
            else:
                assert np.array_equal(a, b)


def test_slot_counts_and_received_counts_invert_the_route():
    """The D > 1 device steps in one process: route four shards, exchange
    by the block transpose that all_to_all computes, count, send the counts
    back and undo the routing — equal to count_batch on the whole stream."""
    k, D, shard = 40, 4, 1 << 13
    size = D * shard
    buf = np.full(size + pad_needed(k), 4, np.uint8)
    buf[: len(CODES)] = CODES
    whole = count_batch(device_codes(buf, CPU), k, size, True, True)
    spl = torch.from_numpy(
        thost.train_splitters(CODES, k, _mesh_of(D)).astype(np.int64))
    cap = int(shard // D * 1.8)
    sends, routes = [], []
    for d in range(D):
        row = device_codes(buf[d * shard: (d + 1) * shard + pad_needed(k)],
                               CPU)
        words, invalid = canonical_kmers(row, k, shard)
        r = tdist._route_chip(words, invalid,
                              torch.arange(shard, dtype=torch.int32), spl, D,
                              cap, shard)
        assert int(r[2]) == 0
        sends.append(torch.stack([*r[0], r[1]], dim=2))
        routes.append(r)
    recv = torch.stack(sends).transpose(0, 1)  # [dest, source, cap, lanes]
    W = nwords(k)
    counts, hist = [], 0
    back = []
    for c in range(D):
        lanes = recv[c].reshape(D * cap, -1)
        res = tdist._count_received(tuple(lanes[:, j] for j in range(W)),
                                    lanes[:, W], D * cap, True)
        ns = int(res["nseg"])
        v = res["seg_valid"][:ns]
        counts.append(res["seg_counts"][:ns][v])
        hist = hist + res["hist"]
        back.append(res["rec_counts"].view(D, cap))
    got_back = torch.stack(back).transpose(0, 1)  # [source, dest, cap]
    pos = []
    for d, r in enumerate(routes):
        got = tdist._slot_counts_to_routed(got_back[d].reshape(-1),
                                           r[1].reshape(-1), shard)
        pos.append(positions_inverse(r[3], got))
    ns = int(whole["nseg"])
    v = whole["seg_valid"][:ns]
    assert torch.equal(torch.cat(counts), whole["seg_counts"][:ns][v])
    assert torch.equal(hist, whole["hist"])
    assert torch.equal(torch.cat(pos).to(torch.int16), whole["pos_counts"])


def test_pad_shards_matches_jax():
    got = tdist.pad_shards(CODES, 40, _mesh_of(4), 6000)
    want = jdist.pad_shards(CODES, 40, jdist.make_mesh(4), 6000)
    assert np.array_equal(got, want)


def test_make_mesh_outside_a_world():
    m = tdist.make_mesh(device="cpu")
    assert (m.size, m.rank, m.group) == (1, 0, None)
    with pytest.raises(ValueError, match="world of 4 processes"):
        tdist.make_mesh(4, device="cpu")


@pytest.fixture(scope="module")
def fuzz_cases(tmp_path_factory):
    """tests/test_fuzz.py's seeded random cases (random k, read shapes, N
    placement, mixed case, duplicates), each written as two files so that
    both ranks of a world of 2 read some."""
    from test_fuzz import _random_case

    d = tmp_path_factory.mktemp("fuzz3")
    cases = []
    for seed in range(3):
        rng = np.random.default_rng(3000 + seed)
        k, reads = _random_case(rng)
        half = (len(reads) + 1) // 2
        paths = []
        for j, part in enumerate((reads[:half], reads[half:])):
            p = str(d / f"s{seed}_{j}.fasta")
            with open(p, "w") as f:
                for i, r in enumerate(part):
                    f.write(f">r{i}\n{r}\n")
            paths.append(p)
        cases.append(dict(paths=paths, k=k, bb=int(rng.integers(200, 3000)),
                          parts=int(rng.integers(2, 5))))
    res = tw.run_world("three_pipelines", 2, d, dict(cases=cases))
    return cases, res, str(d)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_three_pipelines_agree(fuzz_cases, seed):
    """in core == out of core == multi-device (count_files_sharded at a
    world of 2) in the port, and all equal JAX's count_files."""
    from fastk_tpu.pipeline.count import count_files as jax_count_files
    from fastk_tpu_torch.pipeline.count import count_files
    from fastk_tpu_torch.pipeline.outofcore import count_files_ooc

    cases, res, d = fuzz_cases
    c = cases[seed]
    order = [p for r in range(2) for p in jax_shard_files(c["paths"], r, 2)]
    want = jax_count_files(order, c["k"], table_min=1, batch_bases=c["bb"])
    a = count_files(order, c["k"], table_min=1, batch_bases=c["bb"],
                    device="cpu")
    b = count_files_ooc(order, c["k"], parts=c["parts"], sort_path=d,
                        table_min=1, batch_bases=c["bb"], device="cpu")
    ranks = [r[seed] for r in res]
    packed = np.concatenate([r["table"][0] for r in ranks])
    counts = np.concatenate([r["table"][1] for r in ranks])
    hists = [out.hist for out in (a, b)] + [r["hist"] for r in ranks]
    for h in hists:
        assert (h.kmer, h.counts.tolist(), h.ilowcnt, h.ihighcnt) == (
            want.hist.kmer, want.hist.counts.tolist(), want.hist.ilowcnt,
            want.hist.ihighcnt)
    for p, n in ((a.table.packed, a.table.counts),
                 (b.table.packed, b.table.counts), (packed, counts)):
        assert np.array_equal(p, want.table.packed)
        assert np.array_equal(n, want.table.counts)
