"""The port's scale-out mesh path (fastk_tpu_torch.parallel.meshooc) in
worlds of 2 and 4 gloo processes against the JAX package's count_files_mesh
(8 virtual chips, in this process) and its single-chip paths over the same
global read order: histograms, decoded tables and profiles, exactly. The
scenarios mirror tests/test_meshooc.py; kill and resume, and the watchdog,
run worlds of their own.
"""

import glob
import os
import time

import numpy as np
import pytest

from fastk_tpu.parallel.meshooc import count_files_mesh as jax_mesh
from fastk_tpu.parallel.multihost import shard_files
from fastk_tpu.pipeline.count import count_files as jax_count_files
from fastk_tpu.pipeline.outofcore import count_files_ooc as jax_ooc
from fastk_tpu_torch.formats.ktab import read_ktab
from fastk_tpu_torch.formats.prof import read_profiles
from fastk_tpu_torch.tools.fastcat import (
    cat_profiles_spliced,
    cat_tables_spliced,
    cat_tables_streamed,
)

import torch_dist_worker as tw


def _write_fasta(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    return str(path)


def _rand_reads(rng, genome, n, L, nfrac=0.0):
    out = []
    for _ in range(n):
        s = int(rng.integers(0, len(genome) - L))
        r = genome[s: s + L].copy()
        if nfrac and rng.random() < nfrac:
            j = int(rng.integers(0, L - 3))
            r[j: j + 3] = 99
        out.append("".join("acgt"[c] if c < 4 else "n" for c in r))
    return out


def _h(h):
    return (h.kmer, h.low, h.high, h.counts.tolist(), h.ilowcnt,
            h.ihighcnt)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshin")
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=3000)
    data = [_write_fasta(d / f"f{i}.fasta",
                         _rand_reads(rng, genome, 40, 100, nfrac=0.15))
            for i in range(2)]
    rng = np.random.default_rng(3)
    disjoint = []
    for part in range(2):
        reads = []
        for _ in range(3):  # a fresh genome a batch's worth of reads
            g = rng.integers(0, 4, size=4000)
            reads += _rand_reads(rng, g, 25, 120)
        disjoint.append(_write_fasta(d / f"dj{part}.fasta", reads))
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, size=3000)
    skew = _write_fasta(d / "skew.fasta",
                        _rand_reads(rng, g, 30, 100) + ["a" * 100] * 600)
    one = _write_fasta(d / "one.fasta", ["a" * 200] * 300)
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, size=2000)
    iskew = _write_fasta(d / "iskew.fasta",
                         _rand_reads(rng, g, 20, 100) + ["a" * 100] * 400)
    return dict(data=data, disjoint=disjoint, skew=skew, one=one,
                iskew=iskew, dir=str(d))


SCENARIOS_2 = {
    "multibatch": lambda i: dict(paths=i["data"], k=17, table_min=1,
                                 profiles=True, batch_bases=2000,
                                 parts_per_chip=2),
    "k40": lambda i: dict(paths=i["data"], k=40, table_min=1, profiles=True,
                          batch_bases=5000, parts_per_chip=2, stream=True,
                          out_nparts=3),
    "disjoint": lambda i: dict(paths=i["disjoint"], k=40, table_min=1,
                               batch_bases=3000),
    "hcbc": lambda i: dict(paths=i["data"], k=17, table_min=1,
                           profiles=True, batch_bases=4000, hc=True, bc=2),
    # a round's device work in sub-slices of 2^11 positions a rank (its
    # shard is 2^14)
    "sliced": lambda i: dict(paths=i["data"], k=40, table_min=1,
                             profiles=True, batch_bases=20000,
                             slice_positions=1 << 11),
    # phase 3's rows in rounds of max(256, 2^9 // 2) = 256 rows a peer:
    # ~1100 rows a peer in each rank's batch (F7)
    "rounds": lambda i: dict(paths=i["data"], k=17, table_min=1,
                             profiles=True, batch_bases=5000,
                             slice_positions=1 << 9, stream=True,
                             out_nparts=2),
}
SCENARIOS_4 = {
    "skew": lambda i: dict(paths=[i["skew"]], k=17, table_min=1,
                           profiles=True, batch_bases=60000),
    "one": lambda i: dict(paths=[i["one"]], k=17, table_min=1,
                          batch_bases=30000,
                          env={"FASTK_TPU_ROUTE_BUDGET_MB": "0"}),
    "iskew": lambda i: dict(paths=[i["iskew"]], k=17, table_min=1,
                            profiles=True, batch_bases=60000,
                            env={"FASTK_TPU_ROUTE_BUDGET_MB": "1"}),
}


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    out = {}
    for world, scen in ((2, SCENARIOS_2), (4, SCENARIOS_4)):
        args = dict(scenarios={n: f(inputs) for n, f in scen.items()})
        res = tw.run_world("mesh", world, tmp_path_factory.mktemp(
            f"mesh{world}"), args)
        for name in scen:
            out[name] = (world, [r[name] for r in res])
    return out


def _jax_refs(sc, world, tmp):
    """(JAX count_files_mesh, JAX single-chip) on the port's global read
    order: rank 0's file shard, then rank 1's, ..."""
    kw = {k: v for k, v in sc.items()
          if k not in ("paths", "k", "stream", "out_nparts", "env",
                       "parts_per_chip", "slice_positions")}
    order = [p for r in range(world) for p in shard_files(sc["paths"], r,
                                                          world)]
    old = {k: os.environ.get(k) for k in sc.get("env", {})}
    os.environ.update(sc.get("env", {}))
    try:
        mesh = jax_mesh(order, sc["k"], sort_path=str(tmp), **kw,
                        parts_per_chip=sc.get("parts_per_chip", 1))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    single = jax_count_files(order, sc["k"], **kw)
    return mesh, single


def _concat(ranks):
    """The ranks' table slices and profile lists, in rank order."""
    packed = np.concatenate([r["table"][0] for r in ranks])
    counts = np.concatenate([r["table"][1] for r in ranks])
    profs = (None if ranks[0]["profiles"] is None
             else [p for r in ranks for p in r["profiles"]])
    return packed, counts, profs


@pytest.mark.parametrize("name", ["multibatch", "disjoint", "hcbc", "sliced",
                                  "skew", "one", "iskew"])
def test_mesh_world_matches_jax(inputs, worlds, name, tmp_path):
    world, ranks = worlds[name]
    sc = {**SCENARIOS_2, **SCENARIOS_4}[name](inputs)
    jm, js = _jax_refs(sc, world, tmp_path)
    packed, counts, profs = _concat(ranks)
    for r in ranks:
        assert _h(r["hist"]) == _h(jm.hist) == _h(js.hist)
        assert (r["nreads"], r["totlen"]) == (js.nreads, js.totlen)
        assert r["spill_left"] == []
    for want in (jm, js):
        assert np.array_equal(packed, want.table.packed)
        assert np.array_equal(counts, want.table.counts)
        if sc.get("profiles"):
            assert len(profs) == len(want.profiles)
            assert all(np.array_equal(a, b)
                       for a, b in zip(profs, want.profiles))
    st = [r["stats"] for r in ranks]
    if name == "multibatch":
        assert all(s["max_round_records"] < s["total_spilled"] for s in st)
    if name == "disjoint":
        # ~3 rounds of disjoint keys a rank: a round holds under half
        assert all(s["max_round_records"] * 2 < s["total_spilled"]
                   for s in st)
    if name == "skew":
        assert st[0]["slack_escalations"] >= 1
    if name == "one":
        assert st[0]["pre_dedup"] == 1 and st[0]["batch_splits"] == 0
    if name == "iskew":
        assert st[0]["batch_splits"] >= 1
    assert all(len(s["phase_s"]) == 3 and min(s["phase_s"]) >= 0
               for s in st)


def test_mesh_streamed_k40_splices_to_ooc(inputs, worlds, tmp_path):
    """-k40 -t1 -p streamed in slice file-sets at world 2, spliced by the
    port's fastcat: equal to JAX's count_files_ooc and count_files_mesh
    over the same global read order (decoded: the splice has a part set a
    rank)."""
    world, ranks = worlds["k40"]
    sc = SCENARIOS_2["k40"](inputs)
    slices = []
    for r, res in enumerate(ranks):
        base = str(tmp_path / f"s.{r}")
        for name, blob in res["files"].items():
            with open(str(tmp_path / name.replace("X", f"s.{r}", 1)),
                      "wb") as f:
                f.write(blob)
        slices.append(base)
    tgt = str(tmp_path / "spliced")
    if not cat_tables_spliced(slices, tgt, keep=True):
        cat_tables_streamed(slices, tgt, 3)
    cat_profiles_spliced(slices, tgt, keep=True)
    order = [p for r in range(world) for p in shard_files(sc["paths"], r,
                                                          world)]
    ooc = jax_ooc(order, 40, parts=3, sort_path=str(tmp_path), table_min=1,
                  profiles=True, batch_bases=5000,
                  out_base=str(tmp_path / "ooc"), out_nparts=3)
    mesh = jax_mesh(order, 40, table_min=1, profiles=True, batch_bases=5000,
                    sort_path=str(tmp_path), parts_per_chip=2,
                    out_base=str(tmp_path / "jm"), out_nparts=3)
    got_t, got_p = read_ktab(tgt), read_profiles(tgt)
    for want in ("ooc", "jm"):
        t = read_ktab(str(tmp_path / want))
        assert np.array_equal(got_t.packed, t.packed)
        assert np.array_equal(got_t.counts, t.counts)
        p = read_profiles(str(tmp_path / want))
        assert len(p) == len(got_p)
        assert all(np.array_equal(a, b) for a, b in zip(got_p, p))
    for r in ranks:
        assert _h(r["hist"]) == _h(ooc.hist) == _h(mesh.hist)
        assert r["entries"] == ooc.table_entries == mesh.table_entries


def test_mesh_profile_exchange_in_rounds(inputs, worlds, tmp_path):
    """F7: phase 3 exchanges a batch's profile rows in rounds of at most C =
    max(256, slice_positions // D) rows a peer, so that one round holds at
    most 2 x D x C x 8 B (send and receive); the spliced .prof/.pidx equal
    the JAX package's count_files_mesh on the same global read order."""
    world, ranks = worlds["rounds"]
    sc = SCENARIOS_2["rounds"](inputs)
    C = max(256, sc["slice_positions"] // world)
    for r in ranks:
        st = r["stats"]
        assert st["profile_exchange_rounds"] >= 3
        assert 0 < st["profile_exchange_peak_bytes"] <= 2 * world * C * 8
        assert st["profile_rows_padded"] == (
            world * C * st["profile_exchange_rounds"])
    slices = []
    for rank, res in enumerate(ranks):
        for name, blob in res["files"].items():
            with open(str(tmp_path / name.replace("X", f"s.{rank}", 1)),
                      "wb") as f:
                f.write(blob)
        slices.append(str(tmp_path / f"s.{rank}"))
    tgt = str(tmp_path / "spliced")
    cat_profiles_spliced(slices, tgt, keep=True)
    jm, _js = _jax_refs(sc, world, tmp_path)
    got = read_profiles(tgt)
    assert len(got) == len(jm.profiles) > 0
    assert all(np.array_equal(a, b) for a, b in zip(got, jm.profiles))
    assert all(_h(r["hist"]) == _h(jm.hist) for r in ranks)


def test_mesh_kill_resume_two_process(inputs, tmp_path):
    """Rank 1 dies entering its second round: rank 0 ends with an error (the
    gloo peer lost, or the watchdog) instead of hanging, both ranks keep a
    resumable manifest, and a -R rerun resumes and equals the single-chip
    out-of-core run over the same global read order."""
    args = dict(paths=inputs["data"], k=17, bb=3000)
    env = {"FASTK_TPU_MESH_TIMEOUT": "20"}
    procs, _out = tw.spawn("mesh_resume", 2, tmp_path, dict(args, die_at=1),
                           env, tag="kill")
    got = tw._wait_all(procs, tw.WAIT_S)
    assert got is not None, "a rank hung after its peer died"
    rcs, errs = got
    assert rcs[1] == 9 and rcs[0] != 0, errs
    assert len(glob.glob(str(tmp_path / "fastk_tpu_mesh.*" /
                              "manifest.json"))) == 2
    res = tw.run_world("mesh_resume", 2, tmp_path, args, env, tag="resume")
    order = shard_files(inputs["data"], 0, 2) + shard_files(
        inputs["data"], 1, 2)
    want = jax_ooc(order, 17, parts=2, sort_path=str(tmp_path), table_min=1,
                   profiles=True, batch_bases=3000,
                   out_base=str(tmp_path / "ref"), out_nparts=2)
    slices = [r["slice_base"] for r in res]
    tgt = str(tmp_path / "spliced")
    if not cat_tables_spliced(slices, tgt, keep=True):
        cat_tables_streamed(slices, tgt, 2)
    cat_profiles_spliced(slices, tgt, keep=True)
    assert all(_h(r["hist"]) == _h(want.hist) for r in res)
    ta, tb = read_ktab(tgt), read_ktab(str(tmp_path / "ref"))
    assert np.array_equal(ta.packed, tb.packed)
    assert np.array_equal(ta.counts, tb.counts)
    pa, pb = read_profiles(tgt), read_profiles(str(tmp_path / "ref"))
    assert len(pa) == len(pb)
    assert all(np.array_equal(a, b) for a, b in zip(pa, pb))
    # a successful resume removes the manifests
    assert not glob.glob(str(tmp_path / "fastk_tpu_mesh.*" /
                             "manifest.json"))


def test_mesh_watchdog_ends_a_stalled_rank(inputs, tmp_path):
    """A rank that never enters the job leaves its peer blocked in a
    collective; the watchdog ends the peer with its error (exit 17) within
    FASTK_TPU_MESH_TIMEOUT, well before the world's own 60 s timeout."""
    procs, _out = tw.spawn("stall", 2, tmp_path, dict(paths=inputs["data"]),
                           {"FASTK_TPU_MESH_TIMEOUT": "4"}, tag="stall")
    t0 = time.monotonic()
    try:
        procs[0].wait(timeout=tw.WAIT_S)
        waited = time.monotonic() - t0
    finally:
        for p in procs:
            p.kill()
            p.wait()
    err = procs[0].stderr.read().decode()
    assert procs[0].returncode == 17, err
    assert "no progress in 4s" in err
    assert waited < 40


def test_relative_profiles_sharded_world(inputs, tmp_path):
    """-p:<table> across a world of 2, returned (one batch and several) and
    streamed (per-rank slices spliced by fastcat, spools removed): equal to
    JAX's relative_profiles_sharded on 8 virtual chips and to its
    single-chip relative run."""
    from fastk_tpu.formats.ktab import write_ktab
    from fastk_tpu.parallel.dist import make_mesh
    from fastk_tpu.parallel.host import relative_profiles_sharded

    base = jax_count_files([inputs["data"][0]], 17, table_min=1,
                           batch_bases=100000)
    tab = str(tmp_path / "tab")
    write_ktab(tab, base.table)
    paths = inputs["data"] + [inputs["skew"]]
    order = shard_files(paths, 0, 2) + shard_files(paths, 1, 2)
    single = jax_count_files(order, 17, profiles=True,
                             relative_table=base.table, batch_bases=3000)
    jm = relative_profiles_sharded(order, base.table, make_mesh(8),
                                   batch_bases=3000)
    assert all(np.array_equal(a, b)
               for a, b in zip(single.profiles, jm.profiles))
    res = tw.run_world("relative", 2, tmp_path,
                       dict(table=tab + ".ktab", paths=paths,
                            batch_bases=[10_000_000, 3000]))
    for bb in (10_000_000, 3000):
        profs = [p for r in res for p in r[bb][0]]
        assert len(profs) == len(single.profiles)
        assert all(np.array_equal(a, b)
                   for a, b in zip(profs, single.profiles))
        assert all(r[bb][1:] == (single.nreads, single.totlen) for r in res)
    streamed = [p for r in res for p in r["streamed"][0]]
    assert all(np.array_equal(a, b)
               for a, b in zip(streamed, single.profiles))
    assert all(not any(f.endswith(("profspool", "lenspool"))
                       for f in r["streamed"][2]) for r in res)
