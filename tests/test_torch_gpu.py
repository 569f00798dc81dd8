"""The port on a CUDA card: the run-length kernel against its plain
version, and the device paths (histogram, uniques, the fused count, the
table compaction, the profile joins, the merge with want_back and the
out-of-core job) on CUDA against the same calls on the CPU; the CLI's -M
bound on a one-batch -p job; sharded_count in an NCCL world of one; the
NCCL worlds of one rank a card; the entry points (entry's step,
dryrun_multichip); the probe kernels (ops/probes.py) against their plain
versions at the probes' shapes, at a large size and at the edges of their
16-byte loads (views off a 16-byte boundary, tails, uint8 bytes viewed as
bool), the carry's tiles at every block length from 1 to 2^20, the walk
with every set bit in one block's words, store mode at 2^26 values and on
views with a tail, the loop's grid at trip counts around its thread count
and at 2^31 - 1, on narrow and wide tables, and its SASS (a load a step),
and the whole of ``python -m fastk_tpu_torch.probes``; the host-memory
check (probes/rss.py) at 16 MB through the CLI out of core and through
count_files_mesh; the bench's headline step against its plain binning; each
port of the rest of benchmarks/ (probes.sizes, tail, sorts, h2d and
decomp), every case at 2^16 on the card equal to the CPU port's.

Imports no JAX, so that it runs on a machine with a card and without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Every test skips without a card.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from fastk_tpu_torch.convert import (
    device_codes,
    fence,
    fetch,
    fetch_u16,
    words_from_numpy,
    words_to_numpy,
    words_to_numpy_async,
)
from fastk_tpu_torch.ops import count, histker
from fastk_tpu_torch.ops import probes as probe_ops
from fastk_tpu_torch.ops.kmers import pad_needed
from fastk_tpu_torch.pipeline.outofcore import count_files_ooc

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def test_kernel_matches_plain(cuda_device):
    cases = chip_smoke.crafted_masks()
    cases.append(("random_2^26", *chip_smoke.random_words(1 << 26)))
    for name, words, valid_end in cases:
        t = torch.from_numpy(np.ascontiguousarray(words)).to(cuda_device)
        before = histker.run_hist.launches
        got, nvalid = histker.run_hist(t, valid_end)
        assert histker.run_hist.launches == before + 1
        want, _ = histker.run_hist_ref(t, valid_end)
        torch.cuda.synchronize()
        assert nvalid == valid_end
        assert torch.equal(got, want), name


TILE_CASES = chip_smoke.tile_masks()


@pytest.mark.parametrize("case", TILE_CASES, ids=[c[0] for c in TILE_CASES])
def test_kernel_at_tile_edges(cuda_device, case):
    """The kernel's tile edges (32768 positions a tile) against the plain
    version and a numpy count."""
    _name, words, valid_end = case
    t = torch.from_numpy(np.ascontiguousarray(words)).to(cuda_device)
    got, _ = histker.run_hist(t, valid_end)
    want, _ = histker.run_hist_ref(t, valid_end)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    bits = bits[:valid_end].astype(bool)
    if valid_end:
        bits[0] = True
    pos = np.flatnonzero(bits)
    lens = np.diff(np.append(pos, valid_end))
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), np.bincount(
        np.minimum(lens, 32767), minlength=32768))


def test_kernel_on_unaligned_view(cuda_device):
    """A view one word in is not 16-byte aligned: the kernel's scalar
    loads."""
    rng = np.random.default_rng(9)
    t = torch.from_numpy(chip_smoke.pack_mask(rng.random(1 << 20) < 0.3))
    t = t.to(cuda_device)[1:]
    assert t.data_ptr() % 16
    for valid_end in (t.numel() * 32, t.numel() * 32 - 5, 40000):
        assert torch.equal(histker.run_hist(t, valid_end)[0],
                           histker.run_hist_ref(t, valid_end)[0])


def test_kernel_rejects_cpu_only_arguments(cuda_device):
    t = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        histker.run_hist(t, 0)


def _codes(k: int, size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 5000).astype(np.uint8)
    c = np.full(size + pad_needed(k), 4, np.uint8)
    pos = 0
    while pos < size - 300:
        s = int(rng.integers(0, 4700))
        r = genome[s: s + 300]
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        c[pos: pos + 300] = r
        pos += 301
    c[rng.random(len(c)) < 0.001] = 4
    return c


@pytest.mark.parametrize("k", [17, 32, 40, 64])
def test_device_path_matches_cpu(cuda_device, k):
    size = 1 << 18
    c = _codes(k, size, k)
    cpu, gpu = torch.device("cpu"), cuda_device
    h_cpu = count.hist_batch(device_codes(c, cpu), k, size)
    before = histker.run_hist.launches
    h_gpu = count.hist_batch(device_codes(c, gpu), k, size)
    assert histker.run_hist.launches == before + 1
    assert torch.equal(h_gpu["hist"].cpu(), h_cpu["hist"])
    assert h_gpu["nvalid"] == h_cpu["nvalid"]

    u_cpu = count.unique_batch(device_codes(c, cpu), k, size)
    u_gpu = count.unique_batch(device_codes(c, gpu), k, size)
    for key in ("nseg", "nuniq", "nvalid"):
        assert int(u_gpu[key]) == int(u_cpu[key])
    assert torch.equal(u_gpu["seg_counts"].cpu(), u_cpu["seg_counts"])
    for g, w in zip(words_to_numpy(u_gpu["seg_words"]),
                    words_to_numpy(u_cpu["seg_words"])):
        assert np.array_equal(g, w)

    m_cpu = count.merge_unique_blocks(u_cpu["seg_words"], u_cpu["seg_counts"])
    m_gpu = count.merge_unique_blocks(u_gpu["seg_words"], u_gpu["seg_counts"])
    assert int(m_gpu["nuniq"]) == int(m_cpu["nuniq"])
    assert torch.equal(m_gpu["hist"].cpu(), m_cpu["hist"])


def test_convert_copies_on_card(cuda_device):
    """convert.py on CUDA: key words up through one pinned int32 copy and
    back through one narrowed copy, all-ones slots and bit 31 kept; a
    fenced side-stream fetch sees the work queued before the fence; scalar
    and count fetches."""
    rng = np.random.default_rng(3)
    host = rng.integers(0, 1 << 32, (3, 1 << 20),
                        dtype=np.uint64).astype(np.uint32)
    host[:, 7] = 0xFFFFFFFF
    host[:, 8] = 0x80000000
    words = words_from_numpy(host, cuda_device)
    assert all(w.device.type == "cuda" and w.dtype == torch.int64
               for w in words)
    assert int(words[0][7]) == 0xFFFFFFFF
    assert np.array_equal(words_to_numpy(words), host)
    assert np.array_equal(words_to_numpy(words, 100), host[:, :100])
    assert words_to_numpy(words, 0).shape == (3, 0)
    side = torch.cuda.Stream()
    x = torch.zeros(1 << 24, dtype=torch.int64, device=cuda_device)
    x += 5
    after = fence(side)
    x += 1  # queued after the fence: the side copy need not see it
    after()
    got = words_to_numpy_async((x,), 1 << 24, "t", side)()
    assert set(np.unique(got[0]).tolist()) <= {5, 6}
    torch.cuda.synchronize()
    assert int(fetch(torch.tensor(7, device=cuda_device), "t")) == 7
    c = torch.full((10,), 32767, dtype=torch.int32, device=cuda_device)
    assert fetch_u16(c).tolist() == [32767] * 10


@pytest.mark.parametrize("k", [17, 40])
def test_table_and_profile_ops_match_cpu(cuda_device, k):
    """count_batch, compact_table_min and both joins on the card equal the
    same calls on the CPU; count_batch launches run_hist once."""
    size = 1 << 18
    c = _codes(k, size, k + 1)
    res = {}
    for dev in (torch.device("cpu"), cuda_device):
        before = histker.run_hist.launches
        cb = count.count_batch(device_codes(c, dev), k, size, True, True)
        if dev.type == "cuda":
            assert histker.run_hist.launches == before + 1
        kept = count.compact_table_min(cb["seg_words"], cb["seg_counts"], 3)
        n = int(kept["nkeep"])
        t_words = tuple(w[:n] for w in kept["words"])
        t_counts = kept["counts"][:n]
        q = device_codes(c[::-1].copy(), dev)  # the reverse strand
        inst = count.unique_batch_inst(q, k, size)
        res[dev.type] = dict(
            cb=cb, n=n, t_words=words_to_numpy(t_words),
            t_counts=t_counts.cpu(),
            join=count.profile_join(t_words, t_counts, q, k, size).cpu(),
            join_inst=count.profile_join_inst(t_words, t_counts,
                                              inst["s_words"],
                                              inst["s_pos"]).cpu())
    cpu, gpu = res["cpu"], res["cuda"]
    for key in ("nseg", "nvalid", "overflow"):
        assert int(gpu["cb"][key]) == int(cpu["cb"][key]), key
    for key in ("seg_counts", "seg_valid", "hist", "pos_counts"):
        assert torch.equal(gpu["cb"][key].cpu(), cpu["cb"][key]), key
    for g, w in zip(words_to_numpy(gpu["cb"]["seg_words"]),
                    words_to_numpy(cpu["cb"]["seg_words"])):
        assert np.array_equal(g, w)
    assert gpu["n"] == cpu["n"] > 0
    for g, w in zip(gpu["t_words"], cpu["t_words"]):
        assert np.array_equal(g, w)
    assert torch.equal(gpu["t_counts"], cpu["t_counts"])
    assert torch.equal(gpu["join"], cpu["join"])
    assert torch.equal(gpu["join_inst"], cpu["join"])
    assert int((cpu["join"] > 0).sum()) > 0


@pytest.mark.parametrize("k", [17, 40])
def test_merge_want_back_matches_cpu(cuda_device, k):
    """merge_unique_blocks(want_back=True) on the card equals the CPU port:
    three batches' uniques (two of them equal) with empty slots and counts
    whose sums pass 32767."""
    size = 1 << 18
    blocks = {}
    for dev in (torch.device("cpu"), cuda_device):
        ws, cs = [], []
        for seed in (1, 1, 2):
            u = count.unique_batch(device_codes(_codes(k, size, seed),
                                                    dev), k, size)
            ws.append(u["seg_words"])
            cs.append(u["seg_counts"].clone())
            cs[-1][:100] += 20000  # twice in seed 1's blocks: past 32767
        words = tuple(torch.cat([w[j] for w in ws])
                      for j in range(len(ws[0])))
        counts = torch.cat(cs)
        blocks[dev.type] = count.merge_unique_blocks(words, counts,
                                                     want_back=True)
    cpu, gpu = blocks["cpu"], blocks["cuda"]
    assert int(gpu["nuniq"]) == int(cpu["nuniq"])
    for key in ("seg_counts", "hist", "rec_counts"):
        assert torch.equal(gpu[key].cpu(), cpu[key]), key
    for g, w in zip(words_to_numpy(gpu["seg_words"]),
                    words_to_numpy(cpu["seg_words"])):
        assert np.array_equal(g, w)
    assert int(cpu["rec_counts"].max()) == 32767


def test_ooc_with_profiles_matches_cpu(cuda_device, tmp_path):
    """A small out-of-core -t1 -p job (3 parts, several batches, a
    sub-split part) writes the same file-sets on the card as on the CPU."""
    path = str(tmp_path / "reads.fasta")
    chip_smoke.write_hifi_fasta(path, 30_000, 40, seed=3, read_len=2000)
    sets = []
    for dev in ("cpu", "cuda"):
        d = tmp_path / dev
        os.mkdir(d)
        count_files_ooc([path], 40, 3, sort_path=str(d), table_min=1,
                        profiles=True, batch_bases=20_000, part_cap=20_000,
                        out_base=str(d / "o"), out_nparts=2, device=dev)
        sets.append(chip_smoke.file_set(str(d), "o"))
    assert sets[0] == sets[1]
    assert any(".ktab" in n for n in sets[0])
    assert any(".prof" in n for n in sets[0])


def _random_table(n: int, k: int, seed: int, common=None):
    """A sorted table of about n distinct k-mers, numpy-seeded; `common`
    (packed rows) is merged in, so that two tables share keys."""
    from fastk_tpu_torch.formats.ktab import KmerTable

    rng = np.random.default_rng(seed)
    kb = (k + 3) // 4
    packed = rng.integers(0, 256, (n, kb), dtype=np.uint8)
    if k % 4:
        packed[:, -1] &= (0xFF << (2 * (4 - k % 4))) & 0xFF
    if common is not None:
        packed = np.concatenate([packed, common])
    view = np.ascontiguousarray(packed).view(f"S{kb}").ravel()
    _, idx = np.unique(view, return_index=True)
    packed = np.ascontiguousarray(packed[idx])
    counts = rng.integers(1, 3000, len(packed)).astype(np.uint16)
    return KmerTable(k, 1, packed, counts)


@pytest.mark.parametrize("k", [31, 40])
def test_library_unions_match_cpu(cuda_device, k):
    """merge_tables and logex_apply merge their union on the card from
    DEVICE_MIN_ROWS rows on: about 2^21 rows here, equal to the CPU."""
    from fastk_tpu_torch.algebra import logex_apply
    from fastk_tpu_torch.ops import tables
    from fastk_tpu_torch.tools.fastmerge import merge_tables

    shared = _random_table(1 << 18, k, 100).packed
    tabs = [_random_table(1 << 20, k, s, shared) for s in (1, 2)]
    assert sum(len(t) for t in tabs) >= 2 * tables.DEVICE_MIN_ROWS
    for spec in (None, (2, 3)):
        got = merge_tables(tabs, spec, device="cuda")
        want = merge_tables(tabs, spec, device="cpu")
        assert np.array_equal(got.packed, want.packed)
        assert np.array_equal(got.counts, want.counts)
    shapes = [("U", "A|+B"), ("I", "A&.B"), ("D", "A-B"), ("X", "A^B"),
              ("F", "(A&+B)[10-3000]{20-80}"), ("N", "#A|+#B")]
    got = logex_apply(shapes, tabs, (1, 100), device="cuda")
    want = logex_apply(shapes, tabs, (1, 100), device="cpu")
    for (n, t, h), (_, tw, hw) in zip(got, want):
        assert np.array_equal(t.packed, tw.packed), n
        assert np.array_equal(t.counts, tw.counts), n
        assert h == hw, n
    assert len(got[1][1]) == len(shared)


def test_one_batch_p_job_stays_under_M(cuda_device, tmp_path):
    """A one-batch -p input (8 Mbp, 2^23 positions) whose fused count would
    pass -M1 while the multi-batch charge at its measured ratio fits: the
    CLI runs it out of core, the card's peak stays under 1e9 B, and the
    file-sets equal the in-core run's."""
    import contextlib
    import io

    from fastk_tpu_torch.tools import fastk

    path = str(tmp_path / "reads.fasta")
    chip_smoke.write_hifi_fasta(path, 160_000, 400, seed=14)
    est = os.path.getsize(path)
    assert est * fastk.FUSED_BYTES > 1e9 > est * (
        fastk.POSITION_BYTES + 0.25 * fastk.UNIQUE_BYTES)
    for d in ("m1", "m12", "sort"):
        os.mkdir(tmp_path / d)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    with contextlib.redirect_stderr(log):
        assert fastk.main(["-k40", "-t3", "-p", "-M1", "-v",
                           f"-P{tmp_path}/sort", f"-N{tmp_path}/m1/o",
                           path]) == 0
    peak = torch.cuda.max_memory_allocated() - base
    assert "out-of-core:" in log.getvalue(), log.getvalue()
    assert peak < 1e9, peak
    assert fastk.main(["-k40", "-t3", "-p", f"-N{tmp_path}/m12/o",
                       path]) == 0
    assert (chip_smoke.file_set(str(tmp_path / "m1"), "o")
            == chip_smoke.file_set(str(tmp_path / "m12"), "o"))


def test_sharded_count_world_one_nccl(cuda_device, tmp_path):
    """sharded_count in an NCCL world of one (the driver's machine has one
    card) equals count_batch: table, histogram and pos_counts, with one
    run_hist launch."""
    import datetime

    import torch.distributed as dist

    from fastk_tpu_torch.parallel.dist import make_mesh
    from fastk_tpu_torch.parallel.host import sharded_count

    k, size = 40, 1 << 18
    c = _codes(k, size, 5)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(device="cuda")
        assert mesh.group is not None and mesh.size == 1
        before = histker.run_hist.launches
        words, counts, hist, over, pos = sharded_count(
            c[:size], k, mesh, want_positions=True)
        assert histker.run_hist.launches == before + 1
    finally:
        dist.destroy_process_group()
    cb = count.count_batch(device_codes(c, cuda_device), k, size, True,
                           True)
    ns = int(cb["nseg"])
    v = cb["seg_valid"][:ns]
    want = np.stack(words_to_numpy(w[:ns][v] for w in cb["seg_words"]),
                    axis=1)
    assert np.array_equal(words, want)
    assert np.array_equal(counts, cb["seg_counts"][:ns][v].cpu().numpy())
    assert np.array_equal(hist, cb["hist"].cpu().numpy())
    assert over == int(cb["overflow"])
    assert np.array_equal(pos, cb["pos_counts"].cpu().numpy())


def _nccl_world(n_min: int = 2) -> int:
    n = torch.cuda.device_count()
    if n < n_min:
        pytest.skip(f"needs {n_min} or more cards: NCCL refuses two ranks "
                    "on one card")
    return n


def test_nccl_world_sharded_count(cuda_device, tmp_path):
    """sharded_count in an NCCL world of one rank a card (the all_to_all
    and all_reduce on the cards) equals the same task in this process, a
    world of one on the CPU: words, counts, histogram, overflow and
    pos_counts at four k, with and without positions, and the skewed
    stream that needs the rebalance ladder."""
    import torch_dist_worker as tw

    world = _nccl_world()
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 20000).astype(np.uint8)
    codes[::997] = 4
    codes[10000:13000] = codes[:3000]
    train = rng.integers(0, 4, 4096).astype(np.uint8)
    skew = np.concatenate([rng.choice(np.array([0, 1], np.uint8), 16384,
                                      p=[0.8, 0.2]),
                           np.full(64, 4, np.uint8)])
    args = dict(codes=codes.tolist(), ks=[17, 40, 65, 160],
                train=train.tolist(), skew=skew.tolist())
    want = tw.TASKS["sharded_count"](args)
    got = tw.run_world("sharded_count", world, tmp_path,
                       dict(args, device="cuda"))
    for res in got:
        for key, w in want.items():
            if not isinstance(key, tuple):
                continue
            g = res[key]
            for a, b in zip(g[:3], w[:3]):
                assert np.array_equal(a, b), key
            assert g[3] == w[3]
            assert (g[4] is None) == (w[4] is None)
            if w[4] is not None:
                assert np.array_equal(g[4], w[4]), key
        assert "bucket capacity exceeded" in res["no_rebalance"]
        assert res["retrained"]
        for a, b in zip(res["rebalanced"][:3], want["rebalanced"][:3]):
            assert np.array_equal(a, b)


def test_nccl_world_mesh_relative_and_cli(cuda_device, tmp_path):
    """count_files_mesh (several rounds with profiles, with the phase-3 row
    exchange; the pre_dedup recovery), relative_profiles_sharded and the
    CLI's multi-process mode in an NCCL world of one rank a card, against
    the single-card port over the same global read order: histograms,
    tables and profiles equal."""
    import torch_dist_worker as tw

    from fastk_tpu_torch.formats.ktab import read_ktab, write_ktab
    from fastk_tpu_torch.formats.prof import read_profiles
    from fastk_tpu_torch.parallel.multihost import shard_files
    from fastk_tpu_torch.pipeline.count import count_files
    from fastk_tpu_torch.tools import fastk

    world = _nccl_world()
    paths = []
    for i in range(world + 1):
        p = str(tmp_path / f"r{i}.fasta")
        chip_smoke.write_hifi_fasta(p, 20_000, 10 + 3 * i, seed=20 + i,
                                    read_len=1500)
        paths.append(p)
    one = str(tmp_path / "one.fasta")
    with open(one, "w") as f:
        # one k-mer: 326 x 184 records from a shard of 2^16 overflow any
        # owner's 0.9 x 2^16 slots in a world of two or more
        for i in range(326):
            f.write(f">a{i}\n{'A' * 200}\n")
    order = [p for r in range(world) for p in shard_files(paths, r, world)]
    scen = dict(
        rounds=dict(paths=paths, k=40, table_min=1, profiles=True,
                    batch_bases=8000, parts_per_chip=2),
        one=dict(paths=[one], k=17, table_min=1, batch_bases=1 << 20,
                 env={"FASTK_TPU_ROUTE_BUDGET_MB": "0"}))
    got = tw.run_world("mesh", world, tmp_path,
                       dict(scenarios=scen, device="cuda"), tag="mesh")
    for name, sc in scen.items():
        ranks = [r[name] for r in got]
        want = count_files(order if name == "rounds" else [one], sc["k"],
                           table_min=1, profiles=sc.get("profiles", False),
                           batch_bases=sc["batch_bases"], device="cpu")
        assert np.array_equal(np.concatenate([r["table"][0] for r in ranks]),
                              want.table.packed), name
        assert np.array_equal(np.concatenate([r["table"][1] for r in ranks]),
                              want.table.counts), name
        for r in ranks:
            assert r["hist"] == want.hist, name
            assert r["spill_left"] == []
        if want.profiles is not None:
            profs = [p for r in ranks for p in r["profiles"]]
            assert len(profs) == len(want.profiles)
            assert all(np.array_equal(a, b)
                       for a, b in zip(profs, want.profiles))
    assert got[0]["one"]["stats"]["pre_dedup"] == 1

    base = count_files([paths[0]], 40, table_min=1, batch_bases=1 << 20,
                       device="cpu")
    tab = str(tmp_path / "tab")
    write_ktab(tab, base.table)
    rel = tw.run_world("relative", world, tmp_path,
                       dict(table=tab + ".ktab", paths=paths,
                            batch_bases=[1 << 20, 8000], device="cuda"),
                       tag="rel")
    want = count_files(order, 40, profiles=True, relative_table=base.table,
                       batch_bases=8000, device="cpu")
    for bb in (1 << 20, 8000):
        profs = [p for r in rel for p in r[bb][0]]
        assert len(profs) == len(want.profiles)
        assert all(np.array_equal(a, b)
                   for a, b in zip(profs, want.profiles))

    out = str(tmp_path / "cli")
    assert tw.run_cli(world, tmp_path, ["-k40", "-t1", "-p",
                                        f"-P{tmp_path}", f"-N{out}", *paths],
                      env={"FASTK_TPU_BATCH_BASES": str(1 << 20)},
                      device="cuda") == [0] * world
    ref = str(tmp_path / "ref")
    assert fastk.main(["-k40", "-t1", "-p", f"-N{ref}", *order],
                      device="cpu") == 0
    for ext in (".hist",):
        with open(out + ext, "rb") as f, open(ref + ext, "rb") as g:
            assert f.read() == g.read()
    ta, tb = read_ktab(out), read_ktab(ref)
    assert np.array_equal(ta.packed, tb.packed)
    assert np.array_equal(ta.counts, tb.counts)
    pa, pb = read_profiles(out), read_profiles(ref)
    assert len(pa) == len(pb)
    assert all(np.array_equal(a, b) for a, b in zip(pa, pb))


def test_entry_on_card(cuda_device):
    """entry()'s step on the card equals the CPU port's on the same codes,
    and launches run_hist once."""
    from fastk_tpu_torch import entry

    fn, (codes,) = entry.entry()
    assert codes.device.type == "cuda"
    cfn, (ccodes,) = entry.entry(device="cpu")
    before = histker.run_hist.launches
    got = fn(codes)
    assert histker.run_hist.launches == before + 1
    want = cfn(ccodes)
    for key in ("nseg", "nvalid", "overflow"):
        assert int(got[key]) == int(want[key]), key
    for key in ("seg_counts", "seg_valid", "hist", "pos_counts"):
        assert torch.equal(got[key].cpu(), want[key]), key
    for g, w in zip(got["seg_words"], want["seg_words"]):
        assert torch.equal(g.cpu(), w)


def test_dryrun_multichip_nccl(cuda_device):
    """dryrun_multichip over an NCCL world of one rank a card, every card
    of the machine; each rank launches run_hist."""
    from fastk_tpu_torch import entry

    world = _nccl_world()
    assert entry.dryrun_multichip(world) is None
    reports = entry.run_dryrun(world)
    assert [r["device"] for r in reports] == [f"cuda:{r}"
                                              for r in range(world)]
    assert all(r["run_hist_launches"] >= 1 for r in reports)


def _probe_cases(dev):
    """(kernel, label, args): the probes' shapes and one large size each."""
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    rng = np.random.default_rng(8)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    words = torch.randint(-(1 << 31), (1 << 31) - 1, (1 << 20,), generator=g,
                          device=dev, dtype=torch.int32)
    ones = torch.ones((8, 128), dtype=torch.int32, device=dev)
    out = []
    for nbins in (16, 4096, 32768):
        out.append(("probe_hist", f"1024 into {nbins}",
                    (t(rng.integers(0, nbins, 1024, np.int32)), nbins)))
    out += [
        ("probe_hist", "2^24 into 32768 with strays",
         (torch.randint(-5, 32800, (1 << 24,), generator=g, device=dev,
                        dtype=torch.int32), 32768)),
        ("probe_hist", "store, 16 of 128",
         (t(rng.permutation(128)[:16].astype(np.int32)), 128, True)),
        ("probe_hist", "store with repeats",
         (t(rng.integers(0, 4000, 1 << 20).astype(np.int32)), 4096, True)),
        ("probe_bits", "clz of 1 << 20", (t(np.full((1, 1), 1 << 20,
                                                    np.int32)), "clz")),
        ("probe_bits", "clz, 2^20 words", (words, "clz")),
        ("probe_bits", "walk, 1024 words", (t(rng.integers(
            0, 1 << 16, 1024, dtype=np.int32)), "walk")),
        ("probe_bits", "walk, 2^20 words", (words, "walk")),
        ("probe_bits", "pack 16, (8,128)", (t(rng.integers(0, 2, 1024)
                                              .astype(bool)), "pack", 16)),
        ("probe_bits", "pack 16, 2^20 + 16 bits",
         (t(rng.integers(0, 2, (1 << 20) + 16).astype(bool)), "pack", 16)),
        ("probe_bits", "pack 32, 2^22 bits",
         (t(rng.integers(0, 2, 1 << 22).astype(bool)), "pack", 32)),
        ("probe_carry", "4 blocks", (torch.arange(
            4096, dtype=torch.int32, device=dev).reshape(4, 8, 128),)),
        ("probe_carry", "2^14 blocks wrapping", (torch.randint(
            -(1 << 30), 1 << 30, (1 << 14, 1024), generator=g, device=dev,
            dtype=torch.int32),)),
        ("probe_carry", "one block", (ones,)),
        ("probe_carry", "1-D, one value a block", (words,)),
        ("probe_carry", "one row of 2^26", (torch.randint(
            -(1 << 31), (1 << 31) - 1, (1, 1 << 26), generator=g,
            device=dev, dtype=torch.int32),)),
        ("probe_carry", "2^26 rows of one value", (torch.randint(
            -(1 << 31), (1 << 31) - 1, (1 << 26, 1), generator=g,
            device=dev, dtype=torch.int32),)),
        ("probe_carry", "[0, 5]", (words[:0].reshape(0, 5),)),
        ("probe_carry", "[5, 0]", (words[:0].reshape(5, 0),)),
        ("probe_carry", "values near +-2^31", (t(np.where(
            rng.integers(0, 2, (1 << 12, 1000)) == 1, (1 << 31) - 1 -
            rng.integers(0, 8, (1 << 12, 1000)), -(1 << 31) +
            rng.integers(0, 8, (1 << 12, 1000))).astype(np.int32)),))]
    for blen in (3, 1000):
        nb = (1 << 20) // blen
        out.append(("probe_carry", f"blen {blen} from value 1",
                    (words[1:1 + nb * blen].reshape(nb, blen),)))
    for mode in probe_ops.LOOP_MODES:
        for trips in (0, 1, 37, 1000):
            out.append(("probe_loop", f"{mode}, {trips}",
                        (t(rng.integers(-9, 9, (8, 128), np.int32)),
                         t(np.array([trips], np.int32)), mode)))
    out.append(("probe_loop", "global, 1M", (
        ones, t(np.array([1_000_000], np.int32)), "global")))
    # the 16-byte loads' edges: views off a 16-byte boundary, short tails,
    # and the main path's scale with strays
    vals = torch.randint(-5, 4100, ((1 << 20) + 8,), generator=g, device=dev,
                         dtype=torch.int32)
    for off in (1, 2, 3):
        out += [("probe_hist", f"4096 bins, int offset {off}",
                 (vals[off:off + (1 << 20) + off], 4096)),
                ("probe_bits", f"clz, int offset {off}",
                 (words[off:off + 4096 + off], "clz")),
                ("probe_bits", f"walk, int offset {off}",
                 (words[off:off + 4096 + off], "walk"))]
    for n in (0, 1, 31, 33):
        out += [("probe_hist", f"n = {n}", (vals[:n], 128)),
                ("probe_hist", f"store, n = {n}", (vals[:n], 128, True)),
                ("probe_bits", f"clz, n = {n}", (words[:n], "clz")),
                ("probe_bits", f"walk, n = {n}", (words[:n], "walk"))]
    for nbins in (16, 4096, 32768, probe_ops.MAX_BINS):
        out.append(("probe_hist", f"2^26 into {nbins} with strays", (
            torch.randint(-8, nbins + 8, (1 << 26,), generator=g, device=dev,
                          dtype=torch.int32), nbins)))
    out.append(("probe_hist", "store, one value repeated",
                (torch.full((1 << 20,), 7, dtype=torch.int32, device=dev),
                 16, True)))
    mask = t(rng.integers(0, 2, (1 << 20) + 64).astype(bool))
    for off in range(1, 16):
        out += [("probe_bits", f"pack 32, byte offset {off}",
                 (mask[off:off + (1 << 20)], "pack", 32)),
                ("probe_bits", f"pack 16, byte offset {off}",
                 (mask[off:off + (1 << 16) + 16], "pack", 16))]
    for n, width in ((0, 16), (0, 32), (16, 16), (48, 16), (32, 32)):
        out.append(("probe_bits", f"pack {width}, n = {n}",
                     (mask[:n], "pack", width)))
    return out


def test_probe_kernels_match_plain(cuda_device):
    """Each probe kernel launches once a call and equals its plain version
    on the card, at the probes' shapes and at a large size."""
    for name, label, args in _probe_cases(cuda_device):
        fn = getattr(probe_ops, name)
        before = fn.launches
        got = fn(*args)
        assert fn.launches == before + 1
        want = getattr(probe_ops, name + "_ref")(*args)
        torch.cuda.synchronize()
        assert got.device.type == "cuda"
        assert got.dtype == want.dtype and torch.equal(got, want), (name,
                                                                    label)


@pytest.mark.parametrize("off", [0, 3])
@pytest.mark.parametrize("width", [16, 32])
def test_probe_pack_reads_nonzero_bytes_as_set(cuda_device, width, off):
    """uint8 bytes 0-255 viewed as bool pack as the plain version packs
    u8 != 0: a byte is set when it is not 0, aligned or not, tail or not."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(width + off)
    u8 = torch.randint(0, 256, ((1 << 20) + 64,), generator=g,
                       device=cuda_device, dtype=torch.uint8)
    u8[: 1 << 10] = 0  # some whole words of 0
    n = (1 << 20) + (16 if width == 16 else 32)
    view = u8[off:off + n]
    before = probe_ops.probe_bits.launches
    got = probe_ops.probe_bits(view.view(torch.bool), "pack", width)
    assert probe_ops.probe_bits.launches == before + 1
    want = probe_ops.probe_bits_ref(view != 0, "pack", width)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("off", [0, 1, 3])
@pytest.mark.parametrize("blen", [1, 3, 1000, 1024, 1 << 20])
def test_probe_carry_matches_plain(cuda_device, blen, off):
    """The carry's tiles against the plain version: about 2^22 wrapping
    values in blocks of blen, from a view `off` values past a 16-byte
    boundary (so the first tile starts with up to 3 scalar loads), and a
    tail that does not fill a tile."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(blen + off)
    nblocks = max(4, (1 << 22) // blen) + 1
    base = torch.randint(-(1 << 31), (1 << 31) - 1, (nblocks * blen + 3,),
                         generator=g, device=cuda_device, dtype=torch.int32)
    x = base[off:off + nblocks * blen].reshape(nblocks, blen)
    assert (x.data_ptr() % 16 == 0) == (off == 0)
    before = probe_ops.probe_carry.launches
    got = probe_ops.probe_carry(x)
    assert probe_ops.probe_carry.launches == before + 1
    want = probe_ops.probe_carry_ref(x)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_probe_walk_in_one_block(cuda_device):
    """The walk over 2^21 words whose set bits all lie in the first 256
    words, which the first CTA walks whatever the grid: its warps' sums,
    and no other, reach the result."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(21)
    words = torch.zeros(1 << 21, dtype=torch.int32, device=cuda_device)
    words[:256] = torch.randint(-(1 << 31), (1 << 31) - 1, (256,),
                                generator=g, device=cuda_device,
                                dtype=torch.int32)
    words[0] = -1  # all 32 bits
    before = probe_ops.probe_bits.launches
    got = probe_ops.probe_bits(words, "walk")
    assert probe_ops.probe_bits.launches == before + 1
    want = probe_ops.probe_bits_ref(words, "walk")
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(want) > 0


def test_probes_module_on_card(cuda_device):
    """python -m fastk_tpu_torch.probes: 19 probe lines, each OK, through
    the four kernels."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "fastk_tpu_torch.probes"],
                       cwd=repo, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 19 and all(" OK " in ln for ln in lines), r.stdout
    from fastk_tpu_torch import probes

    before = [k.launches for k in probe_ops.KERNELS]
    assert all(ok for _, ok, _ in probes.main("cuda"))
    assert all(k.launches > b for k, b in zip(probe_ops.KERNELS, before))


@pytest.mark.parametrize("off,n", [(0, 1 << 26), (1, (1 << 24) + 2),
                                   (2, (1 << 24) + 1), (3, (1 << 24) + 3)])
def test_probe_store_mode_at_scale(cuda_device, off, n):
    """Store mode (shared maxima, the cluster's max, a global atomicMax a
    nonzero bin) against the plain version: 2^26 values with strays and
    ties into 32768 bins, and views `off` values past a 16-byte boundary
    with a tail; a bin hit only by index 0 stays 0."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(off + 26)
    base = torch.randint(-8, 32776, (n + 3,), generator=g,
                         device=cuda_device, dtype=torch.int32)
    base[base == 5] = 6
    base[off] = 5  # only index 0 of the view lands in bin 5
    x = base[off:off + n]
    assert (x.data_ptr() % 16 == 0) == (off == 0)
    before = probe_ops.probe_hist.launches
    got = probe_ops.probe_hist(x, 32768, store=True)
    assert probe_ops.probe_hist.launches == before + 1
    want = probe_ops.probe_hist_ref(x, 32768, store=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(want[5]) == 0


LOOP_TRIPS = ["0", "1", "31", "threads - 1", "threads", "threads + 1",
              "threads x 128 + 1", "1M", "-7", "2^31 - 1"]


@pytest.mark.parametrize("trips", LOOP_TRIPS)
@pytest.mark.parametrize("mode", probe_ops.LOOP_MODES)
def test_probe_loop_over_the_card(cuda_device, mode, trips):
    """The loop's persistent grid against the closed form, each mode, at
    trip counts around the grid's thread count and at the int32 edge, on a
    table of values near +-2^31 (the sum wraps)."""
    rng = np.random.default_rng(len(trips))
    table = torch.from_numpy(np.where(
        rng.integers(0, 2, (8, 128)) == 1,
        (1 << 31) - 1 - rng.integers(0, 8, (8, 128)),
        -(1 << 31) + rng.integers(0, 8, (8, 128))).astype(np.int32)).to(
            cuda_device)
    threads = probe_ops.loop_threads(table, mode)
    n = {"0": 0, "1": 1, "31": 31, "threads - 1": threads - 1,
         "threads": threads, "threads + 1": threads + 1,
         "threads x 128 + 1": threads * 128 + 1, "1M": 1_000_000,
         "-7": -7, "2^31 - 1": (1 << 31) - 1}[trips]
    t = torch.tensor([n], dtype=torch.int32, device=cuda_device)
    before = probe_ops.probe_loop.launches
    got = probe_ops.probe_loop(table, t, mode)
    assert probe_ops.probe_loop.launches == before + 1
    want = probe_ops.probe_loop_ref(table, t, mode)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("shape", [(1, 1), (4, 1024), (1024, 4), (2, 8),
                                   (64, 64), (4096, 2)])
@pytest.mark.parametrize("mode", ["global", "shared"])
def test_probe_loop_tables(cuda_device, mode, shape):
    """Tables narrower than the loop's unroll (each step's own entry) and
    wider (an entry a pass, then steps of cols + 1), 1M + 5 steps."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(shape[0] * 7 + shape[1])
    table = torch.randint(-(1 << 31), (1 << 31) - 1, shape, generator=g,
                          device=cuda_device, dtype=torch.int32)
    t = torch.tensor([1_000_005], dtype=torch.int32, device=cuda_device)
    got = probe_ops.probe_loop(table, t, mode)
    want = probe_ops.probe_loop_ref(table, t, mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_probe_loop_sass_loads_a_step(cuda_device):
    """Each unrolled loop of the loop kernel's instances holds its
    kLoopUnroll loads (LDG in static and global mode, LDS in shared mode)
    and index mode's kLoopUnroll IADD3s, in the built library's SASS."""
    from fastk_tpu_torch import _kernels

    unroll = chip_smoke._constant("kLoopUnroll")
    sass = chip_smoke.loop_sass(_kernels.build())
    assert set(sass) == set(probe_ops.LOOP_MODES)
    for m, col in (("index", 2), ("static", 0), ("global", 0),
                   ("shared", 1)):
        assert max(loop[col] for loop in sass[m]) >= unroll, (m, sass[m])


@pytest.mark.parametrize("mesh", [False, True], ids=["run_one",
                                                    "run_one_mesh"])
def test_rss_runs_on_card(cuda_device, tmp_path, mesh):
    """probes/rss.py's runs at 16 MB of random bases on the card, each a
    fresh process: a peak RSS, the device line (device peak, pinned-host
    cache), the CLI out of core, the mesh's owner counts on run_hist."""
    from fastk_tpu_torch.probes import rss

    fasta = str(tmp_path / "in.fasta")
    rss.make_fasta(fasta, 16 << 20)
    work = tmp_path / "work"
    work.mkdir()
    res = (rss.run_one_mesh if mesh else rss.run_one)(fasta, str(work), 40)
    assert res["peak_rss_mb"] > 0 and res["input_bases"] > 16 << 20
    assert res["device_peak_bytes"] > 0
    assert res["pinned_peak_bytes"] >= res["pinned_current_bytes"] >= 0
    if mesh:
        assert res["run_hist_launches"] > 0
    else:
        assert res["out_of_core"] and res["run_hist_launches"] == 0


def test_bench_headline_step_matches_plain(cuda_device):
    """The bench's headline step on the card (fastk_tpu_torch/bench.py)
    launches the run-length kernel once, and its histogram equals the same
    step's with the plain binning, exactly."""
    from fastk_tpu_torch import bench
    from fastk_tpu_torch.ops.pack import upload_packed

    size = 1 << 20
    pw, exc, total, nreads = bench.bench_input(size, 1 << 16, bench.READ_LEN)
    before = histker.run_hist.launches
    hist, nvalid = bench.headline_step(pw, exc, total, size, cuda_device)
    assert histker.run_hist.launches == before + 1
    codes = upload_packed(pw, exc, total, cuda_device)
    sw, valid_end = histker.hist_device_part(codes, bench.K, size)
    want, _ = histker.run_hist_ref(sw, valid_end)
    torch.cuda.synchronize()
    assert torch.equal(hist, want)
    assert nvalid == valid_end == nreads * (bench.READ_LEN - bench.K + 1)


@pytest.mark.parametrize("module", ["sizes", "tail", "sorts", "h2d",
                                    "decomp"])
def test_probe_module_cases_match_cpu(cuda_device, module):
    """Every case of the probe module at 2^16 on the card equals the same
    case on the CPU (probes/common.py same); sizes, sorts and decomp launch
    the run-length kernel."""
    import importlib

    from fastk_tpu_torch.probes import common

    mod = importlib.import_module(f"fastk_tpu_torch.probes.{module}")
    host = dict(mod.cases(torch.device("cpu"), 1 << 16))
    before = histker.run_hist.launches
    card = mod.cases(cuda_device, 1 << 16)
    bad = [n for n, fn in card if not common.same(fn(), host[n]())]
    assert [n for n, _ in card] == list(host) and not bad
    if module in ("sizes", "sorts", "decomp"):
        assert histker.run_hist.launches > before
