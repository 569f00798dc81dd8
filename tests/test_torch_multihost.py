"""The port's multi-process scaffolding (fastk_tpu_torch.parallel
.multihost) and the CLI's multi-process -p:<table> against the JAX
package's: the file-shard planner, init_from_env, the in-RAM wrapper at
worlds of 1 and 2 (gloo processes), and fastk -p:<table> across 2 and 4
processes."""

import os

import numpy as np
import pytest
import torch.distributed as dist

from fastk_tpu.formats.ktab import write_ktab
from fastk_tpu.formats.prof import read_profiles
from fastk_tpu.parallel.multihost import shard_files as jax_shard_files
from fastk_tpu.pipeline.count import count_files as jax_count_files
from fastk_tpu.tools.fastk import main as jax_fastk_main
from fastk_tpu_torch.parallel import multihost as tmh

import torch_dist_worker as tw


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(21)
    d = tmp_path_factory.mktemp("mh")
    genome = rng.integers(0, 4, size=2000)
    paths = []
    for fno in range(3):
        p = d / f"part{fno}.fasta"
        with open(p, "w") as f:
            for i in range(30 + 10 * fno):
                s = int(rng.integers(0, len(genome) - 90))
                r = genome[s: s + 90]
                f.write(f">r{fno}_{i}\n{''.join('acgt'[c] for c in r)}\n")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("nprocs", [1, 2, 3, 4, 7])
def test_shard_files_matches_jax(data, nprocs):
    paths = data + [f"/nonexistent/f{i}" for i in range(5)]
    got = [tmh.shard_files(paths, pid, nprocs) for pid in range(nprocs)]
    assert got == [jax_shard_files(paths, pid, nprocs)
                   for pid in range(nprocs)]
    assert sorted(p for g in got for p in g) == sorted(paths)


def test_init_from_env_single_process(monkeypatch):
    """Without the variables, or with FASTK_TPU_NPROCS=1, no world is
    joined: the process is a world of one."""
    for env in ({}, {"FASTK_TPU_COORD": "127.0.0.1:1",
                     "FASTK_TPU_NPROCS": "1", "FASTK_TPU_PROC": "0"}):
        for k in ("FASTK_TPU_COORD", "FASTK_TPU_NPROCS", "FASTK_TPU_PROC"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert tmh.init_from_env("cpu") == (0, 1)
        assert not dist.is_initialized()
    assert tmh.groups() == (None, None)
    arr = np.arange(6, dtype=np.uint32).reshape(3, 2)
    assert tmh._allgather_ragged(arr)[0] is arr
    assert tmh._allgather(np.array([3, 4])).tolist() == [[3, 4]]


def _same(res, want):
    h = res["hist"]
    assert (h.kmer, h.counts.tolist(), h.ilowcnt, h.ihighcnt) == (
        want.hist.kmer, want.hist.counts.tolist(), want.hist.ilowcnt,
        want.hist.ihighcnt)
    assert (res["nreads"], res["totlen"]) == (want.nreads, want.totlen)
    assert np.array_equal(res["table"][0], want.table.packed)
    assert np.array_equal(res["table"][1], want.table.counts)
    if want.profiles is not None:
        assert len(res["profiles"]) == len(want.profiles)
        assert all(np.array_equal(a, b)
                   for a, b in zip(res["profiles"], want.profiles))


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("profiles", [False, True])
def test_multihost_matches_single_chip(data, tmp_path, world, profiles):
    """count_files_multihost returns the whole result on every rank, equal
    to JAX's count_files over the global read order."""
    args = dict(paths=data, k=17, profiles=profiles, bb=3000)
    if world == 1:
        res = [tw.TASKS["multihost"](args)]
    else:
        res = tw.run_world("multihost", world, tmp_path, args)
    order = [p for r in range(world) for p in jax_shard_files(data, r, world)]
    want = jax_count_files(order, 17, table_min=1, profiles=profiles,
                           batch_bases=3000)
    for r in res:
        _same(r, want)


@pytest.mark.parametrize("world", [2, 4])
def test_cli_relative_profiles_multiprocess(data, tmp_path, world):
    """fastk -p:<table> across a world of processes: rank 0 splices the
    slices, equal to the JAX CLI's relative profiles over the same global
    read order; no histogram, no slice left."""
    base = jax_count_files([data[0]], 17, table_min=1, batch_bases=100000)
    tab = str(tmp_path / "tab")
    write_ktab(tab, base.table)
    out = str(tmp_path / "rel")
    rcs = tw.run_cli(world, tmp_path, ["-k17", f"-p:{tab}.ktab",
                                       f"-P{tmp_path}", f"-N{out}", *data],
                     env={"FASTK_TPU_BATCH_BASES": str(1 << 20)})
    assert rcs == [0] * world
    order = [p for r in range(world) for p in jax_shard_files(data, r, world)]
    want = str(tmp_path / "jax")
    assert jax_fastk_main(["-k17", f"-p:{tab}.ktab", f"-N{want}",
                           *order]) == 0
    pa, pb = read_profiles(out), read_profiles(want)
    assert len(pa) == len(pb)
    assert all(np.array_equal(a, b) for a, b in zip(pa, pb))
    assert not os.path.exists(out + ".hist")
    assert not [f for f in os.listdir(tmp_path) if f.startswith(
        tuple(f"{p}rel.{r}." for r in range(world) for p in ("", ".")))]
