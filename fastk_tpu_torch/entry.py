"""Entry points: the single-card counting step, and a dry run of the
whole multi-device path.

Port of ``__graft_entry__.py``. ``entry()`` returns the flagship counting
step and its example input; ``dryrun_multichip(n)`` runs each multi-device
entry point of ``parallel/`` once in a torch.distributed world of n ranks,
one process a card (NCCL; gloo with device="cpu"), and checks every result.
Outside a world it starts the ranks itself, each as

    python -m fastk_tpu_torch.entry dryrun <rank> <world> <store> <out> <args>

(``parallel/launch.py``); inside a world that every rank has joined, every
rank calls it and it runs in place.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.formats.hist import HIST_HIGH
from fastk_tpu_torch.formats.ktab import read_ktab
from fastk_tpu_torch.formats.prof import read_profiles
from fastk_tpu_torch.ops.count import count_batch
from fastk_tpu_torch.ops.histker import run_hist
from fastk_tpu_torch.ops.kmers import pad_needed
from fastk_tpu_torch.convert import device_codes
from fastk_tpu_torch.parallel import launch
from fastk_tpu_torch.parallel.dist import make_mesh
from fastk_tpu_torch.parallel.host import count_files_sharded, sharded_count
from fastk_tpu_torch.parallel.meshooc import count_files_mesh
from fastk_tpu_torch.parallel.multihost import (
    count_files_multihost,
    gather_profiles,
    gather_table,
    shard_files,
)
from fastk_tpu_torch.pipeline.count import count_files

ENTRY_K = 40
ENTRY_SIZE = 1 << 17
# the command each rank of dryrun_multichip's own world runs
WORKER = [sys.executable, "-m", "fastk_tpu_torch.entry"]


def _example_codes(n: int, k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n + pad_needed(k), dtype=np.uint8)
    codes[n:] = 4  # trailing sentinels
    codes[:: 997] = 4  # sprinkle read separators / invalid bases
    return codes


def entry(device="cuda"):
    """(fn, example_args): the single-card counting step on the flagship
    path (canonical 40-mer keys, the key sort, the segmented count, the
    histogram and the per-position profile counts) and its codes, a tensor
    on `device`. Runs on the card unless device="cpu"; raises without one.

    fn(codes) is count_batch(codes, 40, 2^17, True) with the histogram,
    which on a card is the run-length kernel (one launch a call). The JAX
    entry's step names the histogram but leaves want_hist off; here it is
    on, so that the step runs the kernel."""
    dev = resolve_device(device)

    def fn(codes):
        return count_batch(codes, ENTRY_K, ENTRY_SIZE, True, True)

    return fn, (device_codes(_example_codes(ENTRY_SIZE, ENTRY_K), dev),)


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _write_fasta(path: str, reads) -> None:
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq}\n")


def _split(d: str, stem: str, reads, nfiles: int):
    """`reads` in `nfiles` FASTA files of consecutive reads; returns the
    paths and the global read order of a world of `nfiles` ranks (rank
    major, then file), in which the profiles come back."""
    paths = []
    for i in range(nfiles):
        p = os.path.join(d, f"{stem}{i}.fasta")
        _write_fasta(p, reads[i * len(reads) // nfiles:
                              (i + 1) * len(reads) // nfiles])
        paths.append(p)
    order = [p for r in range(nfiles) for p in shard_files(paths, r, nfiles)]
    return paths, order


def _dryrun(mesh) -> dict:
    """Every step and check of the dry run on this rank of `mesh`; returns
    this rank's report (its run_hist launches, wall seconds and the mesh
    job's stats)."""
    n = mesh.size
    launches = run_hist.launches
    t0 = time.perf_counter()

    # the counting step over the mesh: read shards, the keyspace-range
    # all_to_all, the owners' sort and count, the histogram all_reduce and
    # the inverse all_to_all of the profile counts
    k = 24
    codes = _example_codes(n * 4096, k, seed=1)
    words, counts, hist, overflow, pos = sharded_count(
        codes, k, mesh, want_positions=True)
    _expect(hist.shape == (HIST_HIGH + 1,), f"histogram shape {hist.shape}")
    _expect(pos is not None and len(pos) == len(codes),
            "pos_counts cover the stream")
    _expect(int(counts.sum()) == int(
        hist[1:] @ np.arange(1, HIST_HIGH + 1, dtype=np.int64)) + overflow,
        "instances = histogram + overflow")

    # the pipeline-level API over a real (tiny) input, its reads spread
    # over one file a rank
    rng = np.random.default_rng(2)
    with tempfile.TemporaryDirectory(prefix="fastk_dryrun_") as d:
        reads = [(f"r{i}", "".join("acgt"[c]
                                   for c in rng.integers(0, 4, size=120)))
                 for i in range(24)]
        paths, _order = _split(d, "in", reads, n)
        out = count_files_sharded(paths, k, mesh, table_min=1,
                                  batch_bases=2048)
        _expect(out.table is not None and out.table.check_sorted(),
                "this rank's table slice is sorted")
        whole = gather_table(out.table)
        _expect(whole.check_sorted(), "the ranks' slices concatenate sorted")
        _expect(out.hist.total_instances() == 24 * (120 - k + 1),
                f"instances {out.hist.total_instances()}")

        # relative profiles (-p:<table>) over the mesh: every read profiled
        # against the table of the whole input reports its own counts
        rel = count_files_sharded(paths, k, mesh, batch_bases=2048,
                                  relative_table=whole)
        profs = gather_profiles(rel.profiles)
        _expect(len(profs) == 24, f"{len(profs)} relative profiles")
        _expect(all(len(pr) == 120 - k + 1 and pr.min() >= 1
                    for pr in profs), "relative profiles count every k-mer")

        # the in-RAM multi-process wrapper: the whole result on every rank
        mh = count_files_multihost(paths, k, mesh=mesh, table_min=1,
                                   batch_bases=2048)
        _expect(mh.hist == out.hist, "count_files_multihost's histogram")
        _expect(np.array_equal(mh.table.packed, whole.packed)
                and np.array_equal(mh.table.counts, whole.counts),
                "count_files_multihost's table")

        # the scale-out mesh path: multi-word keys (k=40), several batches
        # (the owner-resident merge across batches and the keyspace
        # spill), streamed profiles, and one hot k-mer, which routes to
        # one rank
        reads = [(f"r{i}", "".join("acgt"[c]
                                   for c in rng.integers(0, 4, size=120)))
                 for i in range(16)]
        reads += [(f"s{i}", "a" * 120) for i in range(40)]
        paths, order = _split(d, "in40_", reads, n)
        want40 = count_files(order, 40, table_min=1, profiles=True,
                             batch_bases=2048, device=mesh.device)
        sort = os.path.join(d, "sort")
        os.mkdir(sort)
        mm = count_files_mesh(paths, 40, mesh=mesh, table_min=1,
                              profiles=True, batch_bases=2048,
                              out_base=os.path.join(d, "m40"), out_nparts=2,
                              sort_path=sort, parts_per_chip=2)
        _expect(mm.hist == want40.hist, "count_files_mesh's histogram")
        _expect(mm.table_entries == len(want40.table),
                f"count_files_mesh's {mm.table_entries} table entries")
        t40 = gather_table(read_ktab(mm.slice_base))
        _expect(np.array_equal(t40.packed, want40.table.packed)
                and np.array_equal(t40.counts, want40.table.counts),
                "count_files_mesh's .ktab")
        p40 = gather_profiles(read_profiles(mm.slice_base))
        _expect(len(p40) == len(want40.profiles)
                and all(np.array_equal(a, b)
                        for a, b in zip(p40, want40.profiles)),
                "count_files_mesh's .prof")
        _expect(not os.listdir(sort), "count_files_mesh left spills")
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return dict(rank=mesh.rank, world=n, device=str(mesh.device),
                run_hist_launches=run_hist.launches - launches,
                wall_s=time.perf_counter() - t0, mesh_stats=mm.mesh_stats)


def run_dryrun(n_devices: int, device="cuda") -> list:
    """dryrun_multichip's run; returns each rank's report (rank, world,
    device, run_hist_launches, wall_s, mesh_stats): every rank's outside a
    world, this rank's alone inside one."""
    dev = resolve_device(device)
    if n_devices < 1:
        raise ValueError(f"dryrun_multichip needs 1 or more devices, not "
                         f"{n_devices}")
    if dist.is_available() and dist.is_initialized():
        return [_dryrun(make_mesh(n_devices, device=dev.type))]
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(
            f"dryrun_multichip({n_devices}) needs {n_devices} cards, one a "
            f"rank (NCCL refuses two ranks on one card); this machine has "
            f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="fastk_dryrun_world_") as tmp:
        return launch.run_world(WORKER, "dryrun", n_devices, tmp,
                                dict(device=dev.type), tag="dryrun")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run one full multi-device counting job on a world of n_devices
    ranks, one process a card, and check each result against the
    single-process port: sharded_count, count_files_sharded with a table
    and with -p:<table>, count_files_multihost, and count_files_mesh at
    k = 40 (several batches, streamed .ktab and .prof, a hot k-mer).

    Outside a torch.distributed world it starts the ranks itself (NCCL, or
    gloo for device="cpu") and raises WorldFailed, with each failed rank's
    standard error, when a rank fails or the world passes 180 s; asked for
    more ranks than there are cards, it raises. Inside a world of n_devices
    ranks, every rank calls it and it runs in place."""
    run_dryrun(n_devices, device)


def _task_dryrun(args) -> dict:
    (report,) = run_dryrun(dist.get_world_size(), args["device"])
    return report


if __name__ == "__main__":
    sys.exit(launch.worker_main({"dryrun": _task_dryrun}))
