"""Multi-process execution scaffolding over torch.distributed.

Port of ``fastk_tpu/parallel/multihost.py``. The JAX package runs one global
mesh over every host's chips; here every card is a process of one
torch.distributed world, and the chip index is the rank:

- ``init_from_env`` joins the world from FASTK_TPU_COORD (host:port of rank
  0's store), FASTK_TPU_NPROCS (the world size) and FASTK_TPU_PROC (this
  rank), the JAX CLI's variables. The exchange group is the world: NCCL
  when the device is a card, gloo when the caller asks for the CPU; nothing
  falls back from one to the other. Host arrays (flags, prefix histograms,
  totals, ragged rows) travel in a gloo side group, the world itself when
  it is gloo. FASTK_TPU_MESH_TIMEOUT, when set, is the world's timeout.
- input files shard across ranks deterministically (``shard_files``); the
  global read order is rank-major, then file, then read.
- each rank feeds its own card (``_local_shard_rows``).

The production counting path is ``parallel/meshooc.py``;
``count_files_multihost`` is the in-RAM wrapper over it. A process outside
any world is a world of one, and every collective here is then the
identity.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fastk_tpu_torch.ops.kmers import pad_needed
from fastk_tpu_torch.convert import device_codes

_groups_of: dict = {}  # the world's process group -> (world, host group)


def _world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) outside any world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def groups():
    """(exchange group, host group) of the current world, or (None, None)
    outside one. The gloo host group is made once per world, collectively:
    every rank must reach its first call together."""
    if not (dist.is_available() and dist.is_initialized()):
        return None, None
    world = dist.group.WORLD
    got = _groups_of.get("world")
    if got is None or got[0] is not world:
        host = (world if dist.get_backend(world) == "gloo"
                else dist.new_group(backend="gloo"))
        got = _groups_of["world"] = (world, host)
    return got


def mesh_timeout() -> float:
    """FASTK_TPU_MESH_TIMEOUT in seconds; 0 (the default) is no limit."""
    return float(os.environ.get("FASTK_TPU_MESH_TIMEOUT", "0") or 0)


def rank_device(device, rank: int) -> torch.device:
    """This rank's device: card rank % device_count for "cuda"."""
    from fastk_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_from_env(device="cuda") -> Tuple[int, int]:
    """Join the torch.distributed world named by FASTK_TPU_COORD,
    FASTK_TPU_NPROCS and FASTK_TPU_PROC when they ask for more than one
    process (a no-op when unset or already joined). Returns (rank, world
    size).

    The environment is read first, as in the JAX package; the world's
    backend is NCCL for a card and gloo for the CPU, and its timeout is
    FASTK_TPU_MESH_TIMEOUT when that is set."""
    coord = os.environ.get("FASTK_TPU_COORD")
    nprocs = int(os.environ.get("FASTK_TPU_NPROCS", "1") or 1)
    if coord and nprocs > 1 and not dist.is_initialized():
        rank = int(os.environ["FASTK_TPU_PROC"])
        dev = rank_device(device, rank)
        kw = {}
        if mesh_timeout() > 0:
            kw["timeout"] = datetime.timedelta(seconds=mesh_timeout())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{coord}", rank=rank, world_size=nprocs, **kw)
        groups()
    return _world()


def shard_files(paths: Sequence[str], pid: int, nprocs: int) -> List[str]:
    """Deterministic per-host file assignment: size-descending greedy onto
    the least-loaded host (every process computes the same plan)."""
    sizes = []
    for p in paths:
        try:
            sizes.append(os.path.getsize(p))
        except OSError:
            sizes.append(0)
    order = sorted(range(len(paths)), key=lambda i: (-sizes[i], i))
    load = [0] * nprocs
    mine: List[Tuple[int, str]] = []
    for i in order:
        h = min(range(nprocs), key=lambda j: (load[j], j))
        load[h] += sizes[i]
        if h == pid:
            mine.append((i, paths[i]))
    return [p for _, p in sorted(mine)]


def _local_shard_rows(codes: np.ndarray, k: int, mesh,
                      shard_size: int) -> torch.Tensor:
    """This rank's shard of a code stream: its first shard_size codes and
    the k-1 halo after them, padded with code 4, on the rank's device."""
    row = np.full(shard_size + pad_needed(k), 4, dtype=np.uint8)
    n = min(len(codes), len(row))
    row[:n] = codes[:n]
    return device_codes(row, mesh.device)


def _allgather_ragged(arr: np.ndarray) -> List[np.ndarray]:
    """Gather a per-rank array of any length (its trailing shape and dtype
    the same everywhere) to every rank, in rank order. Its bytes travel in
    the host group; outside a world: identity."""
    _, host = groups()
    if host is None or dist.get_world_size() == 1:
        return [arr]
    arr = np.ascontiguousarray(arr)
    nbytes = torch.tensor([arr.nbytes], dtype=torch.int64)
    lens = [torch.zeros(1, dtype=torch.int64)
            for _ in range(dist.get_world_size())]
    dist.all_gather(lens, nbytes, group=host)
    lens = [int(n) for n in lens]
    cap = max(lens)
    buf = torch.zeros(cap, dtype=torch.uint8)
    buf[: arr.nbytes] = torch.from_numpy(arr.reshape(-1).view(np.uint8))
    bufs = [torch.empty(cap, dtype=torch.uint8) for _ in lens]
    dist.all_gather(bufs, buf, group=host)
    return [b[:n].numpy().view(arr.dtype).reshape((-1,) + arr.shape[1:])
            for b, n in zip(bufs, lens)]


def _allgather(arr: np.ndarray) -> np.ndarray:
    """A fixed-shape per-rank array stacked over ranks: [world, ...]."""
    return np.stack(_allgather_ragged(np.asarray(arr)))


def _barrier() -> None:
    """Wait for every rank (host group); outside a world: nothing."""
    _, host = groups()
    if host is not None:
        dist.barrier(group=host)


def count_files_multihost(
    paths: Sequence[str],
    k: int,
    mesh=None,
    table_min: Optional[int] = None,
    profiles: bool = False,
    batch_bases: int = 64 << 20,
    slack: float = 1.8,
    verbose: bool = False,
    device="cuda",
):
    """Convenience wrapper over the scale-out mesh path
    (parallel.meshooc.count_files_mesh) returning the COMPLETE result in
    RAM on every rank: only the final per-rank table slices (merged and
    keyspace-disjoint) and profile lists are exchanged, once. For results
    too large for one host's RAM, call count_files_mesh with ``out_base``
    and splice the slice file-sets with fastcat instead."""
    from fastk_tpu_torch.parallel.meshooc import count_files_mesh, default_mesh

    if mesh is None:
        mesh = default_mesh(device)
    out = count_files_mesh(paths, k, mesh=mesh, table_min=table_min,
                           profiles=profiles, batch_bases=batch_bases,
                           slack=slack, verbose=verbose)
    if _world()[1] == 1:
        return out
    if table_min is not None:
        out.table = gather_table(out.table)
    if profiles:
        out.profiles = gather_profiles(out.profiles)
    return out


def gather_table(table):
    """The ranks' keyspace slices of a table (KmerTable) concatenated in
    rank order, which is key order: the whole table, on every rank."""
    from fastk_tpu_torch.formats.ktab import KmerTable

    kb = (table.kmer + 3) // 4
    rec = np.concatenate(
        [table.packed,
         np.ascontiguousarray(table.counts, dtype="<u2"
                              ).view(np.uint8).reshape(-1, 2)], axis=1)
    allrec = np.concatenate(_allgather_ragged(rec))  # rank order
    return KmerTable(table.kmer, table.minval, allrec[:, :kb],
                     np.ascontiguousarray(allrec[:, kb:]).view("<u2").ravel())


def gather_profiles(profiles) -> List[np.ndarray]:
    """Every rank's profiles (uint16 arrays) in rank order, on every
    rank."""
    lens = np.array([len(p) for p in profiles], np.int64)
    vals = (np.concatenate(profiles).astype(np.uint32)
            if len(profiles) else np.zeros(0, np.uint32))
    out = []
    for ls, vs in zip(_allgather_ragged(lens), _allgather_ragged(vals)):
        off = 0
        for L in ls:
            out.append(vs[off: off + int(L)].astype(np.uint16))
            off += int(L)
    return out
