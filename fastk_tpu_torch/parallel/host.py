"""Host orchestration of the multi-device counting step: shard placement,
splitter training, result extraction and host-side assembly.

Port of ``fastk_tpu/parallel/host.py``. Every rank of the mesh calls these
functions together (SPMD). ``sharded_count`` takes the whole code stream on
every rank, counts the rank's shard and returns the global result on every
rank; the file-level entry points shard the input files across ranks.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from fastk_tpu_torch.convert import (
    device_codes,
    words_from_numpy,
    words_to_numpy,
)
from fastk_tpu_torch.formats.hist import HIST_HIGH
from fastk_tpu_torch.ops.count import fold_invalid
from fastk_tpu_torch.ops.kmers import canonical_kmers, pad_needed
from fastk_tpu_torch.parallel.dist import (
    Mesh,
    prefix_histogram,
    sharded_count_fn,
    splitters_from_prefix_hist,
)
from fastk_tpu_torch.parallel.multihost import (
    _allgather,
    _allgather_ragged,
    _local_shard_rows,
)


def _spl(splitters: np.ndarray, mesh: Mesh) -> torch.Tensor:
    return words_from_numpy((splitters,), mesh.device)[0]


def _sample_codes(codes: np.ndarray, k: int, sample: int):
    """The first `sample` codes of a stream, padded to a power of two (at
    least 32768) and its halo: (padded codes, size)."""
    n = min(len(codes), sample)
    size = 1 << max(15, int(np.ceil(np.log2(max(n, 2)))))
    buf = np.full(size + pad_needed(k), 4, dtype=np.uint8)
    buf[:n] = codes[:n]
    return buf, size


def _word0_sorted(codes: np.ndarray, k: int, sample: int,
                  device: torch.device) -> np.ndarray:
    """Sorted word0 of the valid windows among the first `sample` codes."""
    buf, size = _sample_codes(codes, k, sample)
    words, invalid = canonical_kmers(device_codes(buf, device), k, size)
    (f0,) = fold_invalid((words[0],), invalid)
    sw = words_to_numpy((torch.sort(f0).values,))[0]
    return sw[: int(np.searchsorted(sw, 0xFFFFFFFF))]


def train_splitters(codes: np.ndarray, k: int, mesh: Mesh,
                    sample: int = 1 << 20, bits: int = 10,
                    exact: bool = False) -> np.ndarray:
    """Train keyspace splitters on a sample of the stream (on this rank's
    device; every rank holds the same stream, so all agree).

    exact: place splitters at empirical word0 quantiles of the sample
    (full 32-bit resolution) instead of `bits`-bit prefix-histogram
    boundaries — the rebalance path uses this, since a single hot prefix
    can exceed a chip's bucket at any histogram granularity."""
    D = mesh.size
    if D == 1:
        return np.zeros(0, dtype=np.uint32)
    if not exact:
        buf, size = _sample_codes(codes, k, sample)
        ph = prefix_histogram(device_codes(buf, mesh.device), k, size, bits)
        return splitters_from_prefix_hist(ph.cpu().numpy(), D)
    sw = _word0_sorted(codes, k, sample, mesh.device)
    nvalid = len(sw)
    if nvalid == 0:
        return splitters_from_prefix_hist(np.ones(1 << bits, np.int64), D)
    # exclusive upper bounds: chip d owns w0 in [spl[d-1], spl[d])
    return sw[[min(nvalid - 1, nvalid * t // D)
               for t in range(1, D)]].astype(np.uint32)


def count_files_sharded(
    paths,
    k: int,
    mesh: Mesh,
    table_min: Optional[int] = None,
    profiles: bool = False,
    batch_bases: int = 64 << 20,
    verbose: bool = False,
    relative_table=None,
):
    """Multi-device version of pipeline.count.count_files.

    Each batch's code stream shards across the ranks, keys route by range,
    and each card merges ITS keyspace range across batches (owner-resident,
    spilled out of core between rounds — parallel.meshooc.count_files_mesh,
    which this delegates to). Rank order is key order: the ranks' tables
    concatenate into the sorted table. Returns this rank's CountOutput
    (its keyspace slice of the table, the profiles of its own reads; the
    histogram and totals are global)."""
    if relative_table is not None:
        # -p:<table> mode: profiles against the given table, no counting
        return relative_profiles_sharded(
            paths, relative_table, mesh, batch_bases=batch_bases,
            verbose=verbose)

    from fastk_tpu_torch.parallel.meshooc import count_files_mesh

    return count_files_mesh(list(paths), k, mesh=mesh, table_min=table_min,
                            profiles=profiles, batch_bases=batch_bases,
                            verbose=verbose)


def relative_profiles_sharded(
    paths,
    table,
    mesh: Mesh,
    batch_bases: int = 64 << 20,
    slack: float = 1.8,
    route_impl: str = "auto",
    verbose: bool = False,
    out_base: Optional[str] = None,
    out_nparts: int = 4,
):
    """Multi-device `-p:<table>`: profiles of the input reads RELATIVE to a
    reference table (count = table count, or 0 if absent).

    The table is range-partitioned across ranks at its own word0 quantiles
    (it is sorted, so the quantiles are exact), and each rank keeps only
    its shard on its device for every batch; each batch's queries route to
    their owner. The input files shard across ranks (rank-major read
    order) and the ranks proceed in lockstep rounds. With ``out_base`` the
    profiles stream per batch through ProfWriter (per-rank slice file-sets
    ``<out_base>.<rank>`` in a world of more than one, spliced by fastcat);
    otherwise the rank's own reads' profiles return in the CountOutput."""
    from fastk_tpu_torch.formats.prof import ProfWriter, encode_profiles_bulk
    from fastk_tpu_torch.io.reader import batched_reads
    from fastk_tpu_torch.ops.kmers import packed_to_words
    from fastk_tpu_torch.parallel.dist import sharded_relative_fn
    from fastk_tpu_torch.parallel.multihost import shard_files
    from fastk_tpu_torch.pipeline.count import (
        CountOutput,
        _profiles_from_positions,
    )

    k = table.kmer
    D = mesh.size
    pid, nprocs = mesh.rank, mesh.size
    my_paths = (shard_files(list(paths), pid, nprocs) if nprocs > 1
                else list(paths))
    words = packed_to_words(table.packed, k)
    n = words.shape[0]

    # range-partition the (sorted) table at its word0 quantiles; the router
    # computes dest = #{splitters <= word0} (searchsorted right, _route_chip),
    # i.e. splitters are EXCLUSIVE upper bounds of each chip — so the table
    # cut for chip d is the first row with word0 >= splitter (side="left"),
    # keeping ownership consistent
    if D > 1 and n:
        splitters = words[:, 0][
            [min(n - 1, n * t // D) for t in range(1, D)]].astype(np.uint32)
    else:
        splitters = np.zeros(max(D - 1, 0), dtype=np.uint32)
    cuts = [0] + [int(np.searchsorted(words[:, 0], s, side="left"))
                  for s in splitters] + [n]
    lo, hi = cuts[pid], cuts[pid + 1]
    t_words = words_from_numpy(words[lo:hi].T, mesh.device)
    t_counts = torch.from_numpy(np.minimum(table.counts[lo:hi], HIST_HIGH)
                                .astype(np.int32)).to(mesh.device)
    spl = _spl(splitters, mesh)

    fns: dict = {}
    cur_slack = slack
    profs: Optional[list] = None
    stream = out_base is not None
    slice_base = (out_base if (out_base is None or nprocs == 1)
                  else f"{out_base}.{pid}")
    if not stream:
        profs = []
    # streamed: encoded blocks spool to DISK until the read count is known
    # (ProfWriter fixes its part cuts from the total up front), then replay
    # in bounded chunks — host RAM stays O(batch)
    spool_d = spool_l = None
    if stream:
        spool_d = open(slice_base + ".profspool", "w+b")
        spool_l = open(slice_base + ".lenspool", "w+b")
    nreads = totlen = 0
    step = 1 << 14

    def _spool_cleanup():
        for f, suff in ((spool_d, ".profspool"), (spool_l, ".lenspool")):
            try:
                f.close()
            except OSError:
                pass
            try:
                os.unlink(slice_base + suff)
            except OSError:
                pass

    def run(codes, shard_size):
        key = (shard_size, cur_slack)
        if key not in fns:
            fns[key] = sharded_relative_fn(mesh, k, shard_size,
                                           slack=cur_slack,
                                           route_impl=route_impl)
        return fns[key](_local_shard_rows(codes, k, mesh, shard_size), spl,
                        t_words, t_counts)

    gen = (b for b, _ in batched_reads(my_paths, batch_bases))
    batch = next(gen, None)
    try:
        while True:
            have = 0 if batch is None else 1
            need = 0 if batch is None else max(len(batch.codes), D)
            if nprocs > 1:
                flags = _allgather(np.array([have, need], np.int64))
                if int(flags[:, 0].max()) == 0:
                    break
                need = int(flags[:, 1].max())
            elif batch is None:
                break
            shard_size = ((need + step - 1) // step) * step
            codes = (batch.codes if batch is not None
                     else np.full(16, 4, np.uint8))
            out = run(codes, shard_size)
            while int(out["route_overflow"]) > 0 and D > 1 and cur_slack < D:
                # capacity escalation (table ownership is fixed by its own
                # quantiles, so boundaries never move; slack == D always fits)
                cur_slack = min(2 * cur_slack, D)
                out = run(codes, shard_size)
            if int(out["route_overflow"]) > 0:
                raise RuntimeError("bucket capacity exceeded; raise slack")
            if batch is not None:
                pc = np.minimum(out["pos_counts"][: len(codes)].cpu().numpy()
                                .astype(np.int32), HIST_HIGH)
                if stream:
                    plen = np.maximum(np.asarray(batch.rlen) - k + 1, 0)
                    blob, offs = encode_profiles_bulk(
                        pc.astype(np.uint16), np.asarray(batch.boff)[:-1], plen)
                    np.ascontiguousarray(blob, np.uint8).tofile(spool_d)
                    np.diff(offs, prepend=0).astype("<i8").tofile(spool_l)
                else:
                    profs.extend(_profiles_from_positions(batch, pc, k))
                nreads += batch.nreads
                totlen += batch.totlen
                if verbose:
                    print(f"  sharded relative batch: {batch.nreads} reads",
                          flush=True)
            del batch, out
            batch = next(gen, None)

        if stream:
            pw = ProfWriter(slice_base, k, nreads,
                            nparts=min(out_nparts, max(1, nreads)))
            spool_d.flush()
            spool_l.flush()
            spool_d.seek(0)
            spool_l.seek(0)
            chunk = 1 << 16  # reads per replay block
            done = 0
            while done < nreads:
                lens = np.fromfile(spool_l, dtype="<i8",
                                   count=min(chunk, nreads - done))
                offs = np.cumsum(lens)
                blob = np.fromfile(spool_d, dtype=np.uint8,
                                   count=int(offs[-1]) if len(offs) else 0)
                pw.add_block(blob, offs)
                done += len(lens)
            pw.close()
            _spool_cleanup()
    except BaseException:
        if stream:
            _spool_cleanup()
        raise
    tot = _allgather(np.array([nreads, totlen], np.int64)).sum(axis=0)
    res = CountOutput(k, None, None, profs, int(tot[0]), int(tot[1]))
    res.slice_base = slice_base
    res.slice_nreads = nreads
    return res


def sharded_count(
    codes: np.ndarray,
    k: int,
    mesh: Mesh,
    splitters: Optional[np.ndarray] = None,
    want_positions: bool = False,
    slack: float = 1.8,
    route_impl: str = "auto",
    rebalance_state: Optional[dict] = None,
    auto_rebalance: bool = True,
    verbose: bool = False,
):
    """Count the canonical k-mers of one host code stream across the mesh:
    every rank passes the same stream and counts its shard.

    Returns, on every rank, (words (n,W) uint32 sorted, counts int64,
    hist_arr int64[32768], overflow int, pos_counts int32[len(codes)] or
    None).

    Adaptive rebalance: when keyspace routing overflows a chip's bucket,
    splitters retrain on THIS stream at exact word0 quantiles and the batch
    retries; a second overflow retries once more with doubled slack before
    failing. rebalance_state (a dict) carries retrained splitters to later
    batches."""
    D = mesh.size
    shard_size = (len(codes) + D - 1) // D
    step = 1 << 14
    shard_size = ((shard_size + step - 1) // step) * step

    if rebalance_state is not None and "splitters" in rebalance_state:
        splitters = rebalance_state["splitters"]
    if splitters is None:
        splitters = train_splitters(codes, k, mesh)

    fn = sharded_count_fn(mesh, k, shard_size, slack=slack,
                          want_positions=want_positions,
                          route_impl=route_impl)
    lo = mesh.rank * shard_size
    codes_dev = _local_shard_rows(codes[lo:], k, mesh, shard_size)
    out = fn(codes_dev, _spl(splitters, mesh))
    route_ovf = int(out["route_overflow"])
    if route_ovf > 0 and D > 1 and auto_rebalance:
        # retrain on the full current stream at exact word0 quantiles
        splitters = train_splitters(codes, k, mesh, sample=len(codes),
                                    exact=True)
        if rebalance_state is not None:
            rebalance_state["splitters"] = splitters
        if verbose and mesh.rank == 0:
            print(f"  route overflow ({route_ovf} records): splitters "
                  "retrained on current batch", flush=True)
        out = fn(codes_dev, _spl(splitters, mesh))
        route_ovf = int(out["route_overflow"])
    if route_ovf > 0 and D > 1 and auto_rebalance:
        fn2 = sharded_count_fn(mesh, k, shard_size, slack=min(2 * slack, D),
                               want_positions=want_positions,
                               route_impl=route_impl)
        if verbose and mesh.rank == 0:
            print("  still overflowing: retrying with doubled slack",
                  flush=True)
        out = fn2(codes_dev, _spl(splitters, mesh))
        route_ovf = int(out["route_overflow"])
    if route_ovf > 0:
        raise RuntimeError(
            f"bucket capacity exceeded by {route_ovf} records; "
            "retrain splitters or raise slack")

    # this chip's segments, gathered in rank (= key) order
    ns = int(out["nseg"])
    v = out["seg_valid"][:ns]
    rec = words_to_numpy(w[:ns][v]
                         for w in out["seg_words"] + (out["seg_counts"],))
    mine_w, mine_c = np.ascontiguousarray(rec[:-1].T), rec[-1].astype(np.int64)
    words = np.concatenate(_allgather_ragged(mine_w))
    counts = np.concatenate(_allgather_ragged(mine_c))
    hist_arr = out["hist"].cpu().numpy()
    overflow = int(out["overflow"])

    pos_counts = None
    if want_positions:
        pc = out["pos_counts"].cpu().numpy().astype(np.int32)
        pos_counts = np.concatenate(_allgather_ragged(pc))[: len(codes)]
    return words, counts, hist_arr, overflow, pos_counts
