"""Scale-out counting over the ranks of a torch.distributed world with
bounded per-rank memory (the multi-node production path).

Port of ``fastk_tpu/parallel/meshooc.py``, one card a process:

- Phase 1 (streamed lockstep rounds): every rank reads its file shard in
  batches; each batch's canonical k-mers route to their keyspace OWNER
  rank (parallel.dist.sharded_count_fn — one all_to_all), which sorts and
  per-batch-deduplicates them. Each rank spills ITS (key, count) segments
  to local disk, pre-partitioned into keyspace parts (edges trained on the
  first batch): nothing is gathered across ranks and no batch outlives its
  round, so host RSS stays O(batch).
- Phase 2 (no collectives): per part, load the spill, merge across batches
  on the device (merge_unique_blocks), accumulate the histogram, and
  stream the table slice through KtabWriter. Ranks are keyspace-ordered, so
  the ranks' slices concatenate (Fastcat-style) into the global table.
- Profiles: phase 1 also spills the owner-resident INSTANCE stream as
  (segment-index, source-position, source-rank) rows; phase 2 resolves
  every instance's count from the cross-batch merge (want_back) and buckets
  the (position, count) pairs by (source rank, batch); phase 3 walks
  batches in lockstep, delivering each batch's pairs OWNER-ADDRESSED (one
  all_to_all of [D, L, 2] row lanes a round, L at most max(256,
  slice_positions // D) rows a peer, so that a round stays within the
  slice's budget) to the rank that owns those reads, which rebuilds one
  batch's position->count buffer and streams encoded profiles
  (ProfWriter).

Outputs: with ``out_base`` each rank streams `.ktab`/`.prof` slice
file-sets (``<out>.<rank>`` in a world of more than one, ``<out>`` alone in
a world of one); `fastcat` splices them. Histograms and totals are summed
across ranks. A world of one is byte-equal to the single-card out-of-core
path.

A round's device work runs in sub-slices of at most ``slice_positions``
positions a rank (the single-card path's MAX_DEVICE_POSITIONS by default;
the CLI derives it from -M), so a rank's device peak follows its slice,
not its batch.
"""

from __future__ import annotations

import math
import os
import shutil
import sys
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fastk_tpu_torch.convert import device_codes, fetch_u16, words_to_numpy
from fastk_tpu_torch.formats.hist import HIST_HIGH, Histogram
from fastk_tpu_torch.formats.ktab import KmerTable, KtabWriter
from fastk_tpu_torch.formats.prof import ProfWriter, encode_profiles_bulk
from fastk_tpu_torch.io.reader import batched_reads
from fastk_tpu_torch.ops.count import merge_unique_blocks
from fastk_tpu_torch.ops.kmers import nwords, pad_needed
from fastk_tpu_torch.ops.tables import pad_counted
from fastk_tpu_torch.parallel.dist import (
    Mesh,
    _exchange,
    make_mesh,
    prefix_histogram,
    sharded_count_fn,
    splitters_from_prefix_hist,
)
from fastk_tpu_torch.parallel.host import _spl, _word0_sorted
from fastk_tpu_torch.parallel.multihost import (
    _allgather,
    _allgather_ragged,
    _local_shard_rows,
    mesh_timeout,
    shard_files,
)
from fastk_tpu_torch.pipeline.count import (
    MAX_DEVICE_POSITIONS,
    CountOutput,
    _profiles_from_meta,
    _table_entries,
)
from fastk_tpu_torch.pipeline.outofcore import (
    _BatchMeta,
    _PosSpill,
    _Spill,
    _load_manifest,
    _manifest_path,
    _run_signature,
    _save_manifest,
    _train_edges,
)


def default_mesh(device="cuda") -> Mesh:
    """The mesh of the whole world. Rank order is chip order and keyspace
    order, so each rank owns a contiguous keyspace range and the ranks'
    table slices concatenate in key order (the JAX package's process-major
    mesh, by construction)."""
    return make_mesh(device=device)


def _chip_maps(mesh: Mesh) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """(proc_of[chip], rank_of[chip], my_chips): the process of each chip,
    its feeding rank within that process, and this process's chips. One
    card a process: chip c is process c, fed as its rank 0."""
    return (np.arange(mesh.size, dtype=np.int32),
            np.zeros(mesh.size, np.int32), [mesh.rank])


def _gather_sum(arr: np.ndarray) -> np.ndarray:
    """Sum a fixed-shape per-rank array across ranks (identity in a world
    of one)."""
    return _allgather(arr).sum(axis=0)


def _train_mesh_splitters(codes: np.ndarray, k: int, mesh: Mesh,
                          bits: int = 10) -> np.ndarray:
    """Keyspace splitters from a CROSS-RANK sample: every rank contributes
    its first batch's prefix histogram (a 2^bits array), the sum is the
    same everywhere, and quantile edges follow."""
    D = mesh.size
    if D == 1:
        return np.zeros(0, dtype=np.uint32)
    n = min(len(codes), 1 << 20)
    size = 1 << max(15, int(np.ceil(np.log2(max(n, 2)))))
    buf = np.full(size + pad_needed(k), 4, dtype=np.uint8)
    buf[:n] = codes[:n]
    ph = prefix_histogram(device_codes(buf, mesh.device), k, size, bits)
    ph = _gather_sum(ph.cpu().numpy().astype(np.int64))
    if ph.sum() == 0:
        ph = np.ones_like(ph)
    return splitters_from_prefix_hist(ph, D)


def _retrain_exact(codes: np.ndarray, k: int, mesh: Mesh,
                   sample: int = 1 << 18) -> np.ndarray:
    """Exact-quantile splitters from a cross-rank word0 sample of the
    CURRENT batch — the route-overflow recovery. Every rank computes the
    same result from the gathered sample."""
    D = mesh.size
    mine = _word0_sorted(codes, k, sample, mesh.device)
    allw = np.concatenate(_allgather_ragged(mine.astype(np.uint32)))
    allw.sort()
    nv = len(allw)
    if nv == 0:
        return ((np.arange(1, D) * (1 << 32)) // D).astype(np.uint32)
    return allw[[min(nv - 1, nv * t // D)
                 for t in range(1, D)]].astype(np.uint32)


class _MeshWatchdog:
    """Fault containment for lockstep collectives: when a peer process
    dies, the survivors' next collective can block forever. With
    FASTK_TPU_MESH_TIMEOUT=<seconds> set, a monitor thread ends THIS rank
    with a clear message once a round makes no progress within the timeout;
    a rerun with resume=True then restarts from the last round every rank
    completed. Disabled (timeout 0) by default: legitimate giant rounds
    must not be killed by a guess."""

    EXIT_CODE = 17

    def __init__(self):
        self.timeout = mesh_timeout()
        self._last = time.monotonic()
        self._stop = False
        if self.timeout > 0:
            threading.Thread(target=self._run, daemon=True).start()

    def beat(self) -> None:
        self._last = time.monotonic()

    def _run(self) -> None:
        while not self._stop:
            time.sleep(min(1.0, self.timeout / 4))
            if self._stop:
                return
            if time.monotonic() - self._last > self.timeout:
                print(
                    f"fastk_tpu_torch mesh: no progress in "
                    f"{self.timeout:.0f}s — a peer process likely failed; "
                    "aborting this rank. Restart all ranks with resume=-R "
                    "to continue from the last completed round.",
                    file=sys.stderr, flush=True)
                os._exit(self.EXIT_CODE)

    def stop(self) -> None:
        self._stop = True


_POS_SENT = np.uint32(0xFFFFFFFF)  # padding marker in the row exchange


def _exchange_rows(mesh: Mesh, send: np.ndarray) -> np.ndarray:
    """Owner-addressed row exchange: send, uint32 [D, L, 2] — block d holds
    this rank's rows for rank d — becomes [D, L, 2] where block d holds the
    rows rank d sent here. One all_to_all on the mesh's devices."""
    t = torch.from_numpy(np.ascontiguousarray(send).view(np.int32))
    recv = _exchange(mesh, t.to(mesh.device))
    return recv.cpu().numpy().view(np.uint32)


def count_files_mesh(
    paths: Sequence[str],
    k: int,
    mesh: Optional[Mesh] = None,
    table_min: Optional[int] = None,
    profiles: bool = False,
    batch_bases: int = 64 << 20,
    slack: float = 1.8,
    sort_path: str = "/tmp",
    parts_per_chip: int = 1,
    part_cap: int = 1 << 26,
    out_base: Optional[str] = None,
    out_nparts: int = 4,
    hc: bool = False,
    bc: int = 0,
    verbose: bool = False,
    resume: bool = False,
    slice_positions: int = MAX_DEVICE_POSITIONS,
    device="cuda",
) -> CountOutput:
    """Count across the ranks with bounded per-rank memory (see module
    doc); every rank calls it with the same arguments. Returns a
    CountOutput whose hist/nreads/totlen are GLOBAL on every rank; the
    table/profiles are either streamed to `out_base` slices (table=None,
    table_entries set to the global total) or, without out_base, returned
    as THIS RANK's keyspace slice (table) and THIS RANK's reads' profiles —
    count_files_multihost concatenates them. Its mesh_stats hold the
    escalation counters, phase_s (this rank's wall seconds of phases 1-3),
    and phase 3's profile_exchange_rounds (all_to_all rounds, over all
    batches) and profile_exchange_peak_bytes (the largest send plus
    receive of one round).

    resume: keep each rank's phase-1 spill + a per-ROUND manifest on
    failure; a rerun (same inputs/config on all ranks) agrees on
    min(batches_done) across ranks, truncates every spill to that round,
    and re-enters phase 1 after it.

    device: the mesh's device when no mesh is given (default "cuda")."""
    if mesh is None:
        mesh = default_mesh(device)
    dev = mesh.device
    pid, nprocs = mesh.rank, mesh.size
    D = mesh.size
    W = nwords(k)
    proc_of, rank_of, _my = _chip_maps(mesh)
    my_paths = shard_files(paths, pid, nprocs) if nprocs > 1 else list(paths)
    wd = _MeshWatchdog()

    # shard geometry is set by the first round's cross-rank agreement and
    # grows (pow2-stepped) when a later batch outgrows it
    shard_size = 0
    step = 1 << 14

    # crash-resume state: a deterministic per-rank identity keys the
    # manifest; ranks then AGREE on min(batches_done)
    sig = _run_signature(
        list(paths), k, ("mesh", D, nprocs, parts_per_chip), table_min,
        profiles, hc, bc, batch_bases)
    base = os.path.join(sort_path, f"fastk_tpu_mesh.{sig}.{pid}")
    state = _load_manifest(base) if resume else None
    if state is not None and (state.get("sig") != sig
                              or state.get("fmt") != 2):
        state = None
    bdone = int(state["batches_done"]) if state else 0
    if resume and nprocs > 1:
        bdone = int(_allgather(np.array([bdone], np.int64)).min())
    if bdone == 0:
        state = None

    gen = (b for b in batched_reads(my_paths, batch_bases, hc=hc, bc=bc))
    first = next(gen, None)
    first_codes = (first[0].codes if first is not None
                   else np.full(1024, 4, np.uint8))
    if state is not None:
        # splitters define chip ownership of already-spilled keys and
        # MUST NOT move on resume
        splitters = np.array(state["splitters"], dtype=np.uint32)
    else:
        splitters = _train_mesh_splitters(first_codes, k, mesh)
    spl = _spl(splitters, mesh)

    cur_slack = slack
    dedup_mode = False  # flips on via the overflow-recovery ladder
    # per-rank route-buffer budget: send+recv hold ~2*(W+2) lanes of D*cap
    # slots with cap = sh//D*slack. Escalation stops at this budget; past
    # it a round splits in half (halving sh halves the bound at ANY slack)
    budget = int(os.environ.get("FASTK_TPU_ROUTE_BUDGET_MB", "4096")) << 20

    def slack_cap(sh: int) -> float:
        return max(2.0, budget / (8.0 * (W + 2) * max(sh, 1)))

    fns: dict = {}

    def get_fn(sh: int, sl: float, dd: bool):
        # cap mirrors sharded_count_fn's slot geometry: inst_slot // cap is
        # the source rank
        key = (sh, round(sl, 6), dd)
        if key not in fns:
            fns[key] = (sharded_count_fn(mesh, k, sh, slack=sl,
                                         want_inst=profiles, pre_dedup=dd),
                        int(sh // D * sl) if D > 1 else sh)
        return fns[key]

    def _round_to_D(x: int) -> int:
        # D | shard so cap == shard exactly at slack == D
        return -(-x // D) * D

    # phase-2/3 .pos state is never resumable; base dirs are wiped only
    # when starting fresh (stale leftovers of an unresumed crash)
    if os.path.isdir(base + ".pos"):
        shutil.rmtree(base + ".pos", ignore_errors=True)
    if state is None:
        for d in (base, base + ".inst"):
            if os.path.isdir(d):
                shutil.rmtree(d, ignore_errors=True)
    nparts_local = parts_per_chip
    nrec_hist: List[List[int]] = (
        [list(x) for x in state["nrec_hist"][:bdone]] if state else [])
    nvalid_hist: List[int] = (
        [int(x) for x in state["nvalid_hist"][:bdone]] if state else [])
    spill = _Spill(base, nparts_local, W,
                   resume_nrec=nrec_hist[bdone - 1] if state else None)
    # instance records: (seg_rel, batch-pos, source-rank) per row — seg
    # indexes the part's spilled unique records, so no key bytes reach
    # the host; phase 2 resolves counts from the merge itself
    if profiles and state is not None:
        # truncate the instance spill via its per-(round, count,
        # unique-offset) append metadata — entries past the agreed round
        # are dropped
        imeta = [[(int(b), int(n), int(u)) for b, n, u in lst
                  if int(b) < bdone] for lst in state["imeta"]]
        itrunc = [sum(n for _, n, _ in lst) for lst in imeta]
        ispill = _Spill(base + ".inst", nparts_local, 2,
                        resume_nrec=itrunc)
    else:
        imeta = [[] for _ in range(nparts_local)]
        ispill = (_Spill(base + ".inst", nparts_local, 2)
                  if profiles else None)
    pspill = _PosSpill(base + ".pos") if profiles else None
    # part edges, trained on the first batch's uniques of this rank
    edges: Optional[np.ndarray] = (
        np.array(state["edges"][0], dtype=np.uint32)
        if state and state["edges"][0] is not None else None)

    metas: List[_BatchMeta] = []
    nvalid_local = nvalid_hist[bdone - 1] if state else 0
    nshort = 0
    keep_spill = False
    stats = dict(max_round_records=0, total_spilled=0, retrains=0,
                 slack_escalations=0, batch_splits=0, pre_dedup=0,
                 profile_rows_returned=0, profile_rows_padded=0,
                 profile_exchange_rounds=0, profile_exchange_peak_bytes=0,
                 phase_s=[0.0, 0.0, 0.0])
    t_phase = time.perf_counter()
    if verbose and bdone:
        print(f"  mesh resume: phase 1 re-enters after round {bdone}",
              flush=True)

    def _spill_out(out, cap: int, sh: int, pos_off: int, bidx: int) -> int:
        """Spill this rank's results of one routed step; returns the record
        count. pos_off: batch-local offset of this sub-slice's code window
        (round splits feed a batch in slices)."""
        nonlocal nvalid_local, edges
        ns = int(out["nseg"])
        v = out["seg_valid"][:ns]
        rec = words_to_numpy(w[:ns][v]
                             for w in out["seg_words"] + (out["seg_counts"],))
        cw, cc = np.ascontiguousarray(rec[:-1].T), rec[-1].copy()
        nvalid_local += int(cc.astype(np.int64).sum())
        if edges is None:
            if len(cw) == 0 and parts_per_chip > 1:
                return 0  # nothing spilled yet: train on real keys
            edges = _train_edges(
                cw[:, 0] if len(cw) else np.zeros(0, np.uint32),
                parts_per_chip)
        cuts = ([0] + [int(np.searchsorted(cw[:, 0], e)) for e in edges]
                + [len(cc)])
        upre = list(spill.nrec)
        for sp in range(parts_per_chip):
            spill.append(sp, cw[cuts[sp]: cuts[sp + 1]],
                         cc[cuts[sp]: cuts[sp + 1]])
        round_rec = len(cc)
        if profiles:
            ni = int(out["n_inst"])
            # derived, not fetched: the card's instance stream is its valid
            # segments concatenated in key order
            s_seg = np.repeat(np.arange(len(cc), dtype=np.int64),
                              cc.astype(np.int64))
            islot = out["inst_slot"][:ni].cpu().numpy().astype(np.int64)
            ipos = out["inst_pos"][:ni].cpu().numpy().astype(np.int64)
            src_chip = islot // cap
            # batch-local position on the SOURCE rank: sub-slice offset +
            # its feeding rank's shard offset + local pos
            bpos = (pos_off + rank_of[src_chip].astype(np.int64) * sh
                    + ipos).astype(np.uint32)
            shost = proc_of[src_chip].astype(np.uint32)
            # an instance's segment addresses the rank's unique list, which
            # the same edges cut at `cuts`: part membership is a seg-range
            # test, no key bytes involved
            icuts = ([0] + [int(np.searchsorted(s_seg, c))
                            for c in cuts[1:-1]] + [ni])
            for sp in range(parts_per_chip):
                lo, hi = icuts[sp], icuts[sp + 1]
                if hi > lo:
                    rec2 = np.stack(
                        [(s_seg[lo:hi] - cuts[sp]).astype(np.uint32),
                         bpos[lo:hi]], axis=1)
                    ispill.append(sp, rec2, shost[lo:hi])
                    imeta[sp].append((bidx, hi - lo, upre[sp]))
            round_rec += ni
        return round_rec

    try:
        # ---- phase 1: lockstep rounds, spill owner-resident segments ----
        batch = first[0] if first is not None else None
        bidx = 0
        while True:
            wd.beat()
            if bidx < bdone:
                # round already spilled by the interrupted run: re-read the
                # batch (phase 3 needs its boff/rlen), skip all device work
                # and collectives — every rank skips the same rounds
                if batch is not None:
                    metas.append(_BatchMeta(np.asarray(batch.boff),
                                            np.asarray(batch.rlen),
                                            len(batch.codes)))
                    nshort += int((np.asarray(batch.rlen) < k).sum())
                    nxt = next(gen, None)
                    batch = nxt[0] if nxt is not None else None
                bidx += 1
                continue
            have = 0 if batch is None else 1
            # a batch can overshoot batch_bases (reads are never split):
            # agree on a shard size that fits EVERY rank's batch this round
            need = 0 if batch is None else len(batch.codes)
            if nprocs > 1:
                flags = _allgather(np.array([have, need], np.int64))
                if int(flags[:, 0].max()) == 0:
                    break
                need = int(flags[:, 1].max())
            elif batch is None:
                break
            if need > shard_size:
                shard_size = _round_to_D(max(
                    ((need + step - 1) // step) * step, 2 * shard_size))
                if verbose and pid == 0:
                    print(f"  mesh: shard geometry grown to {shard_size}",
                          flush=True)
            codes = (batch.codes if batch is not None
                     else np.full(16, 4, np.uint8))
            if batch is not None:
                metas.append(_BatchMeta(np.asarray(batch.boff),
                                        np.asarray(batch.rlen),
                                        len(batch.codes)))
                nshort += int((np.asarray(batch.rlen) < k).sum())

            # round snapshot: a split re-runs the round from scratch after
            # truncating its partial spills (all state is rank-local)
            snap = (list(spill.nrec),
                    list(ispill.nrec) if ispill is not None else None,
                    [len(lst) for lst in imeta], nvalid_local)
            nsub = max(1, -(-shard_size // slice_positions))
            sh = _round_to_D(-(-shard_size // nsub))
            while True:
                # every rank walks the SAME nsub sub-slices in lockstep
                # (short ranks feed empty tails); escalation decisions are
                # all on replicated values, so ranks branch together
                pad = pad_needed(k)
                round_rec = 0
                split_needed = False
                for j in range(nsub):
                    sub = codes[j * sh: (j + 1) * sh + pad]
                    while True:
                        fn, cap = get_fn(sh, cur_slack, dedup_mode)
                        out = fn(_local_shard_rows(sub, k, mesh, sh), spl)
                        if int(out["route_overflow"]) == 0 or D == 1:
                            break
                        if bidx == 0 and j == 0 and nsub == 1 \
                                and stats["retrains"] == 0:
                            # cross-rank exact retrain — ONLY before
                            # anything spilled: splitters define ownership
                            # of spilled keys
                            splitters = _retrain_exact(codes, k, mesh)
                            spl = _spl(splitters, mesh)
                            stats["retrains"] += 1
                            if verbose and pid == 0:
                                print("  mesh: route overflow, splitters "
                                      "retrained", flush=True)
                            continue
                        if not dedup_mode and not profiles and D > 1:
                            # count-skew recovery with no memory growth:
                            # exchange locally deduplicated (key, count)
                            # uniques; sticky for the rest of the run
                            dedup_mode = True
                            stats["pre_dedup"] = 1
                            if verbose and pid == 0:
                                print("  mesh: route overflow, local "
                                      "pre-dedup enabled", flush=True)
                            continue
                        smax = min(float(D), slack_cap(sh))
                        if cur_slack < smax:
                            # capacity escalation within the budget: at
                            # slack == D a rank holds EVERY source's full
                            # shard (cap == sh, D | sh)
                            cur_slack = min(2 * cur_slack, smax)
                            stats["slack_escalations"] += 1
                            if verbose and pid == 0:
                                print("  mesh: route overflow, slack -> "
                                      f"{cur_slack}", flush=True)
                            continue
                        split_needed = True
                        break
                    if split_needed:
                        break
                    round_rec += _spill_out(out, cap, sh, j * sh, bidx)
                    del out
                if not split_needed:
                    break
                # budget-capped and still overflowing: halve the round
                spill.truncate(snap[0])
                if ispill is not None:
                    ispill.truncate(snap[1])
                for p, ln in enumerate(snap[2]):
                    del imeta[p][ln:]
                nvalid_local = snap[3]
                nsub *= 2
                sh = _round_to_D(max(-(-shard_size // nsub), 1 << 10))
                stats["batch_splits"] += 1
                if nsub > 256:
                    raise RuntimeError(
                        "bucket capacity exceeded at minimum round size; "
                        "raise FASTK_TPU_ROUTE_BUDGET_MB or slack")
                if verbose and pid == 0:
                    print(f"  mesh: round split into {nsub} sub-slices "
                          f"(shard {sh})", flush=True)
            stats["max_round_records"] = max(stats["max_round_records"],
                                             round_rec)
            stats["total_spilled"] += round_rec
            if verbose and pid == 0:
                print(f"  mesh round {bidx + 1}: {round_rec} records "
                      "spilled", flush=True)
            if resume:
                # a round enters the manifest only after its records are
                # flushed (a SIGKILL can then never persist a manifest
                # claiming more than the files hold)
                spill.flush()
                if ispill is not None:
                    ispill.flush()
                nrec_hist.append(list(spill.nrec))
                nvalid_hist.append(nvalid_local)
                _save_manifest(base, dict(
                    sig=sig, fmt=2, batches_done=bidx + 1,
                    nrec_hist=nrec_hist, nvalid_hist=nvalid_hist,
                    imeta=imeta,
                    edges=[None if edges is None
                           else [int(x) for x in edges]],
                    splitters=[int(x) for x in splitters]))
            del batch
            nxt = next(gen, None)
            batch = nxt[0] if nxt is not None else None
            bidx += 1

        nreads = sum(m.nreads for m in metas)
        totlen = sum(m.totlen for m in metas)
        stats["phase_s"][0] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()

        # ---- phase 2: per-part device merge, stream table slice ----------
        hist_arr = np.zeros(HIST_HIGH + 1, dtype=np.int64)
        packed_parts: List[np.ndarray] = []
        count_parts: List[np.ndarray] = []
        table_entries = 0
        stream = out_base is not None
        slice_base = (out_base if (out_base is None or nprocs == 1)
                      else f"{out_base}.{pid}")
        # cap the writer's RAM spool alongside the part budget so the host
        # peak scales with part_cap, not the table size
        ktw = (KtabWriter(slice_base, k, table_min, nparts=out_nparts,
                          spill_bytes=min(
                              int(os.environ.get(
                                  "FASTK_TPU_KTAB_SPILL_MB", "1024")) << 20,
                              16 * part_cap))
               if stream and table_min is not None else None)

        def _merge_range(words, counts, rows, ipos, isrc, bcol):
            nonlocal table_entries
            nq = len(ipos) if profiles and ipos is not None else 0
            m_words, m_counts = pad_counted(words, counts, dev)
            merged = merge_unique_blocks(m_words, m_counts, want_back=nq > 0)
            del m_words, m_counts
            hist_arr[:] += merged["hist"].cpu().numpy()
            if table_min is not None:
                packed, u_counts = _table_entries(
                    k, table_min, merged["seg_words"], merged["seg_counts"],
                    int(merged["nuniq"]))
                table_entries += len(u_counts)
                if ktw is not None:
                    ktw.add(packed, u_counts)
                else:
                    packed_parts.append(packed)
                    count_parts.append(u_counts)
            if nq:
                # instance counts straight from the merge (want_back): rows
                # index the group's spilled unique records
                cnts = fetch_u16(merged["rec_counts"][: len(counts)])[rows]
                del merged
                # bucket by (source rank, batch): the _PosSpill key is
                # src * 2^32 + batch; one stable sort groups the records
                keyv = isrc.astype(np.int64) * (1 << 32) + bcol
                order = np.argsort(keyv, kind="stable")
                sk = keyv[order]
                bounds = np.concatenate(
                    [[0], np.flatnonzero(sk[1:] != sk[:-1]) + 1, [len(sk)]])
                for g in range(len(bounds) - 1):
                    lo, hi = int(bounds[g]), int(bounds[g + 1])
                    sel = order[lo:hi]
                    pspill.append(int(sk[lo]), ipos[sel], cnts[sel])

        # consecutive near-empty parts merge as one wider key range; the
        # bound covers both the unique merge and the instance join
        def _load_of(ps):
            u = sum(spill.nrec[q] for q in ps)
            i_ = (sum(ispill.nrec[q] for q in ps) if profiles else 0)
            return max(u, i_)

        groups: List[List[int]] = []
        for p in range(nparts_local):
            if groups and _load_of(groups[-1] + [p]) <= part_cap:
                groups[-1].append(p)
            else:
                groups.append([p])
        if verbose and len(groups) < nparts_local:
            print(f"  mesh: {nparts_local} parts consolidated into "
                  f"{len(groups)} merges", flush=True)

        for grp in groups:
            wd.beat()
            p = grp[0]
            loads = [spill.load(q) for q in grp]
            words = np.concatenate([w for w, _ in loads])
            counts = np.concatenate([c for _, c in loads])
            del loads
            if profiles:
                pbase = np.cumsum([0] + [spill.nrec[q] for q in grp[:-1]])
                rows_parts = []
                isrc_parts = []
                for j, q in enumerate(grp):
                    rec2, sc = ispill.load(q)
                    uoffs = np.repeat(
                        np.array([u for _, _, u in imeta[q]], np.int64),
                        [n_ for _, n_, _ in imeta[q]])
                    rows_parts.append(
                        (int(pbase[j]) + uoffs + rec2[:, 0],
                         rec2[:, 1].astype(np.int64)))
                    isrc_parts.append(sc)
                rows = np.concatenate([r for r, _ in rows_parts])
                ipos = np.concatenate([p_ for _, p_ in rows_parts])
                isrc = np.concatenate(isrc_parts)
                del rows_parts, isrc_parts
                bcol = np.concatenate([np.repeat(
                    np.array([b for b, _, _ in imeta[q]], np.int64),
                    [n for _, n, _ in imeta[q]]) for q in grp])
            else:
                rows = ipos = isrc = bcol = None
            n = len(counts)
            load = max(n, len(ipos) if profiles else 0)
            if load <= part_cap:
                _merge_range(words, counts, rows, ipos, isrc, bcol)
                continue
            # sub-split at word0 quantiles (skew backstop; equal keys share
            # word0, so sub-ranges still partition)
            nsub = math.ceil(load / part_cap)
            rng = np.random.default_rng(0)
            sample = words[rng.integers(0, n, min(n, 1 << 20)), 0]
            sample.sort()
            vals = np.unique(np.array(
                [sample[len(sample) * t // nsub] for t in range(1, nsub)],
                dtype=np.uint32))
            if verbose:
                print(f"  mesh part {p}: {n} records, sub-split into "
                      f"{len(vals) + 1} ranges", flush=True)
            bounds = [None, *vals.tolist(), None]
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                m = np.ones(n, dtype=bool)
                if lo is not None:
                    m &= words[:, 0] >= lo
                if hi is not None:
                    m &= words[:, 0] < hi
                if profiles:
                    # an instance belongs to its unique record's sub-range;
                    # rows remap to the filtered array
                    mi = m[rows]
                    remap = np.cumsum(m) - 1
                    _merge_range(words[m], counts[m], remap[rows[mi]],
                                 ipos[mi], isrc[mi], bcol[mi])
                else:
                    _merge_range(words[m], counts[m], None, None, None, None)
            del words, counts, rows, ipos, isrc, bcol

        if ktw is not None:
            ktw.close()
            ktw = None

        # global histogram + totals: the only cross-rank reductions
        hist_arr = _gather_sum(hist_arr)
        tot = _gather_sum(np.array(
            [nvalid_local, nreads, totlen, nshort, table_entries], np.int64))
        nvalid_g, nreads_g, totlen_g, nshort_g, entries_g = (
            int(x) for x in tot)
        overflow = nvalid_g - int(
            (hist_arr[1:] * np.arange(1, HIST_HIGH + 1, dtype=np.int64)).sum())
        hist = Histogram.from_bins(k, hist_arr, overflow)

        table = None
        if table_min is not None and not stream:
            table = KmerTable(
                k, table_min,
                np.concatenate(packed_parts) if packed_parts
                else np.zeros((0, (k + 3) // 4), np.uint8),
                np.concatenate(count_parts) if count_parts
                else np.zeros(0, np.uint16))

        stats["phase_s"][1] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()

        # ---- phase 3: profiles back to their reads, per batch ------------
        profs = None
        pw = None
        if profiles:
            nb = len(metas)
            if nprocs > 1:
                nb = int(_allgather(np.array([nb], np.int64)).max())
            # a round's lanes hold at most `chunk` rows a peer: send and
            # receive 2 x D x chunk x 8 B = 16 B a slice position
            chunk = max(256, slice_positions // D)
            if stream:
                pw = ProfWriter(slice_base, k, nreads,
                                nparts=min(out_nparts, max(1, nreads)))
            else:
                profs = []
            for b in range(nb):
                wd.beat()
                # rows destined for each rank, from MY card's joins
                parcels = [pspill.load(q * (1 << 32) + b)
                           for q in range(nprocs)]
                meta = metas[b] if b < len(metas) else None
                buf = (np.zeros(meta.codes_len, dtype=np.uint16)
                       if meta is not None else None)
                if nprocs == 1:
                    pos64, cnt16 = parcels[0]
                    buf[pos64] = cnt16
                else:
                    # OWNER-ADDRESSED exchange in rounds: each all_to_all
                    # delivers at most L of the rows a rank owns to it from
                    # each peer (L the pow2 of the largest peer's rows, at
                    # most `chunk`), padding sentinel-marked; every rank
                    # runs the rounds agreed from the largest lane, and
                    # scatters each round's rows as they arrive
                    lane_need = max(len(p_[0]) for p_ in parcels)
                    lane_need = int(_allgather(
                        np.array([lane_need], np.int64)).max())
                    L = min(chunk, max(256, 1 << int(np.ceil(np.log2(
                        max(lane_need, 1))))))
                    rounds = -(-lane_need // L)
                    for r in range(rounds):
                        send = np.full((D, L, 2), _POS_SENT, dtype=np.uint32)
                        for q in range(nprocs):
                            pos64, cnt16 = parcels[q]
                            pos64 = pos64[r * L: (r + 1) * L]
                            send[q, : len(pos64), 0] = pos64
                            send[q, : len(pos64), 1] = cnt16[r * L:
                                                             (r + 1) * L]
                        rows = _exchange_rows(mesh, send).reshape(-1, 2)
                        rows = rows[rows[:, 0] != _POS_SENT]
                        if buf is not None:
                            buf[rows[:, 0]] = rows[:, 1].astype(np.uint16)
                        stats["profile_rows_returned"] += len(rows)
                        stats["profile_exchange_peak_bytes"] = max(
                            stats["profile_exchange_peak_bytes"],
                            2 * send.nbytes)
                    stats["profile_rows_padded"] += D * L * rounds
                    stats["profile_exchange_rounds"] += rounds
                if meta is not None:
                    if pw is not None:
                        plen = np.maximum(meta.rlen - k + 1, 0)
                        blob, offs = encode_profiles_bulk(
                            buf, meta.boff[:-1], plen)
                        pw.add_block(blob, offs)
                    else:
                        profs.extend(_profiles_from_meta(
                            meta.boff, meta.rlen, buf, k))
            if pw is not None:
                pw.close()
                pw = None

        stats["phase_s"][2] = time.perf_counter() - t_phase
        out = CountOutput(k, hist, table, profs, nreads_g, totlen_g,
                          nshort=nshort_g)
        out.table_entries = entries_g if table_min is not None else None
        out.slice_base = slice_base
        out.mesh_stats = stats
        return out
    except BaseException:
        # with resume on, this rank's spill + manifest survive for a rerun
        keep_spill = resume
        raise
    finally:
        wd.stop()
        spill.close(remove=not keep_spill)
        if ispill is not None:
            ispill.close(remove=not keep_spill)
        if pspill is not None:
            pspill.close()  # phase-3 spill is never resumed from
        if not keep_spill:
            try:
                os.unlink(_manifest_path(base))
            except OSError:
                pass
        for d in (base, base + ".inst", base + ".pos"):
            try:
                os.rmdir(d)
            except OSError:
                pass
