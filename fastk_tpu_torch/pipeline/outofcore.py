"""Out-of-core counting: inputs whose unique k-mers do not fit the device.

Port of ``fastk_tpu/pipeline/outofcore.py``, with its on-disk layout and its
results. The JAX-free host helpers of that module (the edge trainer, the
spills, the run signature and the resume manifest) are copied here, because
the JAX module imports ``jax.numpy`` and the machine with the card has no
JAX.

1. The canonical keyspace is range-partitioned into `parts` intervals of
   word0, with edges trained on the first slice's uniques.
2. Each device slice is deduplicated on the device (``unique_batch``), and
   only its (key, count) records cross to the host and spill, by key range,
   as (W uint32 words, uint32 count) records.
3. Each part (or a group of near-empty parts, or a word0 sub-range of an
   overflowing one) is merged on the device (``merge_unique_blocks``); the
   histograms add up and the table slices, in keyspace order, concatenate
   into the table (a streamed ``KtabWriter`` with ``out_base``).
4. Profiles: phase 1's sort also carries positions (``unique_batch_inst``)
   and each instance spills as (segment index in its part, position). The
   part merge returns each spilled record's merged count (``want_back``),
   so each instance's count is a host gather; the (position, count) pairs
   spill per batch, and phase 3 rebuilds one batch at a time in read order.

Host memory stays bounded by one batch and one part. Phase 1 keeps one slice
of lookahead: slice i+1 is queued on the device before slice i's records
are fetched (on a side stream, so the fetch does not wait for slice i+1) and
spilled.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fastk_tpu_torch.formats.hist import HIST_HIGH, Histogram
from fastk_tpu_torch.formats.ktab import KmerTable, KtabWriter
from fastk_tpu_torch.formats.prof import ProfWriter, encode_profiles_bulk
from fastk_tpu_torch.io.reader import batched_reads
from fastk_tpu_torch.convert import (
    device_codes,
    fence,
    fetch,
    fetch_async,
    fetch_u16,
    words_to_numpy_async,
)
from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.count import (
    merge_unique_blocks,
    unique_batch,
    unique_batch_inst,
)
from fastk_tpu_torch.ops.kmers import nwords
from fastk_tpu_torch.ops.tables import pad_counted
from fastk_tpu_torch.pipeline.count import (
    MAX_DEVICE_POSITIONS,
    CountOutput,
    _code_slices,
    _profiles_from_meta,
    _table_entries,
)


def _train_edges(words0: np.ndarray, parts: int) -> np.ndarray:
    """Upper-bound edges (exclusive) on word0 for each part but the last,
    chosen at quantiles of the first batch's uniques."""
    if parts <= 1:
        return np.zeros(0, dtype=np.uint32)
    if len(words0) == 0:
        return ((np.arange(1, parts) * (1 << 32)) // parts).astype(np.uint32)
    qs = [words0[min(len(words0) - 1, len(words0) * t // parts)]
          for t in range(1, parts)]
    return np.array(qs, dtype=np.uint32)


@dataclass
class _BatchMeta:
    """Per-batch read layout kept after the codes are dropped: a few bytes
    per read."""

    boff: np.ndarray  # int64 [nreads+1] code offsets
    rlen: np.ndarray  # int64 [nreads]
    codes_len: int

    @property
    def nreads(self) -> int:
        return len(self.rlen)

    @property
    def totlen(self) -> int:
        return int(self.rlen.sum())


class _Spill:
    """Per-part append-only spill of (W words, count) uint32 records.

    resume_nrec: per-part record counts from a prior run's manifest; files
    are truncated to exactly those counts (dropping any partially-written
    batch) and opened for append."""

    def __init__(self, dirpath: str, parts: int, W: int,
                 resume_nrec: Optional[List[int]] = None):
        os.makedirs(dirpath, exist_ok=True)
        self.W = W
        self.paths = [os.path.join(dirpath, f"part{p}.spill")
                      for p in range(parts)]
        if resume_nrec is not None:
            rb = 4 * (W + 1)
            for p, nr in zip(self.paths, resume_nrec):
                with open(p, "ab"):
                    pass  # ensure it exists
                os.truncate(p, nr * rb)
            self.files = [open(p, "ab") for p in self.paths]
            self.nrec = list(resume_nrec)
            return
        self.files = [open(p, "wb") for p in self.paths]
        self.nrec = [0] * parts

    def append(self, p: int, words: np.ndarray, counts: np.ndarray) -> None:
        n = len(counts)
        if n == 0:
            return
        rec = np.empty((n, self.W + 1), dtype=np.uint32)
        rec[:, : self.W] = words
        rec[:, self.W] = counts
        rec.tofile(self.files[p])
        self.nrec[p] += n

    def flush(self) -> None:
        """Push buffered records to the OS; called before each manifest save
        so that a kill never leaves a manifest claiming more records than
        the spill files hold."""
        for f in self.files:
            f.flush()

    def truncate(self, nrec: List[int]) -> None:
        """Roll every part back to an exact record count (a failed mesh
        round re-runs after truncating its partial spills)."""
        rb = 4 * (self.W + 1)
        for p, nr in enumerate(nrec):
            self.files[p].flush()
            os.truncate(self.paths[p], nr * rb)
            self.files[p].seek(nr * rb)
            self.nrec[p] = nr

    def load(self, p: int) -> Tuple[np.ndarray, np.ndarray]:
        self.files[p].flush()
        rec = np.fromfile(self.paths[p], dtype=np.uint32
                          ).reshape(self.nrec[p], self.W + 1)
        return rec[:, : self.W], rec[:, self.W]

    def close(self, remove: bool = True) -> None:
        for f in self.files:
            f.close()
        if remove:
            for p in self.paths:
                try:
                    os.unlink(p)
                except OSError:
                    pass


class _PosSpill:
    """Per-batch append-only spill of (position, count) pairs: the profile
    values on their way back to read order, 3 little-endian uint16 each
    (positions are batch-local)."""

    def __init__(self, dirpath: str):
        os.makedirs(dirpath, exist_ok=True)
        self.dir = dirpath
        self.nrec: dict[int, int] = {}

    def _path(self, b: int) -> str:
        return os.path.join(self.dir, f"batch{b}.pos")

    def append(self, b: int, pos: np.ndarray, cnt: np.ndarray) -> None:
        n = len(pos)
        if n == 0:
            return
        rec = np.empty((n, 3), dtype="<u2")
        rec[:, :2] = pos.astype("<u4").view("<u2").reshape(n, 2)
        rec[:, 2] = cnt.astype("<u2")
        with open(self._path(b), "ab") as f:
            rec.tofile(f)
        self.nrec[b] = self.nrec.get(b, 0) + n

    def load(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        n = self.nrec.get(b, 0)
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.uint16)
        rec = np.fromfile(self._path(b), dtype="<u2").reshape(n, 3)
        pos = np.ascontiguousarray(rec[:, :2]).view("<u4").ravel()
        return pos.astype(np.int64), rec[:, 2].astype(np.uint16)

    def close(self) -> None:
        for b in self.nrec:
            try:
                os.unlink(self._path(b))
            except OSError:
                pass


def _run_signature(paths, k, parts, table_min, profiles, hc, bc,
                   batch_bases) -> str:
    """Identity of a run: the same inputs (path, size, mtime) and the same
    configuration; the key under which a killed run resumes."""
    ident = []
    for p in paths:
        st = os.stat(p)
        ident.append((os.path.abspath(p), st.st_size, int(st.st_mtime)))
    blob = repr((ident, k, parts, table_min, profiles, hc, bc, batch_bases))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def _manifest_path(base: str) -> str:
    return os.path.join(base, "manifest.json")


def _save_manifest(base: str, state: dict) -> None:
    tmp = _manifest_path(base) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, _manifest_path(base))  # atomic: a torn write never wins


def _load_manifest(base: str) -> Optional[dict]:
    try:
        with open(_manifest_path(base)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _start_fetch(res: dict, profiles: bool, side):
    """Start moving one device slice's results to the host without waiting
    for device work queued after them. Returns a callable that waits and
    gives (nuniq, nvalid, words uint32 (nuniq, W), counts uint32 [nuniq],
    positions uint32 [nvalid] or None).

    The counts come first (the wait later); the records (the words and
    counts) and the positions then copy on the side stream `side`, fenced
    after the slice's work, so the copy overlaps the next slice's work.
    Traced: the waits later, slice_records and slice_positions."""
    nuniq = fetch_async(res["nuniq"], "later")
    nvalid = fetch_async(res["nvalid"], "later")
    after_slice = fence(side)

    def wait():
        nu, nval = int(nuniq()), int(nvalid())
        after_slice()
        rec = words_to_numpy_async(res["seg_words"] + (res["seg_counts"],),
                                   nu, "slice_records", side)
        pos = (words_to_numpy_async((res["s_pos"],), nval,
                                    "slice_positions", side)
               if profiles else None)
        rec = rec()
        return (nu, nval, np.ascontiguousarray(rec[:-1].T), rec[-1].copy(),
                pos()[0].copy() if profiles else None)

    return wait


def count_files_ooc(
    paths: Sequence[str],
    k: int,
    parts: Optional[int],
    sort_path: str = "/tmp",
    table_min: Optional[int] = None,
    profiles: bool = False,
    hc: bool = False,
    bc: int = 0,
    batch_bases: int = 64 << 20,
    verbose: bool = False,
    out_base: Optional[str] = None,
    out_nparts: int = 4,
    part_cap: int = 1 << 26,
    resume: bool = False,
    est_bases: Optional[int] = None,
    slice_positions: int = MAX_DEVICE_POSITIONS,
    device="cuda",
) -> CountOutput:
    """Bounded-memory counting through `parts` disk buckets (the -M path).

    With ``out_base`` the .ktab (if table_min) and .prof (if profiles)
    file-sets are streamed to disk as they are produced; the returned
    CountOutput then has table=None, profiles=None and table_entries set.

    parts=None sizes the plan from the first slice's measured dedup ratio
    (uniques / valid instances) times est_bases: parts = ceil(est * ratio *
    1.25 / part_cap), at least ceil(est / part_cap) with profiles (the
    instance spill is not deduplicated). Phase 2 consolidates consecutive
    near-empty parts into one device merge and sub-splits a part above
    part_cap records at word0 quantiles.

    resume: on failure keep the phase-1 spill and a batch-granular manifest;
    a rerun with the same inputs and configuration re-enters phase 1 after
    the last completed batch.

    slice_positions: the most positions of one device slice in phase 1,
    whose dedup sets the job's device peak (the CLI derives it from -M).

    device: where the merges run (default ``"cuda"``; raises without a
    card)."""
    dev = resolve_device(device)
    side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
    W = nwords(k)
    sig = _run_signature(paths, k, "auto" if parts is None else parts,
                         table_min, profiles, hc, bc, batch_bases)
    base = os.path.join(sort_path, f"fastk_tpu_ooc.{sig}")
    state = _load_manifest(base) if resume else None
    if state is not None and (state.get("sig") != sig
                              or state.get("fmt") != 2):
        # fmt 2: the instance spill is (seg_rel, pos) with (bidx, n, uoff)
        # imeta triples; older manifests are not resumable
        state = None
    if state is not None and parts is None:
        parts = state.get("parts")  # resolved by the interrupted run
    # phase-2 .pos state is never resumable: clear it even when resuming
    if os.path.isdir(base + ".pos"):
        shutil.rmtree(base + ".pos", ignore_errors=True)
    if state is None:
        for d in (base, base + ".inst"):
            if os.path.isdir(d):  # leftovers of a killed run
                shutil.rmtree(d, ignore_errors=True)
    bdone = state["batches_done"] if state else 0
    if verbose and bdone:
        print(f"  resume: phase 1 re-enters after batch {bdone}",
              flush=True)
    # with parts=None the spills are created on the first slice, once the
    # measured ratio fixes the plan
    spill: Optional[_Spill] = None
    ispill: Optional[_Spill] = None
    imeta: List[List[Tuple[int, int, int]]] = []
    if parts is not None:
        spill = _Spill(base, parts, W,
                       resume_nrec=state["nrec"] if state else None)
        ispill = (_Spill(base + ".inst", parts, 1,
                         resume_nrec=state["inrec"] if state else None)
                  if profiles else None)
        imeta = ([[tuple(x) for x in lst] for lst in state["imeta"]]
                 if state else [[] for _ in range(parts)])
    pspill = _PosSpill(base + ".pos") if profiles else None
    edges: Optional[np.ndarray] = (
        np.array(state["edges"], dtype=np.uint32) if state else None)
    metas: List[_BatchMeta] = []
    nvalid_total = state["nvalid"] if state else 0
    stream = out_base is not None
    keep_spill = False

    try:
        # ---- phase 1: per-slice device dedup, spilled by key range --------
        def _spill_one(slice_fetch, label, batch_complete: bool):
            nonlocal nvalid_total, edges, parts, spill, ispill, imeta
            bidx, nreads, off = label
            nu, nval, words, counts, s_pos = slice_fetch()
            nvalid_total += nval
            if parts is None:
                # measured plan: est_bases x (first-slice uniques / valid
                # instances), with 25% headroom for cross-batch novelty
                ratio = nu / max(nval, 1)
                est = max(est_bases or 0, nval)
                want = math.ceil(est * ratio * 1.25 / part_cap)
                if profiles:
                    # the instance spill holds one record per valid
                    # position, so parts bound instances too
                    want = max(want, math.ceil(est / part_cap))
                parts = max(2, min(4096, want))
                if verbose:
                    print(f"  measured dedup ratio {ratio:.3f}: planning "
                          f"{parts} parts", flush=True)
            if spill is None:
                spill = _Spill(base, parts, W)
                if profiles:
                    ispill = _Spill(base + ".inst", parts, 1)
                imeta = [[] for _ in range(parts)]
            if edges is None:
                edges = _train_edges(words[:, 0], parts)
            cuts = ([0] + [int(np.searchsorted(words[:, 0], e))
                           for e in edges] + [nu])
            upre = list(spill.nrec)  # per-part unique offsets before this
            for p in range(parts):
                spill.append(p, words[cuts[p]: cuts[p + 1]],
                             counts[cuts[p]: cuts[p + 1]])
            if profiles:
                # valid instances lead the sorted stream; the stream is the
                # segments in key order, so repeat(arange(nu), counts) is
                # each instance's segment: only positions cross the link.
                # An instance spills as (segment index within its part's
                # chunk, batch-local position); imeta records the chunk's
                # offset in the part (upre[p])
                s_seg = np.repeat(np.arange(nu, dtype=np.int64),
                                  counts.astype(np.int64))
                ipos = s_pos + np.uint32(off)
                icuts = ([0] + [int(np.searchsorted(s_seg, c))
                                for c in cuts[1:-1]] + [nval])
                for p in range(parts):
                    lo, hi = icuts[p], icuts[p + 1]
                    if hi > lo:
                        ispill.append(
                            p,
                            (s_seg[lo:hi] - cuts[p]).astype(
                                np.uint32)[:, None],
                            ipos[lo:hi])
                        imeta[p].append((bidx, hi - lo, upre[p]))
            if verbose:
                print(f"  batch {bidx + 1}: {nreads} reads, "
                      f"{nu} uniques spilled", flush=True)
            if resume and batch_complete:
                # only a fully spilled batch enters the manifest (a large
                # batch runs in several slices sharing one bidx), and only
                # after its records are flushed
                spill.flush()
                if ispill is not None:
                    ispill.flush()
                _save_manifest(base, dict(
                    sig=sig, fmt=2, batches_done=bidx + 1, nrec=spill.nrec,
                    inrec=ispill.nrec if ispill is not None else None,
                    imeta=imeta, nvalid=nvalid_total, parts=parts,
                    edges=[int(x) for x in edges]))

        pending = None
        for batch, _ord in batched_reads(list(paths), batch_bases,
                                         hc=hc, bc=bc):
            metas.append(_BatchMeta(np.asarray(batch.boff),
                                    np.asarray(batch.rlen),
                                    len(batch.codes)))
            if len(metas) - 1 < bdone:
                del batch  # spilled by the interrupted run
                continue
            for off, size, buf in _code_slices(batch.codes, k,
                                               slice_positions):
                codes = device_codes(buf, dev)
                if profiles:
                    res = unique_batch_inst(codes, k, size)
                    del res["s_words"]
                else:
                    res = unique_batch(codes, k, size)
                del codes
                slice_fetch = _start_fetch(res, profiles, side)
                del res
                label = (len(metas) - 1, metas[-1].nreads, off)
                if pending is not None:
                    # the pending slice completed its batch iff the slice
                    # just queued belongs to a later batch
                    _spill_one(*pending,
                               batch_complete=pending[1][0] != label[0])
                pending = (slice_fetch, label)
                del slice_fetch
            del batch  # codes must not outlive phase 1
        if pending is not None:
            _spill_one(*pending, batch_complete=True)
            pending = None
        if spill is None:  # empty input: no slice resolved the plan
            parts = parts or 2
            spill = _Spill(base, parts, W)
            if profiles:
                ispill = _Spill(base + ".inst", parts, 1)
            imeta = [[] for _ in range(parts)]

        nreads = sum(m.nreads for m in metas)
        totlen = sum(m.totlen for m in metas)

        if verbose and sum(spill.nrec):
            tot = sum(spill.nrec)
            avg = tot / parts
            print("  part balance: " + " ".join(
                f"{100.0 * n / tot:.1f}%" for n in spill.nrec), flush=True)
            print(f"  part skew: max {max(spill.nrec) / avg:.2f}x avg, "
                  f"min {min(spill.nrec) / avg:.2f}x avg", flush=True)

        # ---- phase 2: per-part device merge -------------------------------
        hist_arr = np.zeros(HIST_HIGH + 1, dtype=np.int64)
        packed_parts: List[np.ndarray] = []
        count_parts: List[np.ndarray] = []
        ktw = None
        table_entries = 0
        if stream and table_min is not None:
            # the writer's RAM spool is capped beside the part budget, so
            # the host peak scales with -M, not with the table
            ktw = KtabWriter(out_base, k, table_min, nparts=out_nparts,
                             spill_bytes=min(
                                 int(os.environ.get(
                                     "FASTK_TPU_KTAB_SPILL_MB", "1024"))
                                 << 20,
                                 16 * part_cap))

        def _merge_range(words, counts, rows, ipos, bcol):
            nonlocal table_entries
            nq = len(ipos) if profiles and ipos is not None else 0
            m_words, m_counts = pad_counted(words, counts, dev)
            merged = merge_unique_blocks(m_words, m_counts, want_back=nq > 0)
            del m_words, m_counts
            hist_arr[:] += fetch(merged["hist"], "part_hist")
            if table_min is not None:
                packed, u_counts = _table_entries(
                    k, table_min, merged["seg_words"], merged["seg_counts"],
                    int(fetch(merged["nuniq"], "part_nuniq")))
                table_entries += len(u_counts)
                if ktw is not None:
                    ktw.add(packed, u_counts)
                else:
                    packed_parts.append(packed)
                    count_parts.append(u_counts)
            if nq:
                # each spilled record's merged count, gathered by the
                # instances' rows and sent back to their batches
                cnts = fetch_u16(merged["rec_counts"][: len(counts)])[rows]
                del merged
                for b in np.unique(bcol):
                    m = bcol == b
                    pspill.append(int(b), ipos[m], cnts[m])

        # consecutive near-empty parts merge as one wider key range; with
        # profiles both the unique and the instance load are bounded
        def _load_of(ps):
            u = sum(spill.nrec[q] for q in ps)
            i_ = (sum(ispill.nrec[q] for q in ps) if profiles else 0)
            return max(u, i_)

        groups: List[List[int]] = []
        for p in range(parts):
            if groups and _load_of(groups[-1] + [p]) <= part_cap:
                groups[-1].append(p)
            else:
                groups.append([p])
        if verbose and len(groups) < parts:
            print(f"  {parts} parts consolidated into {len(groups)} "
                  "merges", flush=True)

        for grp in groups:
            loads = [spill.load(p) for p in grp]
            words = np.concatenate([w for w, _ in loads])
            counts = np.concatenate([c for _, c in loads])
            del loads
            if profiles:
                # absolute unique-record row of each instance within the
                # group's concatenated spill: part base + the chunk's
                # offset (imeta) + the spilled seg_rel
                pbase = np.cumsum([0] + [spill.nrec[q] for q in grp[:-1]])
                rows_parts = []
                for j, q in enumerate(grp):
                    srel, ip = ispill.load(q)
                    uoffs = np.repeat(
                        np.array([u for _, _, u in imeta[q]], np.int64),
                        [n_ for _, n_, _ in imeta[q]])
                    rows_parts.append(
                        (int(pbase[j]) + uoffs + srel[:, 0], ip))
                rows = np.concatenate([r for r, _ in rows_parts])
                ipos = np.concatenate([p_ for _, p_ in rows_parts])
                del rows_parts
                bcol = np.concatenate([np.repeat(
                    np.array([b for b, _, _ in imeta[p]], np.int64),
                    [cnt_n for _, cnt_n, _ in imeta[p]]) for p in grp])
            else:
                rows = ipos = bcol = None
            n = len(counts)
            load = max(n, len(ipos) if profiles else 0)
            p = grp[0]
            if load <= part_cap:
                if verbose:
                    print(f"  part {p + 1}/{parts}"
                          + (f" (+{len(grp) - 1})" if len(grp) > 1 else "")
                          + f": {n} records", flush=True)
                _merge_range(words, counts, rows, ipos, bcol)
                continue
            # an overflowing part is sub-split at word0 quantiles (equal
            # keys share word0, so the sub-ranges still partition the
            # keyspace in order); no spilled record moves
            nsub = math.ceil(load / part_cap)
            rng = np.random.default_rng(0)
            sample = words[rng.integers(0, n, min(n, 1 << 20)), 0]
            sample.sort()
            vals = np.unique(np.array(
                [sample[len(sample) * t // nsub] for t in range(1, nsub)],
                dtype=np.uint32))
            if verbose:
                print(f"  part {p + 1}/{parts}: {n} records, sub-split "
                      f"into {len(vals) + 1} ranges", flush=True)
            bounds = [None, *vals.tolist(), None]
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                m = np.ones(n, dtype=bool)
                if lo is not None:
                    m &= words[:, 0] >= lo
                if hi is not None:
                    m &= words[:, 0] < hi
                if profiles:
                    # an instance follows its unique record; rows remap to
                    # the filtered array
                    mi = m[rows]
                    remap = np.cumsum(m) - 1
                    _merge_range(words[m], counts[m], remap[rows[mi]],
                                 ipos[mi], bcol[mi])
                else:
                    _merge_range(words[m], counts[m], None, None, None)
            del words, counts, rows, ipos, bcol

        overflow = nvalid_total - int(
            (hist_arr[1:] * np.arange(1, HIST_HIGH + 1, dtype=np.int64)).sum())
        hist = Histogram.from_bins(k, hist_arr, overflow)

        table = None
        if table_min is not None:
            if ktw is not None:
                ktw.close()
                ktw = None
            else:
                table = KmerTable(k, table_min, np.concatenate(packed_parts),
                                  np.concatenate(count_parts))
                table_entries = len(table)

        # ---- phase 3: profiles back to read order, one batch at a time ----
        profs = None
        if profiles:
            pw = None
            if stream:
                pw = ProfWriter(out_base, k, nreads,
                                nparts=min(out_nparts, max(1, nreads)))
            else:
                profs = []
            for b, meta in enumerate(metas):
                buf = np.zeros(meta.codes_len, dtype=np.uint16)
                pos, cnt = pspill.load(b)
                buf[pos] = cnt
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
        out = CountOutput(k, hist, table, profs, nreads, totlen,
                          nshort=sum(int((m.rlen < k).sum()) for m in metas))
        out.table_entries = table_entries if table_min is not None else None
        return out
    except BaseException:
        # with resume on, the spill and the manifest survive for a rerun
        keep_spill = resume
        raise
    finally:
        if spill is not None:
            spill.close(remove=not keep_spill)
        if ispill is not None:
            ispill.close(remove=not keep_spill)
        if pspill is not None:
            pspill.close()  # the phase-3 spill is never resumed from
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
