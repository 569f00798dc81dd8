"""Multi-device k-mer counting over torch.distributed: each rank's card owns
one keyspace range.

Port of ``fastk_tpu/parallel/dist.py``, with its design:

- Reads are data-parallel: each rank gets a shard of the code stream.
- The canonical keyspace is RANGE-partitioned across ranks, so every
  instance of a k-mer lands on one card: per-card segment counts are
  globally exact, and the per-card sorted uniques concatenate in rank order
  into the sorted table.
- The exchange is one ``all_to_all_single`` of equal [D, cap] blocks; the
  histogram and the overflow counts are one ``all_reduce``; profile counts
  return to their source rank by the inverse ``all_to_all_single``.
- Range splitters are trained on a first-batch prefix histogram.

The JAX package's ``shard_map`` over a mesh of D chips becomes a step that
every rank runs on its own shard (SPMD): a :class:`Mesh` is the world of
torch.distributed processes, one card each, D = the world size, and this
card's chip index is its rank. The all_to_all runs in the world's group
(NCCL on cards, gloo on the CPU). Records are placed into their send slots
by one ``index_put_`` (the TPU's sort-based placement is not needed on a
card; ``route_impl`` keeps both of its values, which give the same
buffers), and the send buffers travel as one int64 tensor of lanes. Within
a destination block records keep their position order.

Routing capacity: each rank sends cap = shard_size // D * slack slots per
destination; records beyond it are counted in ``route_overflow``, which the
callers check (retrain splitters, raise slack) before they use a result.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from fastk_tpu_torch.ops.count import (
    _join_counts,
    fold_invalid,
    positions_inverse,
    segmented_count,
    sort_keys,
)
from fastk_tpu_torch.ops.kmers import canonical_kmers, pad_needed


class Mesh:
    """The ranks of a torch.distributed world, one card each: ``size`` (D)
    is the world size, ``rank`` this process's chip index, ``device`` its
    card (or the CPU). ``group`` carries the device exchange and
    ``host_group`` (gloo) the host arrays; both are None in a world of one
    that no process group joins."""

    def __init__(self, device: torch.device, group=None, host_group=None):
        self.device = device
        self.group = group
        self.host_group = host_group
        if group is None:
            self.size, self.rank = 1, 0
        else:
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            want = "nccl" if device.type == "cuda" else "gloo"
            if dist.get_backend(group) != want:
                raise ValueError(
                    f"a mesh on {device} needs a {want} process group, "
                    f"not {dist.get_backend(group)}")


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh of the current torch.distributed world (a world of one
    outside any). n_devices, when given, must be the world size: one
    process drives one card."""
    from fastk_tpu_torch.parallel.multihost import groups, rank_device

    group, host = groups()
    size = dist.get_world_size() if group is not None else 1
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices needs a "
                         f"torch.distributed world of {n_devices} processes "
                         f"(this one has {size})")
    rank = dist.get_rank() if group is not None else 0
    return Mesh(rank_device(device, rank), group, host)


def default_splitters(ndev: int) -> np.ndarray:
    """Uniform split of the 32-bit word0 space (upper bounds per chip).

    Canonical keys are skewed toward the lower half (min(fwd, rc)), so train
    splitters with prefix_histogram for real runs.
    """
    edges = (np.arange(1, ndev) * (1 << 32) // ndev).astype(np.uint32)
    return edges


def splitters_from_prefix_hist(prefix_hist: np.ndarray, ndev: int) -> np.ndarray:
    """Quantile splitters (upper bounds, exclusive, on word0) from a 2^B-bin
    histogram of word0 top bits (the trainer analog of assign_pieces,
    split.c:289-381)."""
    B = int(np.log2(len(prefix_hist)))
    c = np.cumsum(prefix_hist.astype(np.float64))
    total = c[-1] if c[-1] > 0 else 1.0
    edges = []
    for t in range(1, ndev):
        target = total * t / ndev
        b = int(np.searchsorted(c, target))
        edges.append(min(b + 1, (1 << B) - 1) << (32 - B))
    return np.array(edges, dtype=np.uint32)


def prefix_histogram(codes: torch.Tensor, k: int, size: int, bits: int = 8
                     ) -> torch.Tensor:
    """Histogram (int64 [2^bits]) of the top `bits` of canonical word0 over
    one shard's valid windows."""
    words, invalid = canonical_kmers(codes, k, size)
    b = words[0][~invalid] >> (32 - bits)
    return torch.bincount(b, minlength=1 << bits)


def _route_chip(words, invalid, pos, splitters, ndev: int, cap: int,
                size: int, impl: str = "auto", carry_pos: bool = False,
                weights=None):
    """Build the [ndev, cap] send buffers for one chip's positions.

    Records group by destination (dest = the number of splitters <= word0,
    invalid records dropped) with one stable sort; each gets slot
    dest*cap + rank-within-dest and is placed there by index_put_. Returns
    (send_words tuple of int64 [ndev, cap], send_valid — 1 at used slots,
    or the record's weight, 0 at empty ones; overflow — records past cap,
    an int64 scalar tensor; orig and flat — each routed record's position
    and send slot, ndev*cap for a dropped one, for the inverse exchange;
    send_pos — with carry_pos, the source position at each slot).

    weights: int32 per-record weights (pre-deduplicated local counts) ride
    in send_valid instead of ones. impl: "auto", "scatter" or "merge", kept
    from the JAX package, whose TPU-safe "merge" placement gives the same
    buffers as its scatter; on a card the scatter is the fast one, so all
    three place by index_put_."""
    if impl not in ("auto", "scatter", "merge"):
        raise ValueError(f"route_impl {impl!r}")
    dev = words[0].device
    dest = torch.searchsorted(splitters, words[0], right=True)
    dest = torch.where(invalid, ndev, dest)
    d_sorted, perm = torch.sort(dest, stable=True)
    per_dest = torch.bincount(d_sorted, minlength=ndev + 1)
    first_of = torch.cumsum(per_dest, 0) - per_dest
    rank = torch.arange(size, device=dev) - first_of[d_sorted]
    routed = d_sorted < ndev
    slot_ok = (rank < cap) & routed
    overflow = ((rank >= cap) & routed).sum()
    flat = torch.where(slot_ok, d_sorted * cap + rank, ndev * cap)
    orig = pos[perm]
    vals = [w[perm] for w in words]
    if carry_pos:
        vals.append(orig.to(torch.int64))
    vals.append(torch.ones(size, dtype=torch.int64, device=dev)
                if weights is None else weights[perm].to(torch.int64))
    placed = []
    for v in vals:
        buf = torch.zeros(ndev * cap + 1, dtype=torch.int64, device=dev)
        buf[flat] = v  # the dropped records land in the dump slot
        placed.append(buf[:-1].view(ndev, cap))
    send_words = tuple(placed[: len(words)])
    send_pos = placed[len(words)] if carry_pos else None
    return send_words, placed[-1], overflow, orig, flat, send_pos


def _slot_counts_to_routed(flat_counts, send_valid_flat, size: int):
    """Counts per ROUTED-ORDER record from per-send-slot counts: send slots
    are assigned to routed records in increasing order, so the used slots'
    counts, compacted in slot order, are the routed records' counts; the
    dropped (invalid) records trail the routed order and take zeros."""
    used = flat_counts[send_valid_flat > 0]
    out = torch.zeros(size, dtype=flat_counts.dtype, device=flat_counts.device)
    out[: used.numel()] = used[:size]
    return out


def _count_received(words, valid, D_cap: int, want_rec_counts: bool,
                    pos=None, weighted: bool = False):
    """Sort + segment-count the records one chip received.

    Records with valid == 0 are padding: they fold to all-ones keys and
    sort to the end with the invalid ones.

    want_rec_counts: rec_counts, int32 [D_cap] — each received record's
    clipped count in received order (for the inverse exchange). pos: the
    source position of each received record; the sorted instance stream
    comes back as inst_pos (source position) and inst_slot (receive slot:
    slot // cap is the source chip) in key order, valid instances first,
    with n_inst, their number. Its segment of each instance is not
    returned: it is repeat(arange(nseg valid), seg_counts), since the
    stream is the segments concatenated in order.

    weighted: `valid` holds per-record weights (pre-deduplicated local
    counts); segment counts are weight sums, and the histogram bins them
    with bincount instead of the run-length kernel."""
    dev = words[0].device
    folded = fold_invalid(words, valid == 0)
    values = []
    if want_rec_counts:
        values.append(torch.arange(D_cap, dtype=torch.int32, device=dev))
    if pos is not None:
        values += [pos.to(torch.int32),
                   torch.arange(D_cap, dtype=torch.int32, device=dev)]
    if weighted:
        values.append(valid.to(torch.int32))
    s_words, s_vals = sort_keys(folded, values)
    res = segmented_count(s_words, want_elem_counts=want_rec_counts,
                          want_hist=True,
                          weights=s_vals[-1] if weighted else None)
    if want_rec_counts:
        res["rec_counts"] = positions_inverse(s_vals[0],
                                              res.pop("elem_counts"))
    if pos is not None:
        o = 1 if want_rec_counts else 0
        res["inst_pos"] = s_vals[o]
        res["inst_slot"] = s_vals[o + 1]
        res["n_inst"] = (valid > 0).sum()
    return res


def _exchange(mesh: Mesh, send: torch.Tensor) -> torch.Tensor:
    """all_to_all of [D, ...] blocks: block d goes to rank d, and block d
    of the result came from rank d."""
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send.contiguous(), group=mesh.group)
    return recv


def _all_sum(mesh: Mesh, *tensors):
    """Integer tensors summed over the ranks by one all_reduce, as int64
    tensors of their shapes (also in a joined world of one, so that its
    group carries every step)."""
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors])
    if mesh.group is not None:
        dist.all_reduce(flat, group=mesh.group)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o: o + t.numel()].view(t.shape))
        o += t.numel()
    return out


def sharded_count_fn(mesh: Mesh, k: int, shard_size: int, slack: float = 1.6,
                     want_positions: bool = False, route_impl: str = "auto",
                     want_inst: bool = False,
                     pre_dedup: Optional[bool] = None):
    """The multi-device counting step, run by every rank of the mesh.

    step(codes, splitters): codes, this rank's shard (uint8 [shard_size +
    pad_needed(k)] on mesh.device: its shard_size window starts and the halo
    after them); splitters, int64 [D-1] on mesh.device. Returns this rank's
    dict: seg_words (tuple of int64 [D*cap]), seg_counts, seg_valid, nseg;
    hist int64 [32768], overflow and route_overflow (int64 scalar tensors),
    each summed over the ranks — route_overflow must be 0 for the result to
    be exact; with want_positions, pos_counts int32 [shard_size] (the count
    at each position of the local shard); with want_inst, inst_pos,
    inst_slot and n_inst (this card's valid received records in key order:
    source position and receive slot; slot // cap is the source rank).

    pre_dedup (count only, D > 1): sort and segment-reduce each shard
    locally before routing, so that a hot k-mer routes as one weighted
    record — the mesh driver's recovery from count skew, not the default
    (the local sort taxes balanced batches)."""
    D = mesh.size
    cap = int(shard_size // D * slack) if D > 1 else shard_size
    D_cap = D * cap
    dedup = bool(pre_dedup) and D > 1 and not (want_inst or want_positions)

    def step(codes, splitters):
        words, invalid = canonical_kmers(codes, k, shard_size)
        pos = torch.arange(shard_size, dtype=torch.int32, device=codes.device)
        if D == 1:
            # no exchange: count the local shard directly
            res = _count_received(words, (~invalid).to(torch.int32), D_cap,
                                  want_positions, pos=pos if want_inst
                                  else None)
            route_ovf = torch.zeros((), dtype=torch.int64,
                                    device=codes.device)
        else:
            weights = None
            if dedup:
                s_words, _ = sort_keys(fold_invalid(words, invalid))
                lseg = segmented_count(s_words)
                words = lseg["seg_words"]
                invalid = ~lseg["seg_valid"]
                weights = lseg["seg_counts"]
            (send_words, send_valid, route_ovf, orig, _flat, send_pos
             ) = _route_chip(words, invalid, pos, splitters, D, cap,
                             shard_size, impl=route_impl,
                             carry_pos=want_inst, weights=weights)
            lanes = [*send_words, send_valid]
            if want_inst:
                lanes.append(send_pos)
            recv = _exchange(mesh, torch.stack(lanes, dim=2)).view(D_cap, -1)
            W = len(send_words)
            res = _count_received(
                tuple(recv[:, j] for j in range(W)), recv[:, W], D_cap,
                want_positions, pos=recv[:, W + 1] if want_inst else None,
                weighted=dedup)
            del recv
        hist, overflow, route_ovf = _all_sum(
            mesh, res["hist"], res["overflow"], route_ovf)
        out = dict(seg_words=res["seg_words"], seg_counts=res["seg_counts"],
                   seg_valid=res["seg_valid"], nseg=res["nseg"], hist=hist,
                   overflow=overflow, route_overflow=route_ovf)
        if want_inst:
            for key in ("inst_pos", "inst_slot", "n_inst"):
                out[key] = res[key]
        if want_positions:
            if D == 1:
                out["pos_counts"] = res["rec_counts"]
            else:
                back = _exchange(mesh, res["rec_counts"].view(D, cap))
                got = _slot_counts_to_routed(back.view(D_cap),
                                             send_valid.view(D_cap),
                                             shard_size)
                out["pos_counts"] = positions_inverse(orig, got)
        return out

    return step


def sharded_relative_fn(mesh: Mesh, k: int, shard_size: int,
                        slack: float = 1.6, route_impl: str = "auto"):
    """The multi-device RELATIVE-profile step (the -p:<table> job).

    The reference table is range-partitioned across ranks by the same
    splitters that route the queries, so each card owns the counts of its
    key interval: queries route to their owner (one all_to_all), the owner
    joins them against its table shard (count = table count, or 0), and
    the counts ride the inverse all_to_all back to position order.

    step(codes, splitters, t_words, t_counts): codes and splitters as in
    sharded_count_fn; t_words, this rank's table shard (tuple of W int64
    [n], sorted), t_counts int32 [n]. The shard needs no padding: torch
    compiles nothing per shape. Returns dict(pos_counts int16 [shard_size],
    route_overflow — summed over the ranks, must be 0)."""
    D = mesh.size
    cap = int(shard_size // D * slack) if D > 1 else shard_size
    D_cap = D * cap

    def step(codes, splitters, t_words, t_counts):
        words, invalid = canonical_kmers(codes, k, shard_size)
        zero = torch.zeros((), dtype=torch.int64, device=codes.device)
        if D == 1:
            return dict(pos_counts=_join_counts(
                t_words, t_counts, fold_invalid(words, invalid)),
                route_overflow=zero)
        pos = torch.arange(shard_size, dtype=torch.int32, device=codes.device)
        (send_words, send_valid, route_ovf, orig, _flat, _sp) = _route_chip(
            words, invalid, pos, splitters, D, cap, shard_size,
            impl=route_impl)
        recv = _exchange(mesh, torch.stack([*send_words, send_valid], dim=2)
                         ).view(D_cap, -1)
        W = len(send_words)
        q = fold_invalid(tuple(recv[:, j] for j in range(W)),
                         recv[:, W] == 0)
        # received order; int32 on the wire (NCCL has no int16)
        rec = _join_counts(t_words, t_counts, q).to(torch.int32)
        back = _exchange(mesh, rec.view(D, cap))
        got = _slot_counts_to_routed(back.view(D_cap), send_valid.view(D_cap),
                                     shard_size)
        (route_ovf,) = _all_sum(mesh, route_ovf)
        return dict(pos_counts=positions_inverse(orig, got),
                    route_overflow=route_ovf)

    return step


def pad_shards(codes: np.ndarray, k: int, mesh: Mesh, shard_size: int) -> np.ndarray:
    """Split a host code stream into D shards of shard_size (+k halo each).

    Each shard gets a (k-1)-code halo from the next shard so windows crossing
    the shard boundary are counted exactly once (by the owning shard) — the
    multi-chip analog of the reference's rem/next block split (io.c:296-333).
    """
    D = mesh.size
    halo = pad_needed(k)
    out = np.full((D, shard_size + halo), 4, dtype=np.uint8)
    for d in range(D):
        lo = d * shard_size
        hi = min(len(codes), lo + shard_size + halo)
        if hi > lo:
            out[d, : hi - lo] = codes[lo:hi]
        # windows beyond shard_size are the next shard's; mask them by
        # keeping only shard_size positions in canonical_kmers(size=...)
    return out.reshape(D * (shard_size + halo))
