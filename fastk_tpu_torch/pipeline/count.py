"""The histogram job end to end: host ingest, device count, histogram.

Port of the histogram-only branches of ``fastk_tpu/pipeline/count.py``:

- one batch of at most MAX_DEVICE_POSITIONS positions: ``hist_batch`` (keys,
  sort, run starts, the run-length kernel) and nothing else;
- more: ``unique_batch`` on every device slice, the compacted blocks kept on
  the device, then one ``merge_unique_blocks`` whose histogram is the job's.

Host reading and packing (``fastk_tpu.io.reader``, the native packer) are
shared with the JAX package. Batch i+1's parse, pack and upload overlap
batch i's device work: the only waits are for batch i's two counts.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from fastk_tpu.formats.hist import HIST_HIGH, Histogram
from fastk_tpu.io.reader import ReadBatch, batched_reads
from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.count import (
    ONES,
    hist_batch,
    merge_unique_blocks,
    unique_batch,
)
from fastk_tpu_torch.ops.kmers import nwords, pad_needed
from fastk_tpu_torch.ops.pack import (
    device_codes,
    pack_stream_words,
    upload_packed,
)

DEFAULT_BATCH_BASES = 64 << 20  # bases per device batch
_MIN_SIZE = 1 << 15
# positions per device call: a longer batch (or read) is counted in slices of
# this many k-mer start positions, each carrying the k-1 halo after it
MAX_DEVICE_POSITIONS = 1 << 26


def _round_size(n: int, k: int) -> int:
    """Device size for a batch of n codes: the next power of two (at least
    32768), at most MAX_DEVICE_POSITIONS."""
    want = n + pad_needed(k)
    size = _MIN_SIZE
    while size < want:
        size <<= 1
    return min(size, MAX_DEVICE_POSITIONS)


def _pad_codes(batch: ReadBatch, k: int, size: int) -> np.ndarray:
    codes = np.full(size + pad_needed(k), 4, dtype=np.uint8)
    codes[: len(batch.codes)] = batch.codes
    return codes


def _code_slices(codes: np.ndarray, k: int):
    """Yield (offset, size, padded slice) windows of at most
    MAX_DEVICE_POSITIONS start positions; slice i covers the starts
    [offset, offset + size) and carries the k-1 halo after them."""
    n = len(codes)
    size = _round_size(n, k)
    pad = pad_needed(k)
    off = 0
    while off < n or off == 0:
        take = min(size, max(n - off, 0))
        buf = np.full(size + pad, 4, dtype=np.uint8)
        chunk = codes[off: off + take + pad]
        buf[: len(chunk)] = chunk
        yield off, size, buf
        off += size
        if take < size:
            break


def _packed_slices(codes: np.ndarray, k: int):
    """_code_slices, packed for transfer: yields (off, size, words,
    exceptions, slice length)."""
    for off, size, buf in _code_slices(codes, k):
        pw, exc = pack_stream_words(buf)
        yield off, size, pw, exc, len(buf)


def _trim(n: int) -> int:
    """Block slots to keep for n uniques (a multiple of 32768)."""
    return max(_MIN_SIZE, -(-n // _MIN_SIZE) * _MIN_SIZE)


@dataclass
class CountOutput:
    kmer: int
    hist: Histogram
    nreads: int
    totlen: int
    nshort: int = 0  # reads shorter than k, which hold no k-mer


def _output(k: int, hist_bins: torch.Tensor, nvalid: int, rlens
            ) -> CountOutput:
    """The job's result; the instances lost to clipping at 32767 are
    nvalid - sum(c * hist[c])."""
    bins = hist_bins.cpu().numpy().astype(np.int64)
    overflow = nvalid - int(
        (bins[1:] * np.arange(1, HIST_HIGH + 1, dtype=np.int64)).sum())
    return CountOutput(
        k, Histogram.from_bins(k, bins, overflow),
        nreads=sum(len(r) for r in rlens),
        totlen=sum(int(r.sum()) for r in rlens),
        nshort=sum(int((r < k).sum()) for r in rlens))


def _later(t: torch.Tensor):
    """Start fetching a device scalar; the returned callable waits for the
    fetch alone, not for device work queued after it."""
    if t.device.type != "cuda":
        return lambda: int(t)
    host = t.to("cpu", non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> int:
        done.synchronize()
        return int(host)

    return wait


def count_files(
    paths: Sequence[str],
    k: int,
    hc: bool = False,
    bc: int = 0,
    batch_bases: int = DEFAULT_BATCH_BASES,
    verbose: bool = False,
    device="cuda",
    table_min=None,
    profiles: bool = False,
    relative_table=None,
) -> CountOutput:
    """Count the canonical k-mers of the given sequence files into a
    histogram, on `device`.

    hc: homopolymer-compress reads; bc: drop this many leading bases of each
    read. table_min, profiles and relative_table (``.ktab`` and ``.prof``
    output) are not ported yet and raise NotImplementedError."""
    if table_min is not None or profiles or relative_table is not None:
        raise NotImplementedError("not yet ported: table_min, profiles and "
                                  "relative_table")
    dev = resolve_device(device)

    gen = batched_reads(list(paths), batch_bases, hc=hc, bc=bc)
    first_two = [batch for batch, _ordinal in itertools.islice(gen, 2)]
    if (len(first_two) == 1
            and len(first_two[0].codes) + pad_needed(k)
            <= MAX_DEVICE_POSITIONS):
        return _count_single_hist(first_two[0], k, verbose, dev)

    rlens = []
    blocks_words, blocks_counts = [], []
    nvalid_total = 0
    pending = None

    def _finalize(res, nuniq, nvalid, size):
        nonlocal nvalid_total
        nvalid_total += nvalid()
        keep = min(_trim(nuniq()), size)
        # clone: a slice would keep the whole batch-sized tensor alive
        blocks_words.append(tuple(w[:keep].clone() for w in res["seg_words"]))
        blocks_counts.append(res["seg_counts"][:keep].clone())

    batches = itertools.chain(first_two, (b for b, _ordinal in gen))
    for batch in batches:
        rlens.append(np.asarray(batch.rlen))
        for _off, size, pw, exc, blen in _packed_slices(batch.codes, k):
            res = unique_batch(upload_packed(pw, exc, blen, dev), k, size)
            fetches = (_later(res["nuniq"]), _later(res["nvalid"]))
            if pending is not None:
                _finalize(*pending)
            pending = (res, *fetches, size)
            del res
        if verbose:
            print(f"  batch {len(rlens)}: {len(rlens[-1])} reads, "
                  f"{int(rlens[-1].sum())} bases", flush=True)
        del batch
    if pending is not None:
        _finalize(*pending)
        pending = None

    # one empty slot, so that an input without reads still merges
    m_words = tuple(
        torch.cat([b[j] for b in blocks_words]
                  + [torch.full((1,), ONES, dtype=torch.int64, device=dev)])
        for j in range(nwords(k)))
    m_counts = torch.cat(
        blocks_counts + [torch.zeros(1, dtype=torch.int32, device=dev)])
    del blocks_words, blocks_counts
    merged = merge_unique_blocks(m_words, m_counts)
    return _output(k, merged["hist"], nvalid_total, rlens)


def _count_single_hist(batch: ReadBatch, k: int, verbose: bool,
                       dev: torch.device) -> CountOutput:
    """Single-batch histogram job (the plain ``FastK -k``): no segment
    compaction and no merge."""
    size = _round_size(len(batch.codes), k)
    res = hist_batch(device_codes(_pad_codes(batch, k, size), dev), k, size)
    if verbose:
        print(f"  batch 1 (hist-only): {batch.nreads} reads, "
              f"{batch.totlen} bases", flush=True)
    return _output(k, res["hist"], res["nvalid"], [np.asarray(batch.rlen)])
