"""Every copy between the host and the device.

FastK has no weights: what crosses is the code stream, the key words and
counts. The host holds key words as uint32 columns, the device as W int64
tensors with values in [0, 2^32) (see ops/kmers.py); they cross as their
int32 bits, in one (W, n) copy each way. ``fetch_async`` is the one copy
from the device that waits only for itself (pinned memory, an event after
the copy), under a ``trace.wait`` site its caller names.
"""

from __future__ import annotations

import numpy as np
import torch

from fastk_tpu_torch import trace

_ONES = 0xFFFFFFFF  # the low 32 bits of an int64 word (ops/count.py ONES)


def device_codes(codes: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host uint8 codes -> the same codes on `device`, a new tensor. On CUDA
    the copy reads the host array where it lies (pageable) and is queued
    without a stream sync. Traced: the span upload, and the counters
    upload.bytes and upload.raw_slices."""
    with trace.span("upload"):
        trace.count("upload.bytes", codes.nbytes)
        trace.count("upload.raw_slices", 1)
        return torch.from_numpy(codes).to(device, non_blocking=True,
                                          copy=True)


def upload_int32(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host 32-bit array as int32 on `device`. On CUDA it is copied into
    pinned memory and uploaded without blocking the host, so host work that
    follows overlaps device work queued before it. Traced: the span upload
    and the counter upload.bytes."""
    with trace.span("upload"):
        trace.count("upload.bytes", arr.nbytes)
        t = torch.from_numpy(arr.view(np.int32))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
    return t


def words_from_numpy(words, device) -> tuple:
    """W uint32 key columns (a sequence, or the rows of a (W, n) array) ->
    W int64 tensors on `device`: copied once on the host into a (W, n)
    int32 buffer (pinned on CUDA), uploaded without blocking the host and
    widened on the device."""
    device = torch.device(device)
    host = torch.empty((len(words), len(words[0]) if len(words) else 0),
                       dtype=torch.int32, pin_memory=device.type == "cuda")
    for row, w in zip(host.numpy().view(np.uint32), words):
        row[:] = w
    wide = host.to(device, non_blocking=True).to(torch.int64)
    return tuple(wide.bitwise_and_(_ONES))


def _narrow(words, n: int) -> torch.Tensor:
    """The first n of each word tensor as the rows of one (W, n) int32
    tensor on their device."""
    out = torch.empty((len(words), n), dtype=torch.int32,
                      device=words[0].device)
    for row, w in zip(out, words):
        row.copy_(w[:n])
    return out


def words_to_numpy(words, n=None) -> np.ndarray:
    """The first n (default: all) of W int64 key word tensors -> (W, n)
    uint32, in one blocking copy of their int32 bits."""
    words = tuple(words)
    n = len(words[0]) if n is None else n
    return _narrow(words, n).cpu().numpy().view(np.uint32)


def words_to_numpy_async(words, n: int, site: str, stream=None):
    """words_to_numpy, narrowed and copied on `stream` (fetch_async); the
    callable returned waits and gives the (W, n) uint32 array. A tensor of
    int32 counts may stand among the words."""
    with torch.cuda.stream(stream):
        got = fetch_async(_narrow(tuple(words), n), site, stream)
    return lambda: got().view(np.uint32)


def fetch_async(t: torch.Tensor, site: str, stream=None):
    """Start moving device tensor `t` to the host. Returns a callable that
    waits, under ``trace.wait(site)``, for this copy alone and not for
    device work queued after it, and returns `t`'s values as a numpy array
    (0-d for a scalar). On CUDA the copy goes into pinned memory on `stream`
    (default: the current one; see ``fence``)."""
    if t.device.type != "cuda":
        def wait() -> np.ndarray:
            with trace.wait(site):
                return t.numpy()

        return wait
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if stream is not None:
        t.record_stream(stream)  # not reused before the copy has read it
    with torch.cuda.stream(stream):
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

    def wait() -> np.ndarray:
        with trace.wait(site):
            done.synchronize()
        return host.numpy()

    return wait


def fetch(t: torch.Tensor, site: str) -> np.ndarray:
    """fetch_async(t, site), waited for."""
    return fetch_async(t, site)()


def fetch_u16(x: torch.Tensor) -> np.ndarray:
    """Device count array (values in [0, 32767]) -> host np.uint16. The
    device keeps counts signed (torch's uint16 kernels are thin); they move
    as int16. Traced: the wait fetch_u16."""
    return fetch(x.to(torch.int16), "fetch_u16").view(np.uint16)


def fence(stream):
    """A callable that makes CUDA stream `stream` wait for the device work
    queued on the current stream before fence() was called, and for none
    queued since. With no stream it does nothing."""
    if stream is None:
        return lambda: None
    ready = torch.cuda.Event()
    ready.record()
    return lambda: stream.wait_event(ready)
