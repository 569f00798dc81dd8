"""Host-to-device rates, and whether an upload overlaps device work; the
port's counterpart of ``benchmarks/_h2d.py``, ``_overlap2.py``,
``_r3h2d.py`` and ``_overlap.py``.

    python -m fastk_tpu_torch.probes.h2d

``_h2d.py``: 16 MB of zeros (2 MB for u8small) as u8, i32, i32_2d, f32_2d
and u8small, each uploaded from pageable memory and from memory pinned once
outside the timed runs (the median of 5, MB/s beside it).

``_overlap2.py``: 2^22 random 32-bit values (16.8 MB) and ``heavy``, six
chained sorts of them with an xor (the values held as int64). The upload
alone (pageable, as the script's, and pinned); heavy queued and the pinned
upload into a buffer allocated once started at once on a copy stream, with
the host's dispatch ms, the upload's ms and the ms from its start to heavy's
end (the medians of 5); heavy alone; uploads in 2, 4 and 16 chunks;
``torch.as_tensor`` in place of device_put; the 1 MB uint8 and 16.8 MB
uint64 views.

``_r3h2d.py``: sort_keys of three words at 2^26 (the script's resident
3-key sort) with 0, 1 and 4 pinned upload chunks of 16.8 MB on a copy
stream beside it, the min of 4 from the sort's start to the later of the
two ends; then the uploads alone in 1, 4 and 16 chunks.

``_overlap.py``: the bench's headline step (hist_batch of the unpacked
words, K1 included) on NB = 4 of the bench's batches at the probe's size
(the script's batch is bench.SIZE), the min of 3 blocks each ending in
one stacked histogram fetch, per batch: compute only, on words resident on
the card; "current", the bench's headline_step, whose upload_packed pins by
copy each batch; and "threaded uploads (2 in flight)": a worker thread
refills two pinned buffers and uploads each into its own device buffer on a
copy stream; an event a buffer says when its copy is done (the host may
refill it; the step may read it) and one when its step has read the device
buffer (the next copy into it may start). Then the pinning question of
PERF.md: upload_packed's pin by copy on the host, the first in this run
(with the blocks that torch's caching host allocator pinned for it) and
later ones (the median of 5), against the upload from a buffer pinned
once.

Times are CUDA events on the card (the scripts' host clock with a fetch,
and ``_r3h2d.py``'s scalar fetches, are TPU-only); the host clock for what
is host work (dispatch, pinning). Runs on the card and raises without one.
``main(device="cpu")`` runs the same code on the CPU, where nothing is
pinned and there are no streams: every upload is the host tensor itself.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import nullcontext
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fastk_tpu_torch import bench
from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.count import hist_batch, sort_keys
from fastk_tpu_torch.ops.pack import unpack_words, upload_packed
from fastk_tpu_torch.probes.common import (
    K,
    bench_batch,
    card_name,
    median,
    run_ms,
    to_device,
)

H2D_SIZE = 1 << 26  # _r3h2d.py's sort; the uploads are H2D_SIZE / 4 bytes
NB = 4
H2D_CASES = {  # _h2d.py's argv name -> its line
    "u8": "uint8 1D 16MB",
    "i32": "int32 1D 16MB",
    "i32_2d": "int32 2D 16MB",
    "f32_2d": "float32 2D 16MB",
    "u8small": "uint8 1D 2MB",
}


def h2d_arrays(nbytes: int) -> dict:
    """_h2d.py's arrays: views of `nbytes` zero bytes."""
    a8 = np.zeros(nbytes, dtype=np.uint8)
    rows = max(1, nbytes // 4096)
    return {"u8": a8, "i32": a8.view(np.int32),
            "i32_2d": a8.view(np.int32).reshape(rows, -1),
            "f32_2d": a8.view(np.float32).reshape(rows, -1),
            "u8small": a8[: nbytes // 8]}


def pinned(arr: np.ndarray, dev) -> torch.Tensor:
    """A host copy of arr in pinned memory (the tensor itself on the CPU)."""
    t = torch.from_numpy(arr)
    return t.pin_memory() if dev.type == "cuda" else t


def upload(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(dev, non_blocking=True)


def heavy(x: torch.Tensor) -> torch.Tensor:
    """_overlap2.py's long compute: six chained sorts, each with an xor."""
    for _ in range(6):
        x = torch.sort(x).values
        x = x ^ (x >> 1)
    return x


def overlap_host(n: int) -> np.ndarray:
    return np.random.default_rng(0).integers(0, 1 << 31, n, dtype=np.uint32)


def r3_inputs(size: int) -> dict:
    rng = np.random.default_rng(0)
    return dict(a=rng.integers(0, 1 << 30, size, dtype=np.int64),
                b=rng.integers(0, 1 << 30, size, dtype=np.int64),
                c=rng.integers(0, 1 << 16, size, dtype=np.int64),
                host=rng.integers(0, 1 << 30, size // 16, dtype=np.uint32))


def _chunks(t: torch.Tensor, n: int) -> list:
    return list(torch.chunk(t, n))


def _side(dev):
    """A copy stream on the card; None on the CPU."""
    return torch.cuda.Stream(dev) if dev.type == "cuda" else None


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else nullcontext()


def _join(stream) -> None:
    """The current stream waits for the copy stream's work so far."""
    if stream is not None:
        torch.cuda.current_stream().wait_stream(stream)


class TwoBuffers:
    """Uploads of one packed batch through two pinned host buffers and two
    device buffers, a worker thread refilling and uploading while the
    caller's steps run (``_overlap.py``'s two uploads in flight)."""

    def __init__(self, pw: np.ndarray, dev):
        self.pw, self.dev = pw.view(np.int32), dev
        cuda = dev.type == "cuda"
        self.host = [torch.empty(len(pw), dtype=torch.int32, pin_memory=cuda)
                     for _ in range(2)]
        self.buf = [torch.empty(len(pw), dtype=torch.int32, device=dev)
                    for _ in range(2)]
        self.stream = _side(dev)
        self.uploaded = [torch.cuda.Event() if cuda else None
                         for _ in range(2)]
        self.consumed = [None, None]

    def fill(self, j: int) -> int:
        """Worker: refill host buffer j once its last copy is done, and copy
        it into device buffer j once the step before has read that."""
        if self.uploaded[j] is not None:
            self.uploaded[j].synchronize()
        np.copyto(self.host[j].numpy(), self.pw)
        with _on(self.stream):
            if self.consumed[j] is not None:
                self.stream.wait_event(self.consumed[j])
            self.buf[j].copy_(self.host[j], non_blocking=True)
            if self.uploaded[j] is not None:
                self.uploaded[j].record(self.stream)
        return j

    def run(self, step, nb: int) -> list:
        """step(device words) for nb batches, two uploads in flight."""
        outs = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = deque(pool.submit(self.fill, j) for j in range(2))
            for i in range(nb):
                j = pending.popleft().result()
                if self.uploaded[j] is not None:
                    torch.cuda.current_stream(self.dev).wait_event(
                        self.uploaded[j])
                outs.append(step(self.buf[j]))
                if self.dev.type == "cuda":
                    self.consumed[j] = torch.cuda.Event()
                    self.consumed[j].record()
                if i + 2 < nb:
                    pending.append(pool.submit(self.fill, j))
        return outs


def h2d_cases(dev, size: int) -> list:
    """[(name, fn)]: _h2d.py's uploads, pageable and pinned, of size / 4
    bytes; fn() returns the tensor on `dev`."""
    out = []
    for key, arr in h2d_arrays(size // 4).items():
        pin = pinned(arr, dev)
        out.append((H2D_CASES[key], lambda a=arr: torch.from_numpy(a).to(dev)))
        out.append((H2D_CASES[key] + " pinned",
                    lambda p=pin: upload(p, dev)))
    return out


def _o2_state(dev, size: int):
    """_overlap2.py's size / 16 host values, on the device as int64 and
    pinned, and a copy stream."""
    host = overlap_host(size // 16)
    x = torch.from_numpy(host.astype(np.int64)).to(dev)
    return host, x, pinned(host.view(np.int32), dev), _side(dev)


def overlap2_cases(dev, size: int) -> list:
    """[(name, fn)]: _overlap2.py's uploads and heavy on size / 16 values."""
    host, x, pin, stream = _o2_state(dev, size)

    def during():
        out = heavy(x)
        with _on(stream):
            up = upload(pin, dev)
        _join(stream)
        return out, up

    h8, h64 = host.view(np.uint8)[: len(host) // 4], host.view(np.uint64)
    return [
        ("solo H2D 16.8MB", lambda: torch.from_numpy(host).to(dev)),
        ("solo H2D 16.8MB pinned", lambda: upload(pin, dev)),
        ("H2D during compute", during),
        ("solo compute", lambda: heavy(x)),
    ] + [
        (f"H2D in {p} chunks",
         lambda p=p: [torch.from_numpy(c).to(dev) for c in np.split(host, p)])
        for p in (2, 4, 16)
    ] + [
        ("device_put", lambda: torch.as_tensor(host, device=dev)),
        ("1MB uint8", lambda: torch.from_numpy(h8).to(dev)),
        ("16.8MB uint64", lambda: torch.from_numpy(h64).to(dev)),
    ]


def _r3_state(dev, size: int):
    """_r3h2d.py's sort (a closure), its pinned upload and a copy stream."""
    x = r3_inputs(size)
    a, b, c = (torch.from_numpy(x[k]).to(dev) for k in "abc")
    return (lambda: sort_keys((a, b, c))[0],
            pinned(x["host"].view(np.int32), dev), _side(dev))


def _uploads(pin, nchunks: int, dev, stream) -> list:
    with _on(stream):
        ups = [upload(t, dev) for t in _chunks(pin, nchunks)]
    _join(stream)
    return ups


def r3h2d_cases(dev, size: int) -> list:
    """[(name, fn)]: _r3h2d.py's sort with uploads beside it, and the
    uploads alone, at `size`."""
    sort, pin, stream = _r3_state(dev, size)

    def run(nchunks):
        out = sort()
        return out, _uploads(pin, nchunks, dev, stream) if nchunks else []

    def only(nchunks):
        return _uploads(pin, nchunks, dev, stream)

    return ([(f"sort+upload chunks={n}", lambda n=n: run(n))
             for n in (0, 1, 4)]
            + [(f"upload-only chunks={n}", lambda n=n: only(n))
               for n in (1, 4, 16)])


def overlap_cases(dev, size: int) -> list:
    """[(name, fn)]: _overlap.py's three ways through NB headline steps on
    the bench's batch at `size`; fn() returns the stacked histograms."""
    pw, exc, total = bench_batch(size)
    pd, excd = to_device(pw, dev), to_device(exc, dev)

    def step(words):
        return hist_batch(unpack_words(words, excd, total), K, size)["hist"]

    two = TwoBuffers(pw, dev)
    return [
        ("compute only (no H2D)",
         lambda: torch.stack([step(pd) for _ in range(NB)])),
        ("current (blocking asarray)", lambda: torch.stack(
            [bench.headline_step(pw, exc, total, size, dev)[0]
             for _ in range(NB)])),
        ("threaded uploads (2 in flight)",
         lambda: torch.stack(two.run(step, NB))),
    ]


def cases(dev, size: int) -> list:
    """Every case at `size` (the bench's batch at size too)."""
    return (h2d_cases(dev, size) + overlap2_cases(dev, size)
            + r3h2d_cases(dev, size) + overlap_cases(dev, size))


def _during_ms(dev, x, pin, dst, stream) -> tuple:
    """heavy queued, then the pinned upload into dst on the copy stream at
    once: (host dispatch ms, upload ms, upload start to heavy's end ms)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        heavy(x)
        d = (time.perf_counter() - t0) * 1e3
        return d, 0.0, d
    torch.cuda.synchronize()
    start, up_end, done = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
    t0 = time.perf_counter()
    heavy(x)
    dispatch = (time.perf_counter() - t0) * 1e3
    with torch.cuda.stream(stream):
        start.record(stream)
        dst.copy_(pin, non_blocking=True)
        up_end.record(stream)
    done.record()
    torch.cuda.synchronize()
    return dispatch, start.elapsed_time(up_end), start.elapsed_time(done)


def _sort_upload_ms(dev, sort, stream, pin, nchunks: int) -> float:
    """From the start to the later of the sort's end (None: no sort) and
    the end of nchunks uploads on the copy stream."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        if sort is not None:
            sort()
        for t in _chunks(pin, nchunks) if nchunks else ():
            upload(t, dev)
        return (time.perf_counter() - t0) * 1e3
    start, s_end, u_end = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
    start.record()
    if sort is not None:
        sort()
    s_end.record()
    if nchunks:
        stream.wait_event(start)
        with torch.cuda.stream(stream):
            for t in _chunks(pin, nchunks):
                upload(t, dev)
            u_end.record(stream)
    torch.cuda.synchronize()
    return max(start.elapsed_time(s_end),
               start.elapsed_time(u_end) if nchunks else 0.0)


def _pins(pw, exc, reps: int) -> tuple:
    """(median host ms of upload_packed's pinning by copy, a note of the
    pinned blocks that torch's caching host allocator made for them)."""
    n0 = torch.cuda.host_memory_stats().get("num_host_alloc")
    ms = bench.pin_ms(pw, exc, reps)
    n1 = torch.cuda.host_memory_stats().get("num_host_alloc")
    return ms, ("" if n0 is None else
                f"  ({n1 - n0} new pinned blocks in {reps} pins)")


def main(device="cuda", size=H2D_SIZE) -> dict:
    """Print every line, each script's at `size`; returns {name: ms}."""
    dev = resolve_device(device)
    name = card_name(dev)
    out = {}

    def line(label, ms, extra=""):
        out[label] = ms
        print(f"{label:34s} {ms:9.3f} ms{extra}   [{name}]", flush=True)

    # _h2d.py
    nbytes = {H2D_CASES[k]: a.nbytes for k, a in h2d_arrays(size // 4).items()}
    for label, fn in h2d_cases(dev, size):
        ms = median(run_ms(fn, dev, 5))
        mb = nbytes[label.replace(" pinned", "")] / 1e6
        line(label, ms, f"  {mb / ms * 1e3:9.1f} MB/s")

    # _overlap2.py
    c2 = dict(overlap2_cases(dev, size))
    _, x, pin, stream = _o2_state(dev, size)
    for label in ("solo H2D 16.8MB", "solo H2D 16.8MB pinned"):
        line(label, median(run_ms(c2[label], dev, 5)))
    dst = torch.empty(pin.shape, dtype=pin.dtype, device=dev)
    _during_ms(dev, x, pin, dst, stream)
    d, up, total = (median(t) for t in zip(
        *(_during_ms(dev, x, pin, dst, stream) for _ in range(5))))
    out["dispatch"], out["H2D during compute"] = d, up
    out["compute total after"] = total
    print(f"dispatch: {d:.3f} ms; H2D during compute: {up:.3f} ms; "
          f"compute total after: {total:.3f} ms   [{name}]", flush=True)
    for label in ["solo compute"] + [f"H2D in {p} chunks" for p in (2, 4, 16)] \
            + ["device_put", "1MB uint8", "16.8MB uint64"]:
        line(label, median(run_ms(c2[label], dev, 3)))
    del c2, x

    # _r3h2d.py
    sort, pin, stream = _r3_state(dev, size)
    for n in (0, 1, 4, 0, 1, 4):
        _sort_upload_ms(dev, sort, stream, pin, n)
        line(f"sort+upload chunks={n}", min(
            _sort_upload_ms(dev, sort, stream, pin, n) for _ in range(4)))
    for n in (1, 4, 16):
        _sort_upload_ms(dev, None, stream, pin, n)
        line(f"upload-only chunks={n}", min(
            _sort_upload_ms(dev, None, stream, pin, n) for _ in range(4)))
    del sort, pin
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # _overlap.py, and upload_packed's pinning
    pw, exc, total = bench_batch(size)
    if dev.type == "cuda":  # nothing is pinned on the CPU
        line("pin by copy, first", *_pins(pw, exc, 1))
    for label, fn in overlap_cases(dev, size):
        fn()

        def block(fn=fn):
            hists = fn().cpu().numpy()
            if not all(int(h[1:].sum()) > 0 for h in hists):
                raise AssertionError(f"{label}: an empty histogram")

        line(label, min(run_ms(block, dev, 3, warmup=0)) / NB, " /batch")
    if dev.type == "cuda":
        line("pin by copy (upload_packed)", *_pins(pw, exc, 5))
    pin_w, pin_e = pinned(pw.view(np.int32), dev), pinned(exc.view(np.int32),
                                                            dev)
    line("upload_packed + unpack", median(run_ms(
        lambda: upload_packed(pw, exc, total, dev), dev, 5)))
    line("pinned once + H2D + unpack", median(run_ms(
        lambda: unpack_words(upload(pin_w, dev), upload(pin_e, dev), total),
        dev, 5)))
    return out


if __name__ == "__main__":
    main()
