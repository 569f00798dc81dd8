"""Spans around calls into the port, recorded from the benchmark's side, and
the reduction of a profiler trace to what the per-layer metrics read.

A target is ``module:attribute[.attribute]``, looked up where the port's
callers look it up, and replaced for the run by a wrapper that adds up its
host seconds, its calls and, where the metric gives a byte count, the bytes
the call's tensors hold, and marks each call in the profiler's trace as
``kbench:<span>``. A generator function's wrapper times each step. A target
that no longer exists is left out.

A span's device seconds are the summed durations of the kernels, copies and
memsets whose launching runtime call lies inside one of its calls, matched
by the profiler's correlation ids.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import inspect
import json
import time
from dataclasses import dataclass

# spans that only name what the host was doing in an idle gap of the device
GAP_NAMES = {
    "plan": "fastk_tpu_torch.tools.fastk:_measure_dedup",
    "count_files": "fastk_tpu_torch.tools.fastk:count_files",
    "write_histogram": "fastk_tpu_torch.tools.fastk:write_histogram",
    "upload": "fastk_tpu_torch.pipeline.count:upload_packed",
    "merge": "fastk_tpu_torch.pipeline.count:merge_unique_blocks",
    "table_out": "fastk_tpu_torch.pipeline.count:_table_entries",
    "ktab_write": "fastk_tpu_torch.pipeline.count:write_ktab",
    "table_upload": "fastk_tpu_torch.pipeline.count:_device_table",
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclass
class Stat:
    calls: int = 0
    host_s: float = 0.0
    bytes: int = 0
    device_s: float = 0.0


def _resolve(target: str):
    """(owner, attribute name) of a target, or None where it is gone."""
    module, _, path = target.partition(":")
    try:
        owner = importlib.import_module(module)
    except ImportError:
        return None
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p, None)
        if owner is None:
            return None
    if not callable(getattr(owner, attr, None)):
        return None
    return owner, attr


class Spans:
    """Wrappers installed around targets; uninstall() restores them."""

    def __init__(self, record_function):
        self.stats: dict = {}
        self._record = record_function  # torch.profiler.record_function
        self._undo = []

    def install(self, span: str, target: str, bytes_of=None) -> bool:
        found = _resolve(target)
        if found is None:
            return False
        owner, attr = found
        orig = getattr(owner, attr)
        stat = self.stats.setdefault(span, Stat())
        label = "kbench:" + span
        record = self._record

        if inspect.isgeneratorfunction(orig):
            @functools.wraps(orig)
            def wrapper(*args, **kwargs):
                inner = orig(*args, **kwargs)
                try:
                    while True:
                        t0 = time.perf_counter()
                        with record(label):
                            try:
                                item = next(inner)
                            except StopIteration:
                                item = inner = None
                        stat.host_s += time.perf_counter() - t0
                        stat.calls += 1
                        if inner is None:
                            return
                        yield item
                finally:
                    if inner is not None:
                        inner.close()
        else:
            @functools.wraps(orig)
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                with record(label):
                    out = orig(*args, **kwargs)
                stat.host_s += time.perf_counter() - t0
                stat.calls += 1
                if bytes_of is not None:
                    stat.bytes += bytes_of(args, kwargs, out)
                return out

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig))
        return True

    def uninstall(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo = []


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(path: str, stats: dict) -> dict:
    """Read a Chrome trace of the window: fill each span's device seconds in
    `stats`, and return the window's length, the device's busy seconds in it,
    and the breakdown (top device operations, longest idle gaps named by the
    innermost span open at their middle)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch, device, spans = {}, [], {}
    window = None
    for ev in events:
        cat, args = ev.get("cat"), ev.get("args") or {}
        if ev.get("ph") != "X":
            continue
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch[args["correlation"]] = ev["ts"]
        elif cat in DEVICE_CATS:
            device.append(ev)
        elif cat == "user_annotation" and ev["name"].startswith("kbench:"):
            name = ev["name"][len("kbench:"):]
            if name == "window":
                window = (ev["ts"], ev["ts"] + ev["dur"])
            else:
                spans.setdefault(name, []).append(
                    (ev["ts"], ev["ts"] + ev["dur"]))
    if window is None:
        raise ValueError(f"{path}: no kbench:window span")
    for name, ivs in spans.items():
        ivs.sort()
        starts = [s for s, _ in ivs]
        total = 0.0
        for ev in device:
            t = launch.get((ev.get("args") or {}).get("correlation"))
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ivs[i][1]:
                total += ev["dur"]
        if name in stats:
            stats[name].device_s = total * 1e-6

    w0, w1 = window
    busy = _union((max(ev["ts"], w0), min(ev["ts"] + ev["dur"], w1))
                  for ev in device if ev["ts"] + ev["dur"] > w0
                  and ev["ts"] < w1)
    busy_us = sum(e - s for s, e in busy)
    by_op = {}
    for ev in device:
        if w0 <= ev["ts"] < w1:
            name = ev["name"][:120]
            by_op[name] = by_op.get(name, 0.0) + ev["dur"] * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)), reverse=True)[:TOP]
    flat = [(e - s, s, e, name) for name, ivs in spans.items()
            for s, e in ivs]
    idle = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        inner = [x for x in flat if x[1] <= mid <= x[2]]
        idle.append([min(inner)[3] if inner else "window", length * 1e-6])
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": idle}}
