"""Spans and counters inside a fastk job, on the torch profiler's clock.

A job record is open only while ``tools/fastk.py:main`` runs a job under a
torch profiler that records on the calling thread (a benchmark's traced
window, or FASTK_TPU_TRACE). While one is open:

- ``span(name)`` times a phase: its name, start, end, thread, and the span
  that encloses it on that thread (its parent). On the job's own thread it
  also opens ``torch.profiler.record_function("fastk:<name>")``, so that the
  phase lands on the profiler's timeline beside the kernels launched inside
  it (the profiler does not record other threads' annotations);
- ``wait(site)`` is the span ``wait.<site>`` around a point where the host
  blocks for the card; its seconds also add to the job's host_blocked_s
  (once, where waits nest);
- ``count(name, n)`` adds n to a counter of the job.

With no record open, span and wait return one shared no-op context and count
returns at once: each reads one module-level reference, no clock, and builds
no record_function. Spans outside a job are not recorded.

At a job's normal return its summary joins ``jobs()``, the last JOBS_KEPT
jobs of the process; a job that raises leaves none. A summary is a dict:
wall_s, host_blocked_s, counters {name: n}, spans {name: {calls, host_s
(summed over threads), main_s (on the job's thread), self_s (less the
children on the same thread)}}, and events, one (name, start, end, thread,
parent) a span, times from time.perf_counter. Nothing writes them out: a
reader takes them from ``jobs()`` in the same process. One job at a time is
recorded; a job started while another is open is not.
"""

from __future__ import annotations

import collections
import threading
import time

JOBS_KEPT = 1024

_job = None  # the open _Job, or None: every span is the no-op
_jobs: collections.deque = collections.deque(maxlen=JOBS_KEPT)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Job:
    def __init__(self, record_function):
        self.record_function = record_function
        self.thread = threading.get_ident()
        self.lock = threading.Lock()
        self.local = threading.local()  # .stack: the thread's open spans
        self.events = []
        self.spans = {}
        self.counters = {}
        self.host_blocked_s = 0.0
        self.closed = False

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def add(self, span, t1: float) -> None:
        dur = t1 - span.t0
        main = span.thread == self.thread
        with self.lock:
            if self.closed:
                return
            st = self.spans.get(span.name)
            if st is None:
                st = self.spans[span.name] = dict(calls=0, host_s=0.0,
                                                  main_s=0.0, self_s=0.0)
            st["calls"] += 1
            st["host_s"] += dur
            st["self_s"] += dur - span.child_s
            if main:
                st["main_s"] += dur
            if span.blocks:
                self.host_blocked_s += dur
            self.events.append((span.name, span.t0, t1, span.thread,
                                span.parent.name if span.parent else None))


class _Span:
    __slots__ = ("job", "name", "wait", "blocks", "parent", "thread", "t0",
                 "child_s", "rf")

    def __init__(self, job: _Job, name: str, wait: bool):
        self.job, self.name, self.wait = job, name, wait

    def __enter__(self):
        job = self.job
        stack = job.stack()
        self.parent = stack[-1] if stack else None
        # a wait inside a wait blocks the host once
        self.blocks = self.wait and not any(s.wait for s in stack)
        self.thread = threading.get_ident()
        self.child_s = 0.0
        stack.append(self)
        self.rf = None
        if self.thread == job.thread:
            self.rf = job.record_function("fastk:" + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.job.stack().pop()
        if self.parent is not None:
            self.parent.child_s += t1 - self.t0
        self.job.add(self, t1)
        return False


def span(name: str):
    """A context that times the phase `name` in the open job."""
    job = _job
    if job is None:
        return _NOOP
    return _Span(job, name, False)


def wait(site: str):
    """The span wait.<site>, whose seconds the host spends blocked for the
    card."""
    job = _job
    if job is None:
        return _NOOP
    return _Span(job, "wait." + site, True)


def count(name: str, n: int) -> None:
    """Add n to the open job's counter `name`."""
    job = _job
    if job is None:
        return
    with job.lock:
        job.counters[name] = job.counters.get(name, 0) + int(n)


def active() -> bool:
    """True while a job record is open (for work done only to count)."""
    return _job is not None


class _JobScope:
    """The root span `job` of one fastk job; a record is kept only when a
    torch profiler records on this thread and no other job is open."""

    __slots__ = ("job", "root", "t0")

    def __enter__(self):
        global _job
        self.job = None
        import torch

        if _job is not None or not torch.autograd._profiler_enabled():
            return self
        self.job = _job = _Job(torch.profiler.record_function)
        self.t0 = time.perf_counter()
        self.root = _Span(self.job, "job", False).__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _job
        job = self.job
        if job is None:
            return False
        try:
            self.root.__exit__(exc_type, exc, tb)
            wall = time.perf_counter() - self.t0
        finally:
            _job = None
            with job.lock:
                job.closed = True
        if exc_type is None:
            _jobs.append(dict(wall_s=wall,
                              host_blocked_s=job.host_blocked_s,
                              spans=job.spans, counters=job.counters,
                              events=job.events))
        return False


def job() -> _JobScope:
    """The context of one job: ``with trace.job(): ...``."""
    return _JobScope()


def jobs() -> list:
    """The kept job summaries, oldest first."""
    return list(_jobs)
