"""The port's counterparts of the ``benchmarks/`` scripts: the Mosaic
feasibility probes of ``benchmarks/_pallas_feas*.py``, run through the
port's kernels of ``ops/probes.py``; ``rss``, the -M host-memory check of
``benchmarks/bench_rss.py`` (``python -m fastk_tpu_torch.probes.rss``);
``profiles``, the fused -t -p job of ``benchmarks/bench_profiles.py``; and
``stages``, the count_batch stage times of ``benchmarks/prof_stages.py``
(each ``python -m fastk_tpu_torch.probes.<name>``; see their docstrings).

Each probe module ``feas``, ``feas2``, ``feas3`` and ``feas4`` is the
counterpart of one probe script: the same probe names, the same inputs from
the same numpy seeds, the same ``probe(name, fn)`` lines, and each probe's
own check against numpy. ``LAUNCHES`` in each module lists the port's
function for each ``pallas_call`` of its script, in the order the script
launches them, each taking that call's inputs and returning its output's
shape.

    python -m fastk_tpu_torch.probes        # on the card; raises without one

``main(device="cpu")`` runs the plain torch versions.
"""

from __future__ import annotations

import time

from fastk_tpu_torch.device import resolve_device


class Probe:
    """probe(name, fn): runs fn, prints the script's line (name padded to
    `width`, then OK and fn's result, or FAIL and the error's first line
    cut to `msg_len`) and records (name, ok, text) in `results`."""

    def __init__(self, width: int, msg_len: int):
        self.width, self.msg_len = width, msg_len
        self.results = []

    def __call__(self, name, fn):
        try:
            out = fn()
            print(f"{name:{self.width}s} OK   {out}", flush=True)
            self.results.append((name, True, str(out)))
        except Exception as e:  # noqa: BLE001
            msg = str(e).split("\n")[0][: self.msg_len]
            print(f"{name:{self.width}s} FAIL {type(e).__name__}: {msg}",
                  flush=True)
            self.results.append((name, False, msg))


def loop_ms(f) -> float:
    """Median wall ms of 3 runs of f(), each ended by reading its result
    (as the TPU probes timed theirs, host sync included)."""
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        int(f()[0])
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[1] * 1e3


def main(device="cuda") -> list:
    """Run the four probe modules on `device`; returns every (name, ok,
    text)."""
    from fastk_tpu_torch.probes import feas, feas2, feas3, feas4

    resolve_device(device)
    return [r for m in (feas, feas2, feas3, feas4) for r in m.main(device)]
