"""Headline benchmark of the port: bases/sec on one CUDA card computing the
canonical 40-mer frequency histogram (FastK's default `FastK -k40` job) on a
synthetic 50X-HiFi-like dataset, end to end per batch: 2-bit-packed host to
device transfer, device unpack, canonical k-mer keys, sort, the run-length
histogram kernel, histogram to host. The counterpart of the repo's
``bench.py``, with its names, constants, trials and JSON lines.

    python -m fastk_tpu_torch.bench       # FASTK_BENCH_SIZE sets the batch

Prints, in this order, one JSON line each:
  the fused `-t -p` line (``_bench_fused``; left out if it failed);
  the headline step's host synchronisations and waits (``step_diagnostics``);
  the headline, last: {"metric": ..., "value": N, "unit": "bases/sec",
  "vs_baseline": N, "batch_size": N, "band": {...}, "fused_value": N,
  "fused_vs_baseline": N, "fused_band": {...}, "device": {...}}.
Every line carries "device": the card's name, the card count and the power
limit as nvidia-smi reads it (null where nvidia-smi is absent).

vs_baseline is against the reference FastK's published throughput of ~300 GB
input per wall-hour on an 8-core laptop, ~8.3e7 bases/s for FASTA input
(BASELINE_BASES_PER_SEC), and half that for its -t -p job (BASELINE_FUSED).

The dataset is made on the host from a numpy seed (``synth_hifi``) and packed
once by the production packer; the timed path is the production ingest
path: host packed words -> pinned H2D -> unpack -> count -> histogram -> D2H.

``main()`` runs on the card and raises without one; ``main(device="cpu")``
runs the same path through the kernel's plain version, for the tests.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.count import count_batch, hist_batch
from fastk_tpu_torch.ops.histker import run_hist
from fastk_tpu_torch.ops.kmers import pad_needed
from fastk_tpu_torch.ops.pack import EXC_PAD, pack_stream_words, upload_packed

BASELINE_BASES_PER_SEC = 8.3e7  # FastK: ~300GB FASTA/hour on 8 cores
BASELINE_FUSED = BASELINE_BASES_PER_SEC / 2  # FastK -t -p ~half hist speed

K = 40
SIZE = int(os.environ.get("FASTK_BENCH_SIZE", str(1 << 24)))  # positions
READ_LEN = 20_000
GENOME = max(1 << 16, SIZE // 33)  # ~33X coverage at SIZE bases at any SIZE

# bases a trial streams, and the seconds the trials may take, as bench.py
HEADLINE_BASES = 1 << 28
FUSED_BASES = 1 << 27
HEADLINE_BUDGET_S = 120
FUSED_BUDGET_S = 90

METRIC = ("bases/sec/chip: canonical 40-mer histogram, 50X HiFi-like, "
          "streamed end-to-end (H2D+count+hist D2H)")
FUSED_METRIC = ("bases/sec/chip: fused 40-mer count+table+profile, streamed "
                "(H2D+device+probe D2H)")
SYNC_WARNING = "called a synchronizing CUDA operation"
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# CUDA runtime calls in which the host waits for the device
_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")


def synth_hifi(size: int, genome: int, read_len: int, err: float = 0.003,
               seed: int = 0):
    """50X-HiFi-like code stream: reads sampled from a random genome with
    point errors, half reverse-complemented, joined by sentinel 4. The
    distribution of bench.py's synth_hifi_device, from a numpy seed.

    Returns (uint8 codes [nreads * stride], nreads, stride); read r's
    sentinel sits at r * stride + read_len."""
    rng = np.random.default_rng(seed)
    stride = read_len + 1
    nreads = size // stride
    g = rng.integers(0, 4, genome, dtype=np.uint8)
    starts = rng.integers(0, genome - read_len, nreads)
    reads = np.lib.stride_tricks.sliding_window_view(g, read_len)[starts]
    emask = rng.random((nreads, read_len), dtype=np.float32) < err
    bump = rng.integers(1, 4, (nreads, read_len), dtype=np.uint8)
    reads = np.where(emask, (reads + bump) % 4, reads).astype(np.uint8)
    del emask, bump
    flip = rng.random(nreads) < 0.5
    reads[flip] = (3 - reads[flip])[:, ::-1]
    block = np.concatenate(
        [reads, np.full((nreads, 1), 4, np.uint8)], axis=1).reshape(-1)
    return block, nreads, stride


def exceptions(n: int, stride: int, total: int) -> np.ndarray:
    """The exception list of a synth_hifi block of n codes padded with
    sentinels to total: each read's sentinel and the tail [n, total), known
    without a scan, padded with EXC_PAD to a multiple of 4096 (what
    pack_stream lists for the same codes)."""
    sent = np.arange(stride - 1, n, stride, dtype=np.uint32)
    tail = np.arange(n, total, dtype=np.uint32)
    exc = np.concatenate([sent, tail])
    m = max(4096, -(-len(exc) // 4096) * 4096)
    out = np.full(m, EXC_PAD, dtype=np.uint32)
    out[: len(exc)] = exc
    return out


def bench_input(size: int, genome: int, read_len: int, seed: int = 0):
    """The batch the bench streams: (packed uint32 words, exceptions, total
    codes, nreads). The words are pack_stream_words' (the production
    packer's), the exceptions analytic."""
    total = size + pad_needed(K)
    block, nreads, stride = synth_hifi(size, genome, read_len, seed=seed)
    n = len(block)
    codes = np.concatenate([block, np.full(total - n, 4, np.uint8)])
    pw, _ = pack_stream_words(codes)
    return pw, exceptions(n, stride, total), total, nreads


def headline_step(pw, exc, total: int, size: int, dev):
    """One batch of the histogram job: pinned H2D and unpack
    (upload_packed), then hist_batch: canonical keys, sort, start words and
    one launch of the run-length kernel. Returns (hist int64 [32768] on dev,
    nvalid int)."""
    codes = upload_packed(pw, exc, total, dev)
    out = hist_batch(codes, K, size)
    return out["hist"], out["nvalid"]


def fused_step(pw, exc, total: int, size: int, dev):
    """One batch of the fused -t -p job (pipeline._count_single_fused's
    count): upload_packed, then count_batch with positions and no
    histogram. Returns (nvalid, nseg, pos_counts int16 [size]), on dev."""
    codes = upload_packed(pw, exc, total, dev)
    res = count_batch(codes, K, size, True, False)
    return res["nvalid"], res["nseg"], res["pos_counts"]


def _wait_for_device(tries: int = 4, probe_timeout: int = 300) -> None:
    """A card can fail or hang at start-up. Probe it in a
    subprocess (which isolates the hang and a failed init) a few times
    before the real run proceeds or fails; never raises."""
    probe = ("import torch; torch.zeros(1, device='cuda'); "
             "torch.cuda.synchronize()")
    for i in range(tries):
        try:
            r = subprocess.run([sys.executable, "-c", probe],
                               timeout=probe_timeout, capture_output=True)
            if r.returncode == 0:
                return
            msg = r.stderr.decode(errors="replace")[-200:]
        except subprocess.TimeoutExpired:
            msg = "probe hang"
        if i < tries - 1:
            sys.stderr.write(f"bench: device probe failed ({msg.strip()}); "
                             f"retry {i + 2}/{tries} in 90s\n")
            time.sleep(90)


def nvidia_smi():
    """The first card's `name, power.limit` as nvidia-smi reports them, or
    None where nvidia-smi is absent or fails."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else None


def device_info(dev) -> dict:
    """What a result line says of the device it ran on."""
    if dev.type != "cuda":
        return {"platform": dev.type, "name": dev.type, "count": 0,
                "power_limit": None}
    smi = nvidia_smi()
    return {"platform": "gpu",
            "name": torch.cuda.get_device_name(dev.index or 0),
            "count": torch.cuda.device_count(),
            "power_limit": smi.rsplit(",", 1)[1].strip() if smi else None}


def band(vals) -> dict:
    """The trials' spread: min, median, max and their number."""
    v = sorted(vals)
    return dict(min=round(v[0]), median=round(v[len(v) // 2]),
                max=round(v[-1]), n_trials=len(v))


def _trials(block, nbatch: int, budget_s: float, most: int) -> list:
    """Seconds a batch of each trial: block() streams nbatch batches;
    at least 3 trials, then more while the budget lasts, at most `most`."""
    trials = []
    t_budget = time.perf_counter() + budget_s
    while len(trials) < 3 or (time.perf_counter() < t_budget
                              and len(trials) < most):
        t0 = time.perf_counter()
        block()
        trials.append((time.perf_counter() - t0) / nbatch)
    return trials


def sync_sites(fn) -> list:
    """The host synchronisations of one fn() on the card, caught by torch's
    sync debug mode: the file:line of the Python call that made each, the
    file relative to the repo."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [f"{os.path.relpath(w.filename, _ROOT)}:{w.lineno}"
            for w in caught if SYNC_WARNING in str(w.message)]


def blocked_ms(fn):
    """Host ms that one fn() on the card spends in CUDA runtime calls that
    wait for the device (torch.profiler's CPU events), or None when the
    profiler recorded no runtime call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
    torch.cuda.synchronize()
    events = prof.events()
    if not any(e.name.startswith("cuda") for e in events):
        return None
    return sum(e.cpu_time_total for e in events if e.name in _WAITS) / 1e3


def pin_ms(pw, exc, reps: int = 5) -> float:
    """Median host ms of upload_packed's copies of one batch into pinned
    memory."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        torch.from_numpy(pw.view(np.int32)).pin_memory()
        torch.from_numpy(exc.view(np.int32)).pin_memory()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def step_diagnostics(step, pw, exc) -> dict:
    """One headline step on the card: its host synchronisations and where
    they are made, the host ms they block, its wall ms ending in a
    synchronise, and the ms a batch of pinning by copy. Each is None on the
    CPU (no card to wait for)."""
    if step.dev.type != "cuda":
        return dict(host_syncs=None, sync_sites=None, host_blocked_ms=None,
                    step_ms=None, pin_ms=None)
    sites = sync_sites(step)
    blocked = blocked_ms(step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    return dict(host_syncs=len(sites), sync_sites=sites,
                host_blocked_ms=blocked,
                step_ms=(time.perf_counter() - t0) * 1e3,
                pin_ms=pin_ms(pw, exc))


class _Step:
    """The headline step on one batch, with the number of its runs."""

    def __init__(self, pw, exc, total: int, dev):
        self.pw, self.exc, self.total, self.dev = pw, exc, total, dev
        self.runs = 0

    def __call__(self):
        self.runs += 1
        return headline_step(self.pw, self.exc, self.total, SIZE, self.dev)


def _bench_fused(pw, exc, total: int, nreads: int, nvalid_expect: int,
                 dev) -> list:
    """Streamed fused `-t -p` measurement: the production table+profile
    device path (count + unique extraction + per-position counts through
    the inverse sort), per batch: packed H2D, device compute, nvalid +
    8-element pos_counts probe D2H. Bulk pos_counts D2H excluded, as in
    bench.py. Returns bases/s of each trial."""

    def probe(outs):
        return [(int(nv), pc[:8].cpu().numpy()) for nv, _ns, pc in outs]

    nv, _ns, _pc = fused_step(pw, exc, total, SIZE, dev)  # warm-up
    if int(nv) != nvalid_expect:
        raise AssertionError(f"fused nvalid {int(nv)} != {nvalid_expect}")
    nbatch = max(4, FUSED_BASES // SIZE)
    trials = _trials(lambda: probe([fused_step(pw, exc, total, SIZE, dev)
                                    for _ in range(nbatch)]),
                     nbatch, FUSED_BUDGET_S, 12)
    bases = float(nreads * READ_LEN)
    return [bases / t for t in trials]


def main(device="cuda") -> int:
    if torch.device(device).type == "cuda" and torch.backends.cuda.is_built():
        _wait_for_device()
    dev = resolve_device(device)
    info = device_info(dev)

    pw, exc, total, nreads = bench_input(SIZE, GENOME, READ_LEN)
    step = _Step(pw, exc, total, dev)
    launches0 = run_hist.launches

    def fetch_hists(outs):
        """One stacked D2H per block of batches."""
        return torch.stack([h for h, _ in outs]).cpu().numpy()

    # warm-up (builds the kernel) and bench.py's checks
    out = step()
    hist = fetch_hists([out])[0]
    nvalid = out[1]
    nvalid_expect = nreads * (READ_LEN - K + 1)
    if int(hist[1:].sum()) <= 0 or nvalid != nvalid_expect:
        raise AssertionError(f"warm-up: hist sum {int(hist[1:].sum())}, "
                             f"nvalid {nvalid} != {nvalid_expect}")
    counts = np.arange(len(hist), dtype=np.int64)
    if int((counts * hist).sum()) != nvalid:  # exact instance accounting
        raise AssertionError("warm-up: sum c * hist[c] != nvalid")
    diag = step_diagnostics(step, pw, exc)

    # streaming throughput: batches dispatched back to back, histograms
    # fetched once a block; the best block is the value
    nbatch = max(4, HEADLINE_BASES // SIZE)

    def block():
        hists = fetch_hists([step() for _ in range(nbatch)])
        if not all(int(h[1:].sum()) > 0 for h in hists):
            raise AssertionError("an empty histogram in a trial")

    trials = _trials(block, nbatch, HEADLINE_BUDGET_S, 20)
    bases = nreads * READ_LEN
    tps = [float(bases) / t for t in trials]
    value = max(tps)

    # the fused -t -p line is printed first; its failure must not cost the
    # headline, which stays last
    fused_value = fused_band = None
    try:
        fused_tps = _bench_fused(pw, exc, total, nreads, nvalid_expect, dev)
        fused_value = max(fused_tps)
        fused_band = band(fused_tps)
        print(json.dumps({
            "metric": FUSED_METRIC,
            "value": round(fused_value),
            "unit": "bases/sec",
            "vs_baseline": round(fused_value / BASELINE_FUSED, 3),
            "batch_size": SIZE,
            "band": fused_band,
            "device": info,
        }), flush=True)
    except Exception as e:  # noqa: BLE001 -- the headline must survive
        sys.stderr.write(f"bench: fused metric failed: {e!r}\n")

    diag.update(step="headline", batch_size=SIZE, steps=step.runs,
                run_hist_launches=run_hist.launches - launches0,
                device=info)
    print(json.dumps(diag), flush=True)

    out = {
        "metric": METRIC,
        "value": round(value),
        "unit": "bases/sec",
        "vs_baseline": round(value / BASELINE_BASES_PER_SEC, 3),
        "batch_size": SIZE,
        "band": band(tps),
    }
    if fused_value is not None:
        out["fused_value"] = round(fused_value)
        out["fused_vs_baseline"] = round(fused_value / BASELINE_FUSED, 3)
        out["fused_band"] = fused_band
    out["device"] = info
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
