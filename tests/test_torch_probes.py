"""The port's probe kernels (fastk_tpu_torch.ops.probes, run through
fastk_tpu_torch.probes) against the Mosaic feasibility probes of
benchmarks/_pallas_feas*.py, run in Pallas interpret mode on the CPU.

The JAX scripts are loaded by path, unchanged; pallas_call is wrapped to
force interpret=True and to record each launch's inputs and output as numpy
arrays. The two loop probes run under jax.jit, where the recorder sees
tracers: those launches are not recorded (their value, 1 000 000, is the
probe's own assertion, and the port's is checked here). The port's
function for each launch (the LAUNCHES of its module) takes the recorded
inputs and must give the recorded output exactly.
"""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
from fastk_tpu_torch import _kernels
from fastk_tpu_torch.ops import probes as ops
from fastk_tpu_torch.probes import feas, feas2, feas3, feas4

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {"feas": feas, "feas2": feas2, "feas3": feas3, "feas4": feas4}
# the probe names, by script, as both print them
NAMES = {
    "feas": ["scalar fori + dyn load + dyn accumulate",
             "data-dependent while_loop", "scalar clz",
             "sequential grid + SMEM carry"],
    "feas2": ["SMEM hist 4096 bins", "SMEM hist 32768 bins",
              "SMEM scratch across grid steps",
              "scalar loop 1M iters (incl ~28ms sync)",
              "f32 matmul bit-pack", "dynamic (1,)-store to VMEM"],
    "feas3": ["SMEM hist 4096 bins (while)", "SMEM hist 32768 bins (while)",
              "scalar while 1M iters (incl ~28ms sync)",
              "ctz bit-iteration"],
    "feas4": ["A while + static VMEM scalar read",
              "B while + dynamic VMEM scalar read",
              "C while + dynamic SMEM scalar read",
              "D while + SMEM scratch accumulate",
              "E nested while + clz, pure scalar"],
}
LINE = re.compile(r"^(.*?)\s+(OK|FAIL)\s+(.*)$")
# (script, launch index) of the launches under jax.jit, not recorded
JITTED = {("feas2", 3), ("feas3", 2)}
# (script, launch index) of P14-D, whose TPU scratch is never zeroed
SCRATCH_D = ("feas4", 3)
INT32_MIN = int(np.iinfo(np.int32).min)
M32 = (1 << 32) - 1


def _lines(text):
    """{probe name: (status, rest)} of a probe script's output."""
    out = {}
    for line in text.splitlines():
        m = LINE.match(line)
        if m:
            out[m.group(1).strip()] = (m.group(2), m.group(3))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """{script: (stdout, [(inputs, output) or None per launch])}."""
    real = pl.pallas_call
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in SCRIPTS:
            recs = []

            def recording(kernel, *a, _recs=recs, **kw):
                f = real(kernel, *a, **dict(kw, interpret=True))

                def call(*args):
                    out = f(*args)
                    if any(isinstance(v, jax.core.Tracer)
                           for v in (*args, out)):
                        _recs.append(None)
                    else:
                        _recs.append(([np.asarray(v) for v in args],
                                      np.asarray(out)))
                    return out

                return call

            mp.setattr(pl, "pallas_call", recording)
            path = os.path.join(REPO, "benchmarks",
                                f"_pallas_{name}.py")
            spec = importlib.util.spec_from_file_location(
                f"_jax_probe_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                mod.main()
            runs[name] = (buf.getvalue(), recs)
    return runs


@pytest.fixture(scope="module")
def port_runs():
    """{script: stdout of the port's main(device="cpu")}."""
    runs = {}
    for name, mod in SCRIPTS.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = mod.main(device="cpu")
        assert [n for n, _, _ in res] == NAMES[name]
        runs[name] = buf.getvalue()
    return runs


PROBES = [(s, n) for s, names in NAMES.items() for n in names]


@pytest.mark.parametrize("script,name", PROBES,
                         ids=[f"{s}-{n[:24]}" for s, n in PROBES])
def test_probe_lines_ok_in_both(jax_runs, port_runs, script, name):
    """(a) The JAX probe reads OK, and the port prints the same name, OK,
    in the same order."""
    jax_lines = _lines(jax_runs[script][0])
    port_lines = _lines(port_runs[script])
    assert list(jax_lines) == list(port_lines) == NAMES[script]
    assert jax_lines[name][0] == "OK", jax_lines[name]
    assert port_lines[name][0] == "OK", port_lines[name]
    if script == "feas4" and not name.startswith("D"):
        assert jax_lines[name][1] == port_lines[name][1]


LAUNCH_CASES = [(s, i) for s, mod in SCRIPTS.items()
                for i in range(len(mod.LAUNCHES)) if (s, i) not in JITTED]


def test_every_launch_is_a_case(jax_runs):
    assert len(LAUNCH_CASES) == 17
    for s, (_out, recs) in jax_runs.items():
        assert len(recs) == len(SCRIPTS[s].LAUNCHES)
        assert {(s, i) for i, r in enumerate(recs) if r is None} == {
            c for c in JITTED if c[0] == s}


@pytest.mark.parametrize("script,i", LAUNCH_CASES,
                         ids=[f"{s}-{i}" for s, i in LAUNCH_CASES])
def test_launch_matches_jax(jax_runs, script, i):
    """(b) The port's function on the recorded inputs gives the recorded
    output exactly (as int64: P9's TPU output is float32, the port's int32
    words). P14-D's TPU scratch starts at the int32 minimum in interpret
    mode, the port's histogram at 0: compared less that start."""
    inputs, want = jax_runs[script][1][i]
    got = SCRIPTS[script].LAUNCHES[i](*(torch.from_numpy(np.array(a))
                                        for a in inputs))
    got = got.numpy()
    assert got.shape == want.shape
    want = want.astype(np.int64)
    if (script, i) == SCRATCH_D:
        want = want - INT32_MIN
    assert np.array_equal(got.astype(np.int64), want)


@pytest.mark.parametrize("fn", [feas2.loop_1m, feas3.LAUNCHES[2]],
                         ids=["P8", "P12"])
def test_loop_probes_give_a_million(fn):
    """(c) The jitted loop probes' value."""
    x = torch.ones((8, 128), dtype=torch.int32)
    assert fn(x).tolist() == [1_000_000]


def test_scratch_probe_makes_one_increment(jax_runs):
    """(d) P14-D: the port gives 1, and the TPU value less its scratch's
    start (the int32 minimum) is 1: both made one increment at hist[0]."""
    inputs, want = jax_runs["feas4"][1][3]
    assert int(want[0]) - INT32_MIN == 1
    x = torch.from_numpy(np.array(inputs[0]))
    assert feas4.scratch_hist(x).tolist() == [1]


# ---- (e) each plain version against numpy at other sizes ----------------

@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 1 << 20])
@pytest.mark.parametrize("nbins", [16, 4096, 32768])
def test_hist_ref_against_numpy(nbins, n):
    rng = np.random.default_rng(nbins + n)
    x = rng.integers(-3, nbins + 3, n).astype(np.int32)
    got = ops.probe_hist(torch.from_numpy(x), nbins).numpy()
    keep = x[(x >= 0) & (x < nbins)]
    assert got.dtype == np.int32
    assert np.array_equal(got, np.bincount(keep, minlength=nbins))


def test_hist_store_ref_takes_the_last_index():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 300, 5000).astype(np.int32)
    want = np.zeros(256, np.int64)
    for i, v in enumerate(x):
        if v < 256:
            want[v] = i
    got = ops.probe_hist(torch.from_numpy(x), 256, store=True).numpy()
    assert np.array_equal(got, want)


def _words(seed, n):
    """Random int32 words, about half with bit 31 set, and the edge words."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint64)
    w = np.concatenate([w, [0, 1, 1 << 31, (1 << 32) - 1]]).astype(np.uint32)
    assert (w >> 31).sum() > n // 4
    return w.view(np.int32)


@pytest.mark.parametrize("n", [1, 100, 4097])
def test_walk_and_clz_refs_against_numpy(n):
    w = _words(n, n)
    bits = np.unpackbits(w.view(np.uint8), bitorder="little").reshape(-1, 32)
    t = torch.from_numpy(w)
    assert ops.probe_bits(t, "walk").tolist() == [
        int((bits * np.arange(32)).sum())]
    high = np.where(bits.any(1), 31 - np.argmax(bits[:, ::-1], 1), -1)
    assert np.array_equal(ops.probe_bits(t, "clz").numpy(), 31 - high)


@pytest.mark.parametrize("width", [16, 32])
@pytest.mark.parametrize("nwords", [1, 7, 4096])
def test_pack_ref_against_numpy(width, nwords):
    w = _words(nwords, nwords)[:nwords].view(np.uint32)
    if width == 16:
        w = w & 0xFFFF
    mask = np.unpackbits(w.astype("<u4").view(np.uint8),
                         bitorder="little").reshape(-1, 32)[:, :width]
    got = ops.probe_bits(torch.from_numpy(mask.reshape(-1).astype(bool)),
                         "pack", width).numpy()
    assert np.array_equal(got.view(np.uint32), w)


@pytest.mark.parametrize("nblocks", [1, 4, 1000])
def test_carry_ref_against_numpy(nblocks):
    x = np.random.default_rng(nblocks).integers(
        -(1 << 30), 1 << 30, (nblocks, 8, 128)).astype(np.int32)
    want = np.cumsum(x.reshape(nblocks, -1).astype(np.int64).sum(1))
    want = ((want + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    assert np.array_equal(ops.probe_carry(torch.from_numpy(x)).numpy(), want)


def _wrapped_carry(x: np.ndarray) -> np.ndarray:
    """numpy: the running sums of x's rows' sums, wrapped to int32."""
    rows = x.reshape(x.shape[0], int(np.prod(x.shape[1:], dtype=np.int64)))
    want = np.cumsum(rows.astype(np.int64).sum(1))
    return ((want + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


@pytest.mark.parametrize("shape,values", [
    ((5000,), "any"), ((7, 0), "any"), ((0, 9), "any"), ((0,), "any"),
    ((1, 1 << 20), "any"), ((333, 3), "any"), ((97, 1001), "any"),
    ((3, 5, 7), "any"), ((64, 100), "near +-2^31"), ((1 << 12, 1), "any")])
def test_carry_ref_at_any_shape(shape, values):
    """The plain carry against numpy: 1-D, empty either side, one long
    row, odd rows, and sums that wrap many times."""
    rng = np.random.default_rng(len(shape) + sum(shape))
    if values == "any":
        x = rng.integers(-(1 << 31), 1 << 31, shape)
    else:
        x = np.where(rng.integers(0, 2, shape) == 1,
                     (1 << 31) - 1 - rng.integers(0, 8, shape),
                     -(1 << 31) + rng.integers(0, 8, shape))
    x = x.astype(np.int32)
    got = ops.probe_carry(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32 and got.shape == (shape[0],)
    assert np.array_equal(got, _wrapped_carry(x))


def _constants(*names):
    """constexpr ints of csrc/probes.cu, by name."""
    return [chip_smoke._constant(name) for name in names]


def _carry_constants():
    """kCarryThreads / 32 (the warps of a tile) and kCarryRounds (a
    warp's rounds of 32 x 4 values) of csrc/probes.cu."""
    threads, rounds = _constants("kCarryThreads", "kCarryRounds")
    return threads // 32, rounds


def _tiled_carry(x: np.ndarray, skew: int, warps: int, rounds: int):
    """The kernel's arithmetic, step for step in uint32: the flat stream,
    from `skew` values before x (zeros), cut in tiles of warps x rounds x
    128 values; the tile's exclusive prefix (the look-back's sum of the
    tiles before) plus the warps' before it; each warp's rounds of 32
    lanes x 4 values, a lane's running sum after the lanes' before it and
    the rounds' before; and the row ends each round writes, found as the
    kernel finds them (rows of 128 or more tracked from one division a
    warp, shorter rows a division a lane and round). Returns the sums and
    how many times each was written."""
    nblocks = x.shape[0]
    n = x.size
    out = np.zeros(nblocks, np.int64)
    written = np.zeros(nblocks, np.int64)
    if n == 0:
        return out.astype(np.int32), written
    blen = n // nblocks
    seg = 128 * rounds
    tile = warps * seg
    ntiles = (n + skew + tile - 1) // tile
    stream = np.zeros(ntiles * tile, np.int64)
    stream[skew:skew + n] = x.reshape(-1).view(np.uint32)
    prefix = 0
    for t in range(ntiles):
        v = stream[t * tile:(t + 1) * tile].reshape(warps, rounds, 32, 4)
        wsum = v.sum((1, 2, 3)) & M32
        for w in range(warps):
            base = (prefix + int(wsum[:w].sum())) & M32
            f0 = t * tile - skew + w * seg
            if f0 >= n:
                continue
            if blen >= 128:
                b = max(f0, 0) // blen
                e = (b + 1) * blen - 1
            for k in range(rounds):
                lane_sums = np.cumsum(v[w, k], axis=1) & M32
                lane_pre = (base + np.cumsum(lane_sums[:, 3])
                            - lane_sums[:, 3]) & M32
                sums = (lane_pre[:, None] + lane_sums) & M32
                base = (base + int(lane_sums[:, 3].sum())) & M32
                if blen >= 128:
                    if e < f0 + 128 * k + 128 and e < n:
                        at = e - (f0 + 128 * k)
                        out[b] = sums[at >> 2, at & 3]
                        written[b] += 1
                        b += 1
                        e += blen
                    continue
                for lane in range(32):
                    f = f0 + 128 * k + 4 * lane
                    if f + 4 <= 0 or f >= n:
                        continue
                    r = max(f, 0) // blen
                    at = (r + 1) * blen - 1 - f
                    for q in range(4):
                        if q == at and f + q < n:
                            out[r] = sums[lane, q]
                            written[r] += 1
                            r += 1
                            at += blen
        prefix = (prefix + int(wsum.sum())) & M32
    return out.astype(np.uint32).view(np.int32), written


def test_carry_tile_matches_the_wrapper():
    """The wrapper's CARRY_TILE is the kernel's tile, and its scratch holds
    a status word for every tile at any skew, and the ticket."""
    warps, rounds = _carry_constants()
    assert ops.CARRY_TILE == warps * rounds * 128
    for n in (1, 4093, 16384, 16385, 1 << 24, (1 << 26) + 5):
        for skew in range(4):
            ntiles = (n + skew + ops.CARRY_TILE - 1) // ops.CARRY_TILE
            assert ops.carry_scratch(n) >= ntiles + 1


CARRY_SWEEP = list(range(16))


@pytest.mark.parametrize("seed", CARRY_SWEEP)
def test_carry_tiles_model_the_plain_version(seed):
    """A seeded sweep of (nblocks, blen, skew, tile): the kernel's tile
    arithmetic, modelled in numpy, writes every row end once and gives the
    plain version's sums; the kernel's own tile shape in every fourth."""
    rng = np.random.default_rng(seed)
    if seed % 4 == 3:
        warps, rounds = _carry_constants()
    else:
        warps, rounds = (int(rng.choice([1, 2, 3])),
                         int(rng.choice([1, 2, 4])))
    tile = warps * rounds * 128
    blen = int(rng.choice([0, 1, 2, 3, 4, 127, 128, 129, 1000, tile + 1,
                           3 * tile]))
    nblocks = int(rng.integers(0, 40000 // max(blen, 1) + 2))
    if seed == 0:
        nblocks, blen = 0, 7
    skew = int(rng.integers(0, 4))
    x = rng.integers(-(1 << 31), 1 << 31, (nblocks, blen)).astype(np.int32)
    got, written = _tiled_carry(x, skew, warps, rounds)
    want = ops.probe_carry_ref(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    assert (written == (1 if nblocks * blen else 0)).all()


@pytest.mark.parametrize("trips", [0, 1, 37])
@pytest.mark.parametrize("mode", ops.LOOP_MODES)
def test_loop_ref_against_numpy(mode, trips):
    x = np.random.default_rng(trips).integers(
        -(1 << 31), 1 << 31, (8, 128), dtype=np.int64).astype(np.int32)
    i = np.arange(trips)
    want = {"index": i.sum(), "static": trips * int(x[0, 0])}.get(
        mode, x[i & 7, i & 127].astype(np.int64).sum())
    want = (int(want) + (1 << 31)) % (1 << 32) - (1 << 31)
    got = ops.probe_loop(torch.from_numpy(x),
                         torch.tensor([trips], dtype=torch.int32), mode)
    assert got.tolist() == [want]


def test_loop_ref_periodic_sum_at_a_million():
    x = np.random.default_rng(9).integers(0, 100, (4, 64)).astype(np.int32)
    i = np.arange(1_000_003)
    got = ops.probe_loop(torch.from_numpy(x),
                         torch.tensor([len(i)], dtype=torch.int32), "global")
    assert got.tolist() == [int(x[i & 3, i & 63].sum())]


# ---- (g) store mode's and the loop's kernels, modelled in numpy -----------

def _store_model(x, skew, nbins, threads, cluster, clusters):
    """Store mode's kernel, step for step: the values of x (a view `skew`
    values past a 16-byte boundary) split as the kernel splits them (up to
    3 head values to threads 0-2, whole 16-byte pieces to thread piece %
    nt, the last n % 4 to threads 0-2), each CTA's maxima of the indices
    landing in each bin, the cluster's max of its CTAs', and the global
    max over the clusters' nonzero maxima. Returns (out, the CTAs'
    maxima)."""
    n = x.size
    nt = clusters * cluster * threads
    assert nt >= 4
    head = min(n, (4 - skew) % 4)
    tail = head + 4 * ((n - head) // 4)
    j = np.arange(n)
    tid = np.where(j < head, j,
                   np.where(j >= tail, j - tail, (j - head) // 4 % nt))
    keep = (x >= 0) & (x < nbins)
    ctas = np.zeros((clusters * cluster, nbins), np.int64)
    np.maximum.at(ctas, (tid[keep] // threads, x[keep]), j[keep])
    out = np.zeros(nbins, np.int64)
    for c in ctas.reshape(clusters, cluster, nbins).max(1):
        out[c != 0] = np.maximum(out[c != 0], c[c != 0])
    return out.astype(np.int32), ctas


STORE_SWEEP = list(range(16))


@pytest.mark.parametrize("seed", STORE_SWEEP)
def test_store_mode_model_matches_the_plain_version(seed):
    """A seeded sweep of (n, skew, nbins, grid): ties, values outside [0,
    nbins), views 1-3 values off a 16-byte boundary, and a bin that only
    index 0 reaches (which stays 0). The kernel's own block and cluster in
    every fourth."""
    rng = np.random.default_rng(seed)
    threads, cluster = (_constants("kHistThreads", "kHistCluster")
                        if seed % 4 == 3 else
                        (int(rng.choice([4, 32, 256])),
                         int(rng.choice([1, 2, 4]))))
    clusters = int(rng.choice([1, 2, 3]))
    nbins = int(rng.choice([1, 16, 128, 4096]))
    n = int(rng.choice([0, 1, 3, 5, 999, 20000]))
    skew = seed % 4
    x = rng.integers(-3, nbins + 3, n).astype(np.int32)
    if n > 1 and nbins > 1:  # only index 0 lands in bin `lone`
        lone = int(rng.integers(0, nbins))
        x[x == lone] = -1
        x[0] = lone
    base = torch.from_numpy(np.concatenate([np.zeros(skew, np.int32), x]))
    want = ops.probe_hist_ref(base[skew:], nbins, store=True).numpy()
    got, ctas = _store_model(x, skew, nbins, threads, cluster, clusters)
    assert np.array_equal(got, want)
    assert (ctas.max(0) == got).all()
    if n > 1 and nbins > 1:
        assert got[lone] == 0


def test_store_mode_model_gives_the_jax_probe(jax_runs, monkeypatch):
    """P10 (out[x[i]] = i) through the store model at the kernel's grid
    for 16 values, one cluster, against the TPU probe's recorded output."""
    threads, cluster = _constants("kHistThreads", "kHistCluster")

    def model(x, nbins, store=False):
        assert store
        return torch.from_numpy(_store_model(
            x.numpy(), x.data_ptr() // 4 % 4, nbins, threads, cluster, 1)[0])

    monkeypatch.setattr(feas2, "probe_hist", model)
    inputs, want = jax_runs["feas2"][1][5]
    got = feas2.LAUNCHES[5](*(torch.from_numpy(np.array(a)) for a in inputs))
    assert np.array_equal(got.numpy(), want)


def _loop_entries(rows, cols, start, length, unroll):
    """The table entries the loop kernel reads for the steps [start, start
    + length) of a run (start a multiple of max(rows, cols, unroll)), as it
    computes them: passes of `unroll` steps, each from its first step's
    entry e0 and then e0 + k (cols + 1) where unroll divides rows and cols,
    else each step's own; the last length % unroll steps each their own."""
    def entry(i):
        return (i & (rows - 1)) * cols + (i & (cols - 1))

    passes = length // unroll
    first = start + unroll * np.arange(passes, dtype=np.int64)
    if min(rows, cols) >= unroll:
        e = entry(first)[:, None] + np.arange(unroll) * (cols + 1)
    else:
        e = entry(first[:, None] + np.arange(unroll))
    rest = start + unroll * passes + np.arange(length % unroll)
    return np.concatenate([e.reshape(-1), entry(rest)])


@pytest.mark.parametrize("shape", [(1, 1), (1, 4096), (2, 8), (4, 1024),
                                   (8, 8), (8, 128), (128, 8), (64, 64)])
def test_loop_passes_read_each_steps_entry(shape):
    """A run's passes read, step by step, the entry (i & (rows-1)) * cols
    + (i & (cols-1)) of their own step i."""
    unroll = chip_smoke._constant("kLoopUnroll")
    rows, cols = shape
    q = max(rows, cols, unroll)
    for start in (0, q, 37 * q):
        for length in (0, 1, unroll - 1, unroll, q, 3 * q + 5):
            i = start + np.arange(length)
            want = (i & (rows - 1)) * cols + (i & (cols - 1))
            got = _loop_entries(rows, cols, start, length, unroll)
            assert np.array_equal(got, want), (start, length)


def _loop_model(table, n, mode, threads):
    """The loop kernel over a grid of `threads`, in numpy: each thread's run
    of ceil(n / threads) steps rounded up to a multiple of q = max(rows,
    cols, kLoopUnroll), from thread * run; each run's sum in uint32 from
    the entries its passes read (a run of whole q blocks from q's); the
    CTAs' sums of their kLoopThreads threads; their wrapped total, as
    int32. Returns (total, runs' starts, lengths)."""
    threads_cta, unroll = _constants("kLoopThreads", "kLoopUnroll")
    assert threads % threads_cta == 0
    rows, cols = table.shape
    flat = table.reshape(-1).astype(np.int64)
    q = max(rows, cols, unroll)
    run = (-(-n // threads) + q - 1) // q * q if n > 0 else 0
    starts = np.arange(threads, dtype=np.int64) * run
    lens = np.clip(n - starts, 0, run)
    if mode == "index":
        sums = (2 * starts + lens - 1) * lens // 2
    elif mode == "static":
        sums = lens * flat[0]
    else:
        block = flat[_loop_entries(rows, cols, 0, q, unroll)].sum()
        sums = lens // q * block
        part = lens % q != 0  # at most one thread, the last with steps
        assert part.sum() <= 1
        for t in np.flatnonzero(part):
            sums[t] = flat[_loop_entries(rows, cols, starts[t], lens[t],
                                         unroll)].sum()
    ctas = (sums % (1 << 32)).reshape(-1, threads_cta).sum(1) % (1 << 32)
    total = int(ctas.sum() % (1 << 32))
    return total - (1 << 32) * (total >> 31), starts, lens


# 270336: the H100's grid, 132 SMs x 8 CTAs of 256; 256: a single CTA
LOOP_GRIDS = [256, 270336]
LOOP_TRIPS = ["0", "1", "31", "threads - 1", "threads", "threads + 1",
              "threads x q + 1", "1M", "-5", "2^31 - 1"]


def _trips(name, threads, q):
    return {"0": 0, "1": 1, "31": 31, "threads - 1": threads - 1,
            "threads": threads, "threads + 1": threads + 1,
            "threads x q + 1": threads * q + 1, "1M": 1_000_000, "-5": -5,
            "2^31 - 1": (1 << 31) - 1}[name]


@pytest.mark.parametrize("threads", LOOP_GRIDS)
@pytest.mark.parametrize("trips", LOOP_TRIPS)
@pytest.mark.parametrize("mode", ops.LOOP_MODES)
def test_loop_model_matches_the_plain_version(mode, trips, threads):
    """Each thread's share of the steps for a grid: runs that start at a
    multiple of q and cover [0, trips) once; their sums, wrapped at the
    int32 edges (a table of values near +-2^31), equal the plain closed
    form."""
    unroll = chip_smoke._constant("kLoopUnroll")
    rng = np.random.default_rng(len(trips) + threads)
    table = np.where(rng.integers(0, 2, (8, 128)) == 1,
                     (1 << 31) - 1 - rng.integers(0, 8, (8, 128)),
                     -(1 << 31) + rng.integers(0, 8, (8, 128))
                     ).astype(np.int32)
    n = _trips(trips, threads, max(128, unroll))
    got, starts, lens = _loop_model(table, n, mode, threads)
    assert lens.sum() == max(n, 0)
    assert (starts % max(128, unroll) == 0).all()
    assert (lens[1:] <= lens[:-1]).all()  # runs in order, no gap
    want = ops.probe_loop_ref(torch.from_numpy(table),
                              torch.tensor([n], dtype=torch.int32), mode)
    assert want.tolist() == [got]


@pytest.mark.parametrize("shape", [(1, 1), (4, 1024), (2, 8), (64, 64)])
def test_loop_model_on_other_tables(shape):
    """Narrow tables (each step's own entry) and wide ones, against a numpy
    loop over every step."""
    rng = np.random.default_rng(shape[0])
    table = rng.integers(-(1 << 31), 1 << 31, shape).astype(np.int32)
    n = 300_007
    i = np.arange(n)
    step = table[i & (shape[0] - 1), i & (shape[1] - 1)].astype(np.int64)
    want = int(step.sum() % (1 << 32))
    want -= (1 << 32) * (want >> 31)
    for threads in LOOP_GRIDS:
        assert _loop_model(table, n, "global", threads)[0] == want


LOOP_LAUNCHES = [("feas", 1), ("feas4", 0), ("feas4", 1), ("feas4", 2)]


@pytest.mark.parametrize("threads", LOOP_GRIDS)
@pytest.mark.parametrize("script,i", LOOP_LAUNCHES,
                         ids=[f"{s}-{i}" for s, i in LOOP_LAUNCHES])
def test_loop_model_gives_the_jax_probes(jax_runs, monkeypatch, script, i,
                                         threads):
    """P2 and P14-A/B/C through the loop model against the TPU probes'
    recorded outputs."""
    def model(table, trips, mode):
        got = _loop_model(table.numpy(), int(trips.reshape(-1)[0]), mode,
                          threads)[0]
        return torch.tensor([got], dtype=torch.int32)

    monkeypatch.setattr(SCRIPTS[script], "probe_loop", model)
    inputs, want = jax_runs[script][1][i]
    got = SCRIPTS[script].LAUNCHES[i](*(torch.from_numpy(np.array(a))
                                        for a in inputs))
    assert np.array_equal(got.numpy().astype(np.int64),
                          want.astype(np.int64))


_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_117probe_loop_kernelILi2EEEvPKiiiiS1_Pj
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;  /* 0x000 */
        /*0010*/                   LDG.E.CONSTANT R2, desc[UR4][R4.64] ;
        /*0020*/                   LDG.E.CONSTANT R3, desc[UR4][R4.64+0x4] ;
        /*0030*/                   IADD3 R6, R2, R6, R3 ;
        /*0040*/               @P0 BRA 0x10 ;
        /*0050*/                   BRA 0x60 ;
        /*0060*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_117probe_loop_kernelILi3EEEvPKiiiiS1_Pj
        /*0000*/                   S2R R0, SR_TID.X ;
.L_x_1:
        /*0010*/                   LDS R2, [R0] ;
        /*0020*/                   LDS R3, [R0+0x4] ;
        /*0030*/              @!P1 BRA `(.L_x_1) ;
\t\tFunction : _ZN12_GLOBAL__N_117probe_hist_kernelILb1EEEvPKixiPi
        /*0000*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0010*/                   BRA 0x0 ;
"""


def test_loop_sass_reads_each_loop(tmp_path, monkeypatch):
    """chip_smoke.loop_sass: the loads and IADD3s from each backward
    branch's target to the branch, in both of cuobjdump's branch forms,
    for the loop kernel's instances only."""
    (tmp_path / "sass.txt").write_text(_SASS)
    fake = tmp_path / "cuobjdump"
    fake.write_text(f"#!/bin/sh\ncat {tmp_path / 'sass.txt'}\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(tmp_path / "nvcc"))
    assert chip_smoke.loop_sass("lib.so") == {"global": [(2, 0, 1)],
                                              "shared": [(0, 2, 0)]}


# ---- (f) the pack kernel's byte-to-bit step, replayed in numpy ------------

def _kernel_constants():
    """kLow7, kHigh, kGather and kGatherShift as csrc/probes.cu defines
    them."""
    with open(os.path.join(REPO, "fastk_tpu_torch", "csrc",
                           "probes.cu")) as f:
        src = f.read()
    out = {}
    for name in ("kLow7", "kHigh", "kGather", "kGatherShift"):
        m = re.search(rf"constexpr (?:unsigned|int) {name} = "
                      r"(0x[0-9a-fA-F]+|\d+)u?;", src)
        assert m, name
        out[name] = int(m.group(1), 0)
    return out


def _replay_pack(mask: np.ndarray, width: int) -> np.ndarray:
    """The kernel's pack of whole 32-byte groups, step for step in uint32
    arithmetic: nib4 on each little-endian 4-byte word, the eight nibbles of
    a group (pack16 of its two 16-byte loads) shifted by 4k into one word,
    which width 16 stores as its low and high halves."""
    c = _kernel_constants()
    w = mask.reshape(-1, 8, 4).copy().view("<u4")[..., 0].astype(np.uint64)
    hi = (((w & c["kLow7"]) + c["kLow7"]) | w) & c["kHigh"]
    nib = ((hi * c["kGather"]) & 0xFFFFFFFF) >> c["kGatherShift"]
    assert nib.max() < 16
    b = (nib << (4 * np.arange(8, dtype=np.uint64))).sum(1)
    if width == 16:
        b = np.stack([b & 0xFFFF, b >> 16], 1).reshape(-1)
    return b.astype(np.uint32)


def _byte_patterns(kind: str) -> np.ndarray:
    if kind == "every 8 bytes of {0, 1, 2, 255}":
        digits = (np.arange(4 ** 8)[:, None] >> (2 * np.arange(8))) & 3
        return np.array([0, 1, 2, 255], np.uint8)[digits].reshape(-1)
    # every byte value at every place of a word, the other three 0 or 255
    out = []
    for fill in (0, 255):
        words = np.full((256, 4, 4), fill, np.uint8)
        for j in range(4):
            words[:, j, j] = np.arange(256)
        out.append(words.reshape(-1))
    return np.concatenate(out)


@pytest.mark.parametrize("width", [16, 32])
@pytest.mark.parametrize("kind", ["every 8 bytes of {0, 1, 2, 255}",
                                  "every byte value at every place"])
def test_pack_byte_step_replay(kind, width):
    """Each mask byte becomes one bit, set when the byte is not 0, by the
    kernel's own constants: the same words as the plain pack of bytes != 0."""
    mask = _byte_patterns(kind)
    assert mask.size % 32 == 0
    want = ops.probe_bits_ref(torch.from_numpy(mask != 0), "pack", width)
    assert np.array_equal(_replay_pack(mask, width),
                          want.numpy().view(np.uint32))


# ---- dispatch, arguments and the build ------------------------------------

def test_other_devices_and_bad_arguments_raise():
    meta = torch.empty(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.probe_hist(meta, 16)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.probe_bits(meta, "walk")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.probe_carry(meta.reshape(2, 8))
    x = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="nbins"):
        ops.probe_hist(x, ops.MAX_BINS + 1)
    with pytest.raises(ValueError, match="int32"):
        ops.probe_hist(x.long(), 16)
    with pytest.raises(ValueError, match="powers of two"):
        ops.probe_loop(torch.zeros((3, 4), dtype=torch.int32),
                       torch.ones(1, dtype=torch.int32), "global")
    with pytest.raises(ValueError, match="width"):
        ops.probe_bits(torch.zeros(24, dtype=torch.bool), "pack", 16)
    with pytest.raises(ValueError, match="mode"):
        ops.probe_bits(x, "popc")
    with pytest.raises(ValueError, match="CUDA table"):
        ops.loop_threads(torch.zeros((8, 128), dtype=torch.int32), "global")


def test_cpu_tensors_never_launch():
    before = [k.launches for k in ops.KERNELS]
    feas.main(device="cpu")
    assert [k.launches for k in ops.KERNELS] == before


def test_probes_module_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: python -m fastk_tpu_torch.probes "
                    "runs (tests/test_torch_gpu.py)")
    r = subprocess.run([sys.executable, "-m", "fastk_tpu_torch.probes"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert " OK " not in r.stdout


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """One nvcc -c a source, then one link into the library; the objects
    are removed, and the compilers' output is kept as its .log."""
    log = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$*" >> {log}\n'
        'while [ $# -gt 0 ]; do [ "$1" = -o ] && out=$2; shift; done\n'
        'echo built > "$out"\n'
        'echo "ptxas info    : Used 1 registers"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("NVCC", str(fake))
    monkeypatch.setattr(_kernels, "BUILD", str(tmp_path / "build"))
    so = _kernels.build()
    calls = log.read_text().splitlines()
    srcs = _kernels.sources()
    assert {os.path.basename(s) for s in srcs} >= {"run_hist.cu",
                                                   "probes.cu"}
    assert len(calls) == len(srcs) + 1
    assert all(" -c " in c for c in calls[:-1])
    assert sorted(c.split()[-1] for c in calls[:-1]) == sorted(srcs)
    assert " -shared " in calls[-1] and " -c " not in calls[-1]
    assert sorted(os.listdir(tmp_path / "build")) == [
        os.path.basename(so), os.path.basename(so) + ".log"]
    with open(so + ".log") as f:
        assert f.read().count("Used") == len(srcs)
    assert _kernels.build() == so  # built once: the next call only looks
    assert len(log.read_text().splitlines()) == len(calls)
