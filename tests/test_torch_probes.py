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


def _carry_constants():
    """kCarryThreads / 32 (the warps of a tile) and kCarryRounds (a
    warp's rounds of 32 x 4 values) of csrc/probes.cu."""
    with open(os.path.join(REPO, "fastk_tpu_torch", "csrc",
                           "probes.cu")) as f:
        src = f.read()
    threads = re.search(r"constexpr int kCarryThreads = (\d+);", src)
    rounds = re.search(r"constexpr int kCarryRounds = (\d+);", src)
    assert threads and rounds
    return int(threads.group(1)) // 32, int(rounds.group(1))


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
