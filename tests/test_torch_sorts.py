"""The port of benchmarks/_r3sort.py, _sortexp2.py, _sortexp3.py,
_sortsweep.py and _hashsort.py (fastk_tpu_torch/probes/sorts.py) against the
JAX expressions of their cases on the CPU, the uint64 ones under
jax.enable_x64: the same numpy inputs through both, compared exactly (an
unstable sort's carried values as records); mix64 bit for bit; the forced
hash collision's fallback; main's lines; no silent fallback to the CPU."""

import io
import os
import re
from contextlib import nullcontext, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastk_tpu.ops.count as jcount
from fastk_tpu.ops.kmers import canonical_kmers
from fastk_tpu.ops.pack import unpack_words
from fastk_tpu_torch.probes import sorts
from fastk_tpu_torch.probes.common import K, Sorted, bench_batch, same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SIZE = 1 << 16
M32 = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel workers, where
    torch's thread pools would only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(k) -> tuple:
    """A uint64 key column -> its two 32-bit word columns."""
    k = np.asarray(k)
    return (k >> np.uint64(32)).astype(np.int64), (k & np.uint64(M32)
                                                   ).astype(np.int64)


def _sorted(out, nkeys: int, stable=False, fused=()) -> Sorted:
    """A lax.sort output as Sorted: its first nkeys operands are the keys,
    those listed in `fused` uint64 keys split into words."""
    keys = []
    for i, o in enumerate(out[:nkeys]):
        keys += _split(o) if i in fused else [np.asarray(o)]
    return Sorted(tuple(keys), tuple(np.asarray(v) for v in out[nkeys:]),
                  stable)


def _rows(out, nkeys: int, fused=()) -> Sorted:
    """A (B, L) row sort's output: the row index, then its key words."""
    B, L = out[0].shape
    cols = [np.repeat(np.arange(B), L)]
    for i, o in enumerate(out[:nkeys]):
        o = np.asarray(o).reshape(-1)
        cols += _split(o) if i in fused else [o]
    return Sorted(tuple(cols))


def _fuse(a, b):
    return (a.astype(jnp.uint64) << 32) | b.astype(jnp.uint64)


def jax_mix64(w0, w1, w2):
    """benchmarks/_hashsort.py's mix64, word for word."""
    a = w0 * np.uint32(0x85EBCA6B) ^ (w1 * np.uint32(0xC2B2AE35)) ^ \
        (w2.astype(jnp.uint32) * np.uint32(0x27D4EB2F))
    b = w0 * np.uint32(0x165667B1) ^ (w1 * np.uint32(0x9E3779B9)) ^ \
        (w2.astype(jnp.uint32) * np.uint32(0x5851F42D))
    a ^= a >> 16; a = a * np.uint32(0x7FEB352D); a ^= a >> 15  # noqa: E702
    a = a * np.uint32(0x846CA68B); a ^= a >> 16  # noqa: E702
    b ^= b >> 16; b = b * np.uint32(0x7FEB352D); b ^= b >> 15  # noqa: E702
    b = b * np.uint32(0x846CA68B); b ^= b >> 16  # noqa: E702
    return a, b


def jax_sort_hash(f):
    h0, h1 = jax_mix64(*f)
    inv = (f[0] == np.uint32(M32)) & (f[1] == np.uint32(M32)) & (
        f[2] == np.uint16(0xFFFF))
    h0 = jnp.where(inv, np.uint32(M32), h0)
    h1 = jnp.where(inv, np.uint32(M32), h1)
    return jax.lax.sort((h0, h1, *f), num_keys=2, is_stable=False)


def jax_flag(out, size):
    s0, s1, w0, w1, w2 = out
    hash_eq = (s0 == jnp.roll(s0, 1)) & (s1 == jnp.roll(s1, 1))
    words_ne = (w0 != jnp.roll(w0, 1)) | (w1 != jnp.roll(w1, 1)) | \
        (w2 != jnp.roll(w2, 1))
    return s0[-1], jnp.any(hash_eq & words_ne & (jnp.arange(size) > 0))


def jax_mxu_hist(v, chunk):
    """benchmarks/_sortexp2.py's pair histogram."""
    vv = v.reshape(-1, chunk)
    span_hi = jnp.arange(128, dtype=jnp.int32)
    span_lo = jnp.arange(256, dtype=jnp.int32)

    def body(acc, cv):
        hi = (cv >> 8).astype(jnp.int32)
        lo = (cv & 255).astype(jnp.int32)
        oh_hi = (hi[:, None] == span_hi[None, :]).astype(jnp.int8)
        oh_lo = (lo[:, None] == span_lo[None, :]).astype(jnp.int8)
        h = jax.lax.dot_general(oh_hi, oh_lo, (((0,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
        return acc + h, None

    acc, _ = jax.lax.scan(body, jnp.zeros((128, 256), jnp.int32), vv)
    return acc.reshape(-1)


def _hist_rows(v, rows, nbins=32768):
    sv = jax.lax.sort((v.reshape(rows, -1),), num_keys=1, dimension=-1)[0]
    e = jnp.arange(nbins + 1, dtype=sv.dtype)
    ed = jax.vmap(lambda row: jnp.searchsorted(row, e))(sv)
    return (ed[:, 1:] - ed[:, :-1]).astype(jnp.int32).sum(axis=0)


def _jax_cases(size: int) -> dict:
    """Every case's JAX expression, by the port's case name."""
    x = sorts.sort_inputs(size)
    u32 = {k: jnp.asarray(x[k].astype(np.uint32)) for k in ("w0", "w1", "w2")}
    w0, w1, w2 = u32["w0"], u32["w1"], u32["w2"]
    w2_16 = jnp.asarray(x["w2_16"].astype(np.uint16))
    u16v = jnp.asarray(x["u16v"].astype(np.uint16))
    vals = jnp.asarray(x["vals"].astype(np.uint16))
    n23 = min(size, 1 << 23)
    srt = jax.lax.sort
    out = {}

    def put(script, label, fn):
        out[f"{script}: {label}"] = fn

    s = "_r3sort.py"
    put(s, "a) 3-key (u32,u32,u16)",
        lambda: _sorted(srt((w0, w1, w2_16), num_keys=3), 3))
    put(s, "b) 2-key (u32,u32) + u16 value",
        lambda: _sorted(srt((w0, w1, w2_16), num_keys=2), 2))
    put(s, "c) 2-key (u32,u32)", lambda: _sorted(srt((w0, w1), num_keys=2), 2))
    put(s, "d) 1-key u16", lambda: _sorted(srt((w2_16,), num_keys=1), 1))
    put(s, "e) 1-key u32 + u32,u16 values",
        lambda: _sorted(srt((w0, w1, w2_16), num_keys=1), 1))
    put(s, "f) 1-key u16 at 2^23",
        lambda: _sorted(srt((w2_16[:n23],), num_keys=1), 1))

    s = "_sortexp2.py"
    put(s, "null (sync latency)", lambda: jnp.sum(w0[:8]))
    put(s, "sort (u32,u32,u16) 3key",
        lambda: _sorted(srt((w0, w1, w2_16), num_keys=3), 3))
    put(s, "sort (u32,u32) 2key", lambda: _sorted(srt((w0, w1), num_keys=2), 2))
    put(s, "sort (u32) 1key", lambda: _sorted(srt((w0,), num_keys=1), 1))
    put(s, "sort (u16) 1key", lambda: _sorted(srt((w2_16,), num_keys=1), 1))
    put(s, "sort (u32 key)+u32 val",
        lambda: _sorted(srt((w0, w1), num_keys=1), 1))
    for B in (4, 16, 64, 256):
        put(s, f"row sort ({B}, {size // B}) 3key", lambda B=B: _rows(srt(
            tuple(a.reshape(B, -1) for a in (w0, w1, w2_16)), dimension=1,
            num_keys=3), 3))
    put(s, "bincount_by_sort 32769",
        lambda: jcount.bincount_by_sort(vals, 32769))
    put(s, "mxu pair-hist 32768 (chunk 512K)",
        lambda: jax_mxu_hist(vals, min(size, 1 << 19)))
    put(s, "mxu pair-hist 32768 (chunk 64K)",
        lambda: jax_mxu_hist(vals, min(size, 1 << 16)))

    s = "_sortexp3.py"
    put(s, "null (sync latency)", lambda: jnp.sum(w0[:8]))
    put(s, "sort (u64) 1key [fuse incl]",
        lambda: _sorted(srt((_fuse(w0, w1),), num_keys=1), 1, fused=(0,)))
    put(s, "sort (u64,u16) 2key", lambda: _sorted(
        srt((_fuse(w0, w1), w2_16), num_keys=2), 2, fused=(0,)))
    put(s, "sort (u64)+u16 val", lambda: _sorted(
        srt((_fuse(w0, w1), w2_16), num_keys=1), 1, fused=(0,)))
    put(s, "sort (u64,u64) 2key", lambda: _sorted(
        srt((_fuse(w0, w1), _fuse(w1, w0)), num_keys=2), 2, fused=(0, 1)))
    put(s, "sort (u32)+1 u32 val",
        lambda: _sorted(srt((w0, w1), num_keys=1), 1))
    put(s, "sort (u32)+2 vals",
        lambda: _sorted(srt((w0, w1, w2_16), num_keys=1), 1))
    put(s, "sort stable (u32)+2 vals", lambda: _sorted(
        srt((w0, w1, w2_16), num_keys=1, is_stable=True), 1, stable=True))
    put(s, "sort stable (u8)+3 vals", lambda: _sorted(
        srt(((w0 & 255).astype(jnp.uint8), w0, w1, w2_16), num_keys=1,
            is_stable=True), 1, stable=True))
    for B in (64, 256, 1024):
        put(s, f"row sort ({B},{size // B}) (u64,u16) 2key",
            lambda B=B: _rows(srt((_fuse(w0, w1).reshape(B, -1),
                                   w2_16.reshape(B, -1)), dimension=1,
                                  num_keys=2), 2, fused=(0,)))
    put(s, "u16 1key sort alone", lambda: _sorted(srt((vals,), num_keys=1), 1))
    put(s, "searchsorted 32770 edges in 64M", lambda: jnp.searchsorted(
        srt((vals,), num_keys=1)[0], jnp.arange(32770, dtype=jnp.uint16)))

    s = "_sortsweep.py"
    h16 = (u16v & 0x7FFF).astype(jnp.uint16)
    sweep = {
        "s3x32": lambda: _sorted(srt((w0, w1, w2), num_keys=3), 3),
        "s32_32_16": lambda: _sorted(srt((w0, w1, w2_16), num_keys=3), 3),
        "s64_16": lambda: _sorted(srt((_fuse(w0, w1), w2_16), num_keys=2), 2,
                                  fused=(0,)),
        "s64_32": lambda: _sorted(srt((_fuse(w0, w1), w2), num_keys=2), 2,
                                  fused=(0,)),
        "s64": lambda: _sorted(srt((_fuse(w0, w1),), num_keys=1), 1,
                               fused=(0,)),
        "s32": lambda: _sorted(srt((w0,), num_keys=1), 1),
        "s16": lambda: _sorted(srt((u16v,), num_keys=1), 1),
        "s3x32_b64": lambda: _rows(srt(tuple(
            a.reshape(64, -1) for a in (w0, w1, w2)), num_keys=3,
            dimension=-1), 3),
        "s64_16_b64": lambda: _rows(srt(
            (_fuse(w0, w1).reshape(64, -1), w2_16.reshape(64, -1)),
            num_keys=2, dimension=-1), 2, fused=(0,)),
        "hist_flat": lambda: _hist_rows(h16, 1),
        "hist_b256": lambda: _hist_rows(h16, 256),
    }
    for R in (64, 256, 1024):
        sweep[f"s16_b{R}"] = lambda R=R: _rows(
            srt((u16v.reshape(R, -1),), num_keys=1, dimension=-1), 1)
    for c, label in sorts.SWEEP.items():
        rows = int(c.split("_b")[1]) if "_b" in c else 1
        put(s, label.format(c=size // rows), sweep[c])

    s = "_hashsort.py"
    pw, exc, total = bench_batch(size)
    codes = unpack_words(jnp.asarray(pw), jnp.asarray(exc), total)
    words, invalid = canonical_kmers(codes, K, size)
    f = jcount.narrow_words(jcount.fold_invalid(words, invalid), K)

    def hashed():
        h = jax_sort_hash(f)
        return Sorted(tuple(np.asarray(o) for o in h[:2]),
                      tuple(np.asarray(o) for o in jcount.widen_words(
                          tuple(h[2:]), K)))

    put(s, "a) 3-key sort (current)", lambda: Sorted(tuple(
        np.asarray(w) for w in jcount.widen_words(
            tuple(srt(f, num_keys=3)), K))))
    put(s, "c) hash 2-key sort + 3 values", hashed)
    put(s, "b) hash sort + collision flag",
        lambda: jax_flag(jax_sort_hash(f), size))
    put(s, "d) old hist_batch end-to-end",
        lambda: jcount.hist_batch(codes, K, size))
    put(s, "e) hash hist end-to-end", lambda: dict(
        jcount.hist_batch(codes, K, size),
        coll=jax_flag(jax_sort_hash(f), size)[1]))
    return out


@pytest.fixture(scope="module")
def run():
    return dict(port=dict(sorts.cases(CPU, SIZE)), jax=_jax_cases(SIZE))


def _names(size: int) -> list:
    names = []
    for s, labels in [
            ("_r3sort.py", ["a) 3-key (u32,u32,u16)",
                            "b) 2-key (u32,u32) + u16 value",
                            "c) 2-key (u32,u32)", "d) 1-key u16",
                            "e) 1-key u32 + u32,u16 values",
                            "f) 1-key u16 at 2^23"]),
            ("_sortexp2.py", ["null (sync latency)", "sort (u32,u32,u16) 3key",
                              "sort (u32,u32) 2key", "sort (u32) 1key",
                              "sort (u16) 1key", "sort (u32 key)+u32 val"]
             + [f"row sort ({B}, {size // B}) 3key" for B in (4, 16, 64, 256)]
             + ["bincount_by_sort 32769", "mxu pair-hist 32768 (chunk 512K)",
                "mxu pair-hist 32768 (chunk 64K)"]),
            ("_sortexp3.py", ["null (sync latency)",
                              "sort (u64) 1key [fuse incl]",
                              "sort (u64,u16) 2key", "sort (u64)+u16 val",
                              "sort (u64,u64) 2key", "sort (u32)+1 u32 val",
                              "sort (u32)+2 vals", "sort stable (u32)+2 vals",
                              "sort stable (u8)+3 vals"]
             + [f"row sort ({B},{size // B}) (u64,u16) 2key"
                for B in (64, 256, 1024)]
             + ["u16 1key sort alone", "searchsorted 32770 edges in 64M"]),
            ("_sortsweep.py", [label.format(c=size // (
                int(c.split("_b")[1]) if "_b" in c else 1))
                for c, label in sorts.SWEEP.items()]),
            ("_hashsort.py", ["a) 3-key sort (current)",
                              "c) hash 2-key sort + 3 values",
                              "b) hash sort + collision flag",
                              "d) old hist_batch end-to-end",
                              "e) hash hist end-to-end"])]:
        names += [f"{s}: {label}" for label in labels]
    return names


NAMES = _names(SIZE)


def test_case_names_are_the_scripts():
    assert [n for n, _ in sorts.cases(CPU, SIZE)] == NAMES
    for script in ("_r3sort.py", "_sortexp2.py", "_sortexp3.py",
                   "_sortsweep.py", "_hashsort.py"):
        with open(os.path.join(REPO, "benchmarks", script)) as f:
            src = f.read()
        for n in NAMES:
            s, label = n.split(": ", 1)
            if s != script:
                continue
            if label.startswith("row sort ("):  # formatted by the script
                label = "row sort ("
            label = re.sub(r" \d+x\d+$", " ", label)
            assert label in src, (script, label)


X64 = ("_sortexp3.py", "_sortsweep.py")  # the scripts that run in x64


@pytest.mark.parametrize("name", NAMES)
def test_case_matches_jax(run, name):
    script = name.split(": ")[0]
    with jax.enable_x64(True) if script in X64 else nullcontext():
        want = run["jax"][name]()
    got = run["port"][name]()
    if name.endswith("e) hash hist end-to-end"):
        assert bool(got["coll"]) == bool(want.pop("coll"))
        got = dict(hist=got["hist"], nvalid=got["nvalid"])
    if "null" in name and script not in X64:  # a uint32 sum wraps
        got = int(got) & M32
    assert same(got, want)


def test_mix64_bit_for_bit():
    """mix64's halves against the script's uint32 arithmetic, on random
    words, the narrowed last word of a k = 40 key, and the edges."""
    rng = np.random.default_rng(7)
    n = 1 << 14
    w = [rng.integers(0, 1 << 32, n, dtype=np.int64) for _ in range(2)]
    w2 = rng.integers(0, 1 << 16, n, dtype=np.int64)
    for a in (w[0], w[1]):
        a[:4] = [0, 1, M32 - 1, M32]
    w2[:4] = [0, 1, 0xFFFE, 0xFFFF]
    got = sorts.mix64(*(torch.from_numpy(x) for x in (w[0], w[1], w2)))
    want = jax_mix64(jnp.asarray(w[0].astype(np.uint32)),
                     jnp.asarray(w[1].astype(np.uint32)),
                     jnp.asarray(w2.astype(np.uint16)))
    for g, wt in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(wt).astype(np.int64))
    # the script's front end cancels bit 31 of w0 and w1 together
    flip = [torch.from_numpy(w[0] ^ (1 << 31)), torch.from_numpy(
        w[1] ^ (1 << 31)), torch.from_numpy(w2)]
    assert all(torch.equal(a, b) for a, b in zip(sorts.mix64(*flip), got))


def test_forced_collision_falls_back(monkeypatch):
    """Every valid key hashed alike: the flag is set and hash_hist bins
    sort_keys' order, the JAX package's histogram exactly."""
    monkeypatch.setattr(sorts, "mix64", lambda a, b, c: (
        torch.zeros_like(a), torch.zeros_like(a)))
    pw, exc, total = bench_batch(SIZE)
    pd = torch.from_numpy(pw.view(np.int32))
    excd = torch.from_numpy(exc.view(np.int32))
    got = sorts.hash_hist(pd, excd, total, SIZE)
    codes = unpack_words(jnp.asarray(pw), jnp.asarray(exc), total)
    want = jcount.hist_batch(codes, K, SIZE)
    assert bool(got["coll"]) and int(got["ncoll"]) > 0
    assert np.array_equal(got["hist"].numpy(), np.asarray(want["hist"]))
    assert got["nvalid"] == int(want["nvalid"])
    # without the fallback the one run of every valid key would be binned
    f, _ = sorts.folded_keys(pd, excd, total, SIZE)
    assert sorts.sort_hash_flag(f)[1]


def test_layouts_match_sort_keys():
    sections = sorts._sections(CPU, 1 << 12)
    assert sorts.layout_mismatches(sections) == []
    n = sum(layout is not None for *_, layout in sections)
    assert n == 15  # the row sorts, the stable sorts, the hash grouping


def test_layout_mismatch_is_reported(monkeypatch):
    real = sorts.sort_rows
    monkeypatch.setattr(sorts, "sort_rows", lambda w, r: real(
        tuple(x ^ 1 for x in w), r) if r == 4 else real(w, r))
    bad = sorts.layout_mismatches(sorts._sections(CPU, 1 << 12))
    assert bad == ["_sortexp2.py: row sort (4, 1024) 3key"]


def test_main_reports_a_layout_mismatch(monkeypatch):
    """main holds the layouts against sort_keys on every run, prints those
    that differ and returns them (the module's command then exits 1)."""
    real = sorts.sort_rows
    monkeypatch.setattr(sorts, "sort_rows", lambda w, r: real(
        tuple(x ^ 1 for x in w), r) if r == 16 else real(w, r))
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = sorts.main("cpu", size=1 << 12, sweep=())
    assert res["mismatches"] == ["_sortexp2.py: row sort (16, 256) 3key"]
    assert buf.getvalue().splitlines()[-1] == (
        "layouts unlike sort_keys': ['_sortexp2.py: row sort (16, 256) "
        "3key']   [cpu]")


def test_main_cpu_lines():
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = sorts.main("cpu", size=1 << 12)
    lines = buf.getvalue().splitlines()
    assert res["failed"] == [] and res["mxu_correct"] is True
    assert res["mismatches"] == []
    assert lines[0] == "n = 4096 platform: cpu   [cpu]"
    labels = [n.split(": ", 1)[1] for n in _names(1 << 12)]
    timed = [ln for ln in lines[1:] if ln.endswith(" ms   [cpu]")]
    assert [re.sub(r"\s+[\d.]+ ms\s+\[cpu\]$", "", ln)
            for ln in timed] == labels
    assert "mxu hist correct: True   [cpu]" in lines
    assert any(ln.startswith("mxu chunk product int8 (right operand "
                             "row-major ") for ln in lines)
    assert any(ln.startswith("hash collisions on the bench batch: ")
               for ln in lines)
    assert list(res["times"]) == _names(1 << 12)


def test_sweep_failure_is_a_failed_line(monkeypatch):
    monkeypatch.setattr(sorts, "bincount_rows", lambda *a: 1 / 0)
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = sorts.main("cpu", size=1 << 12, sweep=("s32", "hist_b256"))
    assert res["failed"] == ["hist 32k: batched 256 rows sort+ss"]
    assert "FAILED: ZeroDivisionError" in buf.getvalue()


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(RuntimeError, match="cuda"):
        sorts.main()
    assert buf.getvalue() == ""
