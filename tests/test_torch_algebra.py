"""The port's table algebra and library merge against the JAX package's, on
random tables made from numpy seeds: parse trees and parse errors, the RPN
programs of the native evaluator, ``merge_universe``, ``logex_apply``,
``logex_apply_streamed``, ``merge_tables`` and ``merge_streamed``. The port
runs with ``device="cpu"``, below and above ``DEVICE_MIN_ROWS`` (patched
low, so that its torch merge runs here as well as its numpy one).
Tolerance: none."""

import os

import numpy as np
import pytest

import fastk_tpu.algebra as jalg
import fastk_tpu.formats.ktab as jktab
import fastk_tpu.tools.fastmerge as jfm
import fastk_tpu_torch.algebra as talg
import fastk_tpu_torch.formats.ktab as tktab
import fastk_tpu_torch.ops.tables as ttables
import fastk_tpu_torch.tools.fastmerge as tfm

from test_torch_tools import ALL_SHAPES


def _rand_table(mod, n, k, seed, dense=False):
    """A sorted table of up to n distinct k-mers; dense keys (few bytes of
    entropy) make the tables of different seeds overlap heavily."""
    rng = np.random.default_rng(seed)
    kb = (k + 3) // 4
    hi = 4 if dense else 256
    packed = rng.integers(0, hi, (n, kb), dtype=np.uint8)
    if k % 4:
        packed[:, -1] &= (0xFF << (2 * (4 - k % 4))) & 0xFF
    view = np.ascontiguousarray(packed).view(f"S{kb}").ravel()
    _, idx = np.unique(view, return_index=True)
    packed = packed[np.sort(idx)]
    view = np.ascontiguousarray(packed).view(f"S{kb}").ravel()
    packed = packed[np.argsort(view, kind="stable")]
    counts = rng.integers(1, 3000, len(packed)).astype(np.uint16)
    counts[rng.random(len(counts)) < 0.01] = 32767
    return mod.KmerTable(k, 1, packed, counts)


def _tables(mod, k, seed):
    return [_rand_table(mod, 700 + 211 * i, k, 10 * seed + i,
                        dense=(i != 1)) for i in range(3)]


@pytest.fixture(params=["numpy", "torch"])
def merge_branch(request, monkeypatch):
    """The port's merge_counted below DEVICE_MIN_ROWS (numpy) and, with
    the threshold patched to 1, its torch merge on the CPU."""
    if request.param == "torch":
        monkeypatch.setattr(ttables, "DEVICE_MIN_ROWS", 1)
    return request.param


def _tree(n):
    if n is None:
        return None
    return (n.op, n.mode, _tree(n.lft), _tree(n.rgt), n.var,
            None if n.ranges is None else [tuple(r) for r in n.ranges])


EXPRESSIONS = [e for _, e in ALL_SHAPES] + [
    "A &. B", "A |+ B", "A - B", "A ^ B", "(A &> B)[5-20]", "A{40-60}",
    "#A |+ #B", "(A |* B)[2-]", "(A-B) |. (A &. B)", "#(A & B)",
    "(A & B)[1-5]", "A[-7,3-9, 100-]", "a|+b", " ( A |. B ) - C ",
    "A[3]{0-100}[2-]", "##A", "A|+B|+C|+D|+E|+F|+G|+H",
]


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_parse_expression(expr):
    got = talg.parse_expression(expr, 8)
    assert _tree(got) == _tree(jalg.parse_expression(expr, 8))
    assert talg.vars_referenced(expr, 8) == jalg.vars_referenced(expr, 8)
    prog = talg.compile_program(got)
    want = jalg.compile_program(jalg.parse_expression(expr, 8))
    assert np.array_equal(prog, want) and prog.dtype == want.dtype
    assert talg.solo_ok_mask([got], 8) == jalg.solo_ok_mask(
        [jalg.parse_expression(expr, 8)], 8)


BAD = [("A & B", 2), ("A &+ C", 2), ("A &+ (B", 2), ("A |+ B)", 2),
       ("A &x B", 2), ("A[5-", 1), ("A[]", 1), ("A{x}", 1), ("", 1),
       ("A B", 2), ("A |+ 3", 1), ("(A | B) |+ A", 2)]


@pytest.mark.parametrize("expr,ntabs", BAD)
def test_parse_errors(expr, ntabs):
    with pytest.raises(jalg.ParseError) as want:
        jalg.parse_expression(expr, ntabs)
    with pytest.raises(talg.ParseError) as got:
        talg.parse_expression(expr, ntabs)
    assert str(got.value) == str(want.value)
    assert got.value.pos == want.value.pos


@pytest.mark.parametrize("k,seed", [(40, 0), (16, 1), (13, 2)])
def test_merge_universe(merge_branch, k, seed):
    tabs_t, tabs_j = _tables(tktab, k, seed), _tables(jktab, k, seed)
    uni, cvecs = talg.merge_universe(tabs_t, device="cpu")
    uni_j, cvecs_j = jalg.merge_universe(tabs_j)
    assert np.array_equal(uni, uni_j) and uni.dtype == uni_j.dtype
    assert len(cvecs) == 3
    for a, b in zip(cvecs, cvecs_j):
        assert np.array_equal(a, b) and a.dtype == b.dtype


@pytest.mark.parametrize("seed", [0, 1])
def test_logex_apply(merge_branch, seed):
    tabs_t, tabs_j = _tables(tktab, 40, seed), _tables(jktab, 40, seed)
    got = talg.logex_apply(ALL_SHAPES, tabs_t, (2, 120), device="cpu")
    want = jalg.logex_apply(ALL_SHAPES, tabs_j, (2, 120))
    assert len(got) == len(want) == len(ALL_SHAPES)
    for (n, t, h), (nj, tj, hj) in zip(got, want):
        assert n == nj
        assert np.array_equal(t.packed, tj.packed), n
        assert np.array_equal(t.counts, tj.counts), n
        assert (t.kmer, t.minval) == (tj.kmer, tj.minval)
        assert np.array_equal(h.counts, hj.counts), n
        assert (h.low, h.high, h.ilowcnt, h.ihighcnt, h.unique) == (
            hj.low, hj.high, hj.ilowcnt, hj.ihighcnt, hj.unique), n


def test_logex_apply_without_histogram():
    tabs_t, tabs_j = _tables(tktab, 40, 3), _tables(jktab, 40, 3)
    (_, t, h), = talg.logex_apply([("x", "A&+B")], tabs_t, device="cpu")
    (_, tj, _), = jalg.logex_apply([("x", "A&+B")], tabs_j)
    assert h is None and np.array_equal(t.packed, tj.packed)
    with pytest.raises(ValueError, match="different k-mer sizes"):
        talg.logex_apply([("x", "A|+B")], [tabs_t[0], _rand_table(
            tktab, 50, 16, 0)], device="cpu")


@pytest.mark.parametrize("slice_spec", [None, (1, 3), (2, 3), (3, 3)])
def test_merge_tables(merge_branch, slice_spec):
    tabs_t, tabs_j = _tables(tktab, 40, 4), _tables(jktab, 40, 4)
    tabs_t[1].minval = tabs_j[1].minval = 2
    got = tfm.merge_tables(tabs_t, slice_spec, device="cpu")
    want = jfm.merge_tables(tabs_j, slice_spec)
    assert np.array_equal(got.packed, want.packed)
    assert np.array_equal(got.counts, want.counts)
    assert (got.kmer, got.minval) == (want.kmer, want.minval) == (40, 1)
    assert len(got) > 0


def test_library_unions_raise_without_a_card(monkeypatch):
    """device="cuda" (the default) never falls back to the CPU."""
    import fastk_tpu_torch.device as device_mod

    monkeypatch.setattr(device_mod.torch.cuda, "is_available", lambda: False)
    tabs = _tables(tktab, 40, 5)
    with pytest.raises(RuntimeError, match="cuda"):
        tfm.merge_tables(tabs)
    with pytest.raises(RuntimeError, match="cuda"):
        talg.logex_apply([("x", "A|+B")], tabs)


def _write(mod, d, tables):
    paths = []
    for i, t in enumerate(tables):
        p = os.path.join(d, f"t{i}")
        mod.write_ktab(p, t, nparts=2)
        paths.append(p)
    return paths


def _files(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


@pytest.mark.parametrize("nthreads,window", [(1, 64), (3, 1 << 20)])
def test_logex_apply_streamed(tmp_path, nthreads, window):
    """The streamed evaluator writes the same file-sets and histograms."""
    res = {}
    for name, alg, ktab in (("jax", jalg, jktab), ("port", talg, tktab)):
        src = tmp_path / name / "src"
        out = tmp_path / name / "out"
        os.makedirs(src)
        os.makedirs(out)
        paths = _write(ktab, str(src), _tables(ktab, 40, 6))
        hs = alg.logex_apply_streamed(
            [(str(out / n), e) for n, e in ALL_SHAPES], paths,
            hist_range=(1, 90), out_nparts=3, window=window,
            nthreads=nthreads)
        res[name] = ([(os.path.basename(n), None if h is None else (
            h.low, h.high, h.ilowcnt, h.ihighcnt, h.unique, h.counts.tolist()))
            for n, h in hs], _files(str(out)))
    assert res["port"] == res["jax"]
    assert len(res["port"][1]) == 4 * len(ALL_SHAPES)


@pytest.mark.parametrize("slice_spec", [None, (2, 3)])
def test_merge_streamed(tmp_path, slice_spec):
    res = {}
    for name, fm, ktab in (("jax", jfm, jktab), ("port", tfm, tktab)):
        src = tmp_path / name / "src"
        out = tmp_path / name / "out"
        os.makedirs(src)
        os.makedirs(out)
        paths = _write(ktab, str(src), _tables(ktab, 40, 7))
        assert fm.merge_streamed(paths, str(out / "m"), 3, True, True,
                                 slice_spec, window=64, nthreads=2) == 0
        res[name] = _files(str(out))
    assert res["port"] == res["jax"] and len(res["port"]) == 5
