"""The port of benchmarks/_r3tail.py, _r3tail2.py and _prim.py
(fastk_tpu_torch/probes/tail.py) against the JAX expressions of their cases
on the CPU: the bench's batch and the primitives' numpy data through both,
compared exactly; main's printed lines; no silent fallback to the CPU."""

import io
import os
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import pytest
import torch

from fastk_tpu.ops.count import (
    HIST_HIGH,
    bincount_by_sort,
    fold_invalid,
    narrow_words,
    next_start_after,
)
from fastk_tpu.ops.kmers import canonical_kmers
from fastk_tpu.ops.pack import unpack_words
from fastk_tpu_torch.probes import tail
from fastk_tpu_torch.probes.common import K, bench_batch, same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SIZE = 1 << 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel workers, where
    torch's thread pools would only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tail(size: int) -> dict:
    """_r3tail.py's and _r3tail2.py's jitted stages, in their own words, on
    the bench's batch at `size`."""
    pw, exc, total = bench_batch(size)
    codes = unpack_words(jnp.asarray(pw), jnp.asarray(exc), total)
    words, invalid = canonical_kmers(codes, K, size)
    ninv = jnp.sum(invalid.astype(jnp.int32))
    f = narrow_words(fold_invalid(words, invalid), K)
    s_words = jax.lax.sort(f, num_keys=len(f), is_stable=False)

    starts = jnp.zeros(size, dtype=bool)
    for w in s_words:
        starts = starts | (w != jnp.roll(w, 1))
    starts = starts.at[0].set(True)
    idx = jnp.arange(size, dtype=jnp.int32)
    nxt = jnp.where(starts, idx, size)
    end = jnp.full((1,), size, jnp.int32)
    seglen = jnp.concatenate([jax.lax.cummin(nxt[::-1])[::-1][1:], end]) - idx
    revarg = jnp.concatenate(
        [jax.lax.cummin(nxt, reverse=True)[1:], end]) - idx
    use = starts & (idx < size - ninv)
    vals = jnp.where(use, jnp.minimum(seglen, HIST_HIGH),
                     HIST_HIGH + 1).astype(jnp.uint16)
    sv = jax.lax.sort((vals,), num_keys=1)[0]

    def edges(sv):
        e = jnp.searchsorted(sv, jnp.arange(HIST_HIGH + 2, dtype=sv.dtype))
        return (e[1:] - e[:-1]).astype(jnp.int32)

    def seglen_rows(R):
        C = size // R
        rm = jax.lax.cummin(nxt.reshape(R, C), axis=1, reverse=True)
        suf = jax.lax.cummin(jnp.concatenate([rm[1:, 0], end]), reverse=True)
        out = jnp.minimum(rm, suf[:, None]).reshape(-1)
        return jnp.concatenate([out[1:], end]) - idx

    def bincount_rows(R):
        s = jax.lax.sort((vals.reshape(R, size // R),), num_keys=1,
                         is_stable=False)[0]
        e = jnp.arange(HIST_HIGH + 2, dtype=s.dtype)
        ed = jax.vmap(lambda row: jnp.searchsorted(row, e))(s)
        return (ed[:, 1:] - ed[:, :-1]).sum(axis=0, dtype=jnp.int32)

    out = {"starts": starts, "seglen cummin": seglen, "seglen revarg": revarg,
           "vals": vals, "sort u16": sv, "searchsorted": edges(sv),
           "next_start_after": next_start_after(starts, size) - idx,
           "torch.bincount": bincount_by_sort(vals, HIST_HIGH + 1),
           "seglen flat": revarg, "bincount flat": edges(sv)}
    out.update({f"seglen rows {R}": seglen_rows(R) for R in tail.SEG_ROWS})
    out.update({f"bincount rows {R}": bincount_rows(R) for R in tail.BIN_ROWS})
    return out


def _jax_prims(size: int) -> dict:
    """_prim.py's expressions, each the whole array the script reduced to
    one value for its fetch."""
    x = tail.prim_inputs(size)
    lens, s = jnp.asarray(x["lens"]), jnp.asarray(x["starts"])
    perm = jax.lax.sort((jnp.asarray(x["keys"]),
                         jnp.arange(size, dtype=jnp.int32)), num_keys=1)[1]
    sl = jax.lax.sort((lens,), num_keys=1)[0]
    return {
        "roll": jnp.sum((lens != jnp.roll(lens, 1)).astype(jnp.int32)),
        "cumsum": jax.lax.cumsum(lens),
        "cummax": jax.lax.cummax(lens),
        "scatter32k": jnp.zeros(32768, jnp.int32).at[lens & 32767].add(1),
        "scatterperm": jnp.zeros(size, jnp.int32).at[perm].set(lens),
        "gatherperm": lens[perm],
        "compact": jax.lax.sort(((~s).astype(jnp.uint8),
                                 jnp.arange(size, dtype=jnp.int32)),
                                num_keys=1, is_stable=True)[1],
        "sort1": jax.lax.sort((lens,), num_keys=1)[0],
        "searchsorted": jnp.searchsorted(sl, jnp.arange(32768)),
    }


@pytest.fixture(scope="module")
def run():
    return dict(port=dict(tail.tail_cases(CPU, SIZE)), jax=_jax_tail(SIZE),
                prim=dict(tail.prim_cases(CPU, SIZE)),
                jax_prim=_jax_prims(SIZE))


TAIL = (["starts", "seglen cummin", "seglen revarg", "vals", "sort u16",
         "searchsorted", "next_start_after", "torch.bincount", "seglen flat"]
        + [f"seglen rows {R}" for R in tail.SEG_ROWS] + ["bincount flat"]
        + [f"bincount rows {R}" for R in tail.BIN_ROWS])


@pytest.mark.parametrize("name", TAIL)
def test_tail_stage_matches_jax(run, name):
    got = run["port"][name]()
    assert same(got, run["jax"][name])
    if name == "starts":  # the batch has runs longer than one
        assert 0 < int(got.sum()) < SIZE


@pytest.mark.parametrize("name", list(tail.PRIMS))
def test_prim_matches_jax(run, name):
    assert same(run["prim"][name](), run["jax_prim"][name])


def test_cases_are_tail_then_prims():
    names = [n for n, _ in tail.cases(CPU, 1 << 12)]
    assert names == TAIL + list(tail.PRIMS.values())


def test_main_cpu_lines(monkeypatch):
    """main's lines: the scripts' names in their order, OK on every row
    form, the device after each."""
    monkeypatch.setattr(tail, "TAIL_REPS", 1)
    monkeypatch.setattr(tail, "PRIM_REPS", 1)
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = tail.main("cpu", size=1 << 14)
    lines = buf.getvalue().splitlines()
    assert res["mismatches"] == []
    names = [re.sub(r"\s+", " ", ln.rsplit("[", 1)[0]).strip() for ln in lines]
    names = [re.sub(r" [\d.]+ ms( OK)?$", "", n) for n in names]
    want = ([n for n in TAIL]
            + [tail.PRIMS[p] for p in tail.PRIMS])
    assert names == want
    assert all(ln.endswith("[cpu]") for ln in lines)
    assert sum(" OK" in ln for ln in lines) == len(tail.SEG_ROWS) + len(
        tail.BIN_ROWS)
    with open(os.path.join(REPO, "benchmarks/_r3tail.py")) as f:
        src = f.read()
    assert re.findall(r'print\("(\w[\w ]*\w) +"', src) == TAIL[:6]
    with open(os.path.join(REPO, "benchmarks/_prim.py")) as f:
        src = f.read()
    assert re.findall(r'which == "(\w+)"', src) == list(tail.PRIMS)
    assert re.findall(r'timeit\("([^"]+)"', src) == list(tail.PRIMS.values())


def test_main_reports_a_row_mismatch(monkeypatch):
    monkeypatch.setattr(tail, "TAIL_REPS", 1)
    real = tail.seglen_rows
    monkeypatch.setattr(tail, "seglen_rows",
                        lambda s, R: real(s, R) + (R == 256))
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = tail.main("cpu", size=1 << 12, prims=())
    assert res["mismatches"] == ["seglen rows 256"]
    assert "MISMATCH" in buf.getvalue()


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(RuntimeError, match="cuda"):
        tail.main()
    assert buf.getvalue() == ""
