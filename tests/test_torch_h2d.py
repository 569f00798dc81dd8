"""The port of benchmarks/_h2d.py, _overlap2.py, _r3h2d.py and _overlap.py
(fastk_tpu_torch/probes/h2d.py) on the CPU: every upload equal to the host
array it moves, heavy and the 3-key sort against their JAX expressions, the
headline step's three ways against the JAX package's hist_batch; the
two-buffer uploader's order of events; main's lines; no silent fallback to
the CPU."""

import io
import os
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastk_tpu.ops.count import hist_batch as jax_hist_batch
from fastk_tpu.ops.pack import unpack_words
from fastk_tpu_torch.probes import h2d
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


def _jax_heavy(x):
    """_overlap2.py's heavy."""
    for _ in range(6):
        x = jax.lax.sort((x,), num_keys=1)[0]
        x = x ^ (x >> 1)
    return x


def _want(size: int) -> dict:
    """Each case's expected output: the host arrays for the uploads, the
    JAX expressions for the compute."""
    out = {}
    for key, arr in h2d.h2d_arrays(size // 4).items():
        out[h2d.H2D_CASES[key]] = out[h2d.H2D_CASES[key] + " pinned"] = arr
    host = h2d.overlap_host(size // 16)
    heavy = _jax_heavy(jnp.asarray(host))
    out.update({"solo H2D 16.8MB": host, "solo H2D 16.8MB pinned": host,
                "H2D during compute": (heavy, host), "solo compute": heavy,
                "device_put": host, "1MB uint8":
                host.view(np.uint8)[: len(host) // 4],
                "16.8MB uint64": host.view(np.uint64).view(np.int64)})
    out.update({f"H2D in {p} chunks": np.split(host, p) for p in (2, 4, 16)})
    x = h2d.r3_inputs(size)
    s3 = jax.lax.sort(tuple(jnp.asarray(x[k].astype(t)) for k, t in (
        ("a", np.uint32), ("b", np.uint32), ("c", np.uint16))),
        num_keys=3, is_stable=False)
    for n in (0, 1, 4):
        out[f"sort+upload chunks={n}"] = (s3, np.array_split(x["host"], n)
                                          if n else [])
    for n in (1, 4, 16):
        out[f"upload-only chunks={n}"] = np.array_split(x["host"], n)
    pw, exc, total = bench_batch(size)
    hist = jax_hist_batch(unpack_words(jnp.asarray(pw), jnp.asarray(exc),
                                       total), K, size)["hist"]
    for name in ("compute only (no H2D)", "current (blocking asarray)",
                 "threaded uploads (2 in flight)"):
        out[name] = np.stack([np.asarray(hist)] * h2d.NB)
    return out


@pytest.fixture(scope="module")
def run():
    return dict(port=h2d.cases(CPU, SIZE), want=_want(SIZE))


NAMES = ([n for k in h2d.H2D_CASES for n in (h2d.H2D_CASES[k],
                                               h2d.H2D_CASES[k] + " pinned")]
         + ["solo H2D 16.8MB", "solo H2D 16.8MB pinned", "H2D during compute",
            "solo compute", "H2D in 2 chunks", "H2D in 4 chunks",
            "H2D in 16 chunks", "device_put", "1MB uint8", "16.8MB uint64"]
         + [f"sort+upload chunks={n}" for n in (0, 1, 4)]
         + [f"upload-only chunks={n}" for n in (1, 4, 16)]
         + ["compute only (no H2D)", "current (blocking asarray)",
            "threaded uploads (2 in flight)"])


def test_case_names(run):
    assert [n for n, _ in run["port"]] == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_case_matches(run, name):
    got = dict(run["port"])[name]()
    want = run["want"][name]
    if name.startswith("sort+upload"):
        assert same(got[0], tuple(want[0]))
        assert same([t.view(torch.int32) for t in got[1]],
                    [w.view(np.int32) for w in want[1]])
    elif name.startswith("upload-only"):
        assert same(got, [w.view(np.int32) for w in want])
    elif name == "H2D during compute":
        assert same(got[0], want[0])
        assert same(got[1], want[1].view(np.int32))
    else:
        assert same(got, want)
    if name in NAMES[-3:]:
        assert int(got[:, 1:].sum()) > 0


def test_two_buffers_alternate_and_refill():
    """Batch i runs on buffer i % 2, a buffer is refilled only after the
    step that reads it was queued, and every step sees the batch's words."""
    pw = np.arange(64, dtype=np.uint32)
    two = h2d.TwoBuffers(pw, CPU)
    filled, seen = [], []
    real = two.fill

    def fill(j):
        filled.append((j, len(seen)))
        return real(j)

    two.fill = fill

    def step(words):
        seen.append(words.data_ptr())
        assert np.array_equal(words.numpy(), pw.view(np.int32))
        return words.sum()

    outs = two.run(step, 5)
    assert len(outs) == 5 and len(set(seen)) == 2
    assert seen == [seen[0], seen[1]] * 2 + [seen[0]]
    # the first two fills up front; fill k (k >= 2) after step k - 2
    assert [j for j, _ in filled] == [0, 1, 0, 1, 0]
    assert all(n >= k - 1 for k, (_, n) in enumerate(filled) if k >= 2)


def test_main_cpu_lines(monkeypatch):
    monkeypatch.setattr(h2d, "NB", 1)
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = h2d.main("cpu", size=SIZE)
    lines = buf.getvalue().splitlines()
    assert all(ln.endswith("[cpu]") for ln in lines)
    labels = [re.split(r"\s{2,}|: ", ln)[0] for ln in lines]
    want = (NAMES[:12] + ["dispatch", "solo compute", "H2D in 2 chunks",
                          "H2D in 4 chunks", "H2D in 16 chunks", "device_put",
                          "1MB uint8", "16.8MB uint64"]
            + [f"sort+upload chunks={n}" for n in (0, 1, 4, 0, 1, 4)]
            + [f"upload-only chunks={n}" for n in (1, 4, 16)]
            + NAMES[-3:] + ["upload_packed + unpack",
                            "pinned once + H2D + unpack"])
    assert labels == want
    assert "H2D during compute" in out and "compute total after" in out
    assert all(" MB/s" in ln for ln in lines[:10])
    for script, names in (("_h2d.py", list(h2d.H2D_CASES.values())),
                          ("_overlap.py", NAMES[-3:])):
        with open(os.path.join(REPO, "benchmarks", script)) as f:
            src = f.read()
        assert all(n in src for n in names)


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(RuntimeError, match="cuda"):
        h2d.main()
    assert buf.getvalue() == ""
