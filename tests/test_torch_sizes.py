"""The port of benchmarks/_r3size.py (fastk_tpu_torch/probes/sizes.py)
against the JAX expressions of its cases on the CPU: the same numpy inputs
through both, compared exactly; its printed lines; no silent fallback to the
CPU."""

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
from fastk_tpu_torch.probes import sizes
from fastk_tpu_torch.probes.common import same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs files in parallel workers, where
    torch's thread pools would only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_case(name: str, x: dict, n: int):
    """_r3size.py's jitted functions of the same names."""
    w0, w1 = jnp.asarray(x["w0"].astype(np.uint32)), jnp.asarray(
        x["w1"].astype(np.uint32))
    w2 = jnp.asarray(x["w2"].astype(np.uint16))
    if name == "sort3":
        return jax.lax.sort((w0, w1, w2), num_keys=3, is_stable=False)
    if name == "u16":
        u16 = jnp.asarray(x["u16"].astype(np.uint16))
        return jax.lax.sort((u16,), num_keys=1, is_stable=False)[0]
    return jax_hist_batch(jnp.asarray(x["codes"]), sizes.K, n)


@pytest.mark.parametrize("lg", [12, 14, 16])
@pytest.mark.parametrize("name", sizes.CASES)
def test_case_matches_jax(lg, name):
    n = 1 << lg
    got = dict(sizes.cases(CPU, n))[name]()
    want = _jax_case(name, sizes.inputs(n), n)
    assert same(got, want)
    if name == "hist_batch":  # random codes, padded with valid bases
        assert got["nvalid"] == n and int(got["hist"][1:].sum()) > 0


def test_inputs_are_seeded_by_size():
    a, b = sizes.inputs(1 << 12), sizes.inputs(1 << 12)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["w0"][:100], sizes.inputs(1 << 13)["w0"][:100])
    assert a["w0"].max() < 1 << 30 and a["u16"].max() <= 32768
    assert len(a["codes"]) == (1 << 12) + sizes.pad_needed(sizes.K)


@pytest.mark.parametrize("text,want", [("23-27", (23, 24, 25, 26, 27)),
                                       ("24,26", (24, 26)), ("25", (25,))])
def test_parse_sizes(text, want):
    assert sizes.parse_sizes(text) == want


def test_main_cpu_lines():
    """main's lines name the script's cases in the script's order, with the
    raw and the per-2^26 times and the device."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = sizes.main("cpu", sizes=(12, 13))
    lines = buf.getvalue().splitlines()
    with open(os.path.join(REPO, "benchmarks/_r3size.py")) as f:
        src = f.read()
    names = re.findall(r"(\w+) \{t_", src)
    assert names == list(sizes.CASES)
    for lg, line in zip((12, 13), lines):
        assert line.startswith(f"2^{lg}: ") and line.endswith("[cpu]")
        assert re.findall(r"(\w+) +[\d.]+ms", line) == names
        scale = (1 << 26) >> lg
        raw = [float(v) for v in re.findall(r"([\d.]+)ms", line)]
        scaled = [float(v) for v in re.findall(r"=\s*([\d.]+)\)", line)]
        assert all(abs(r * scale - s) <= 1e-3 * scale + 1e-3
                   for r, s in zip(raw, scaled))
        assert f"(x{scale}=" in line
    assert [lg for lg, _ in out] == [12, 13]
    assert all(set(ms) == set(names) and min(ms.values()) > 0
               for _, ms in out)


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(RuntimeError, match="cuda"):
        sizes.main()
    assert buf.getvalue() == ""
