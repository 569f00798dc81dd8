"""The port stands alone: no module of fastk_tpu_torch, and not chip_smoke.py,
imports anything of fastk_tpu, of JAX or of the repo's benchmarks/ (the
Mosaic probe scripts among them), and the port runs its CLI with fastk_tpu
blocked on the import path."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "fastk_tpu_torch")


def _port_sources():
    out = []
    for d, _dirs, files in os.walk(PORT):
        out += [os.path.relpath(os.path.join(d, f), REPO)
                for f in files if f.endswith(".py")]
    return sorted(out) + ["chip_smoke.py"]


SOURCES = _port_sources()


FORBIDDEN = ("fastk_tpu", "jax", "benchmarks")


def _is_jax_package(name: str) -> bool:
    """fastk_tpu, jax or benchmarks, or a module of one of them."""
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(tree):
    """(line, module name) of every import in a module, those inside
    functions included, and of importlib.import_module / __import__ calls
    with a constant name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Name)
                    and node.func.id == "__import__")
                   or (isinstance(node.func, ast.Attribute)
                       and node.func.attr == "import_module"))):
            yield node.lineno, node.args[0].value


def test_scan_sees_every_module():
    assert len(SOURCES) > 30
    for want in ("fastk_tpu_torch/io/reader.py",
                 "fastk_tpu_torch/formats/ktab.py",
                 "fastk_tpu_torch/native/__init__.py",
                 "fastk_tpu_torch/tools/fastk.py",
                 "fastk_tpu_torch/ops/probes.py",
                 "fastk_tpu_torch/probes/__init__.py",
                 "fastk_tpu_torch/probes/__main__.py",
                 "fastk_tpu_torch/probes/feas.py",
                 "fastk_tpu_torch/probes/feas2.py",
                 "fastk_tpu_torch/probes/feas3.py",
                 "fastk_tpu_torch/probes/feas4.py", "chip_smoke.py"):
        assert want in SOURCES
    # the scan does catch a lazy import of the JAX package, of JAX and of
    # the probe scripts
    tree = ast.parse("def f():\n    from fastk_tpu import native\n"
                     "    import fastk_tpu.io.reader\n"
                     "    from fastk_tpu_torch import native\n"
                     "    import benchmarks._pallas_feas2\n"
                     "    from benchmarks import _pallas_feas\n"
                     "    from jax.experimental import pallas\n"
                     "    import jaxlib, benchmarks_x\n")
    assert [n for _, n in _imports(tree) if _is_jax_package(n)] == [
        "fastk_tpu", "fastk_tpu.io.reader", "benchmarks._pallas_feas2",
        "benchmarks", "jax.experimental"]


@pytest.mark.parametrize("rel", SOURCES)
def test_no_import_of_the_jax_package(rel):
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read(), rel)
    bad = [f"{rel}:{line} {name}" for line, name in _imports(tree)
           if _is_jax_package(name)]
    assert not bad, bad


_BLOCKED_RUN = r"""
import ast, importlib, importlib.abc, os, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".")
               for f in ("fastk_tpu", "benchmarks")):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
repo, out = sys.argv[1], sys.argv[2]
import fastk_tpu_torch
names = ["fastk_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(fastk_tpu_torch.__path__,
                                          "fastk_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# every import statement of chip_smoke.py, those inside main() included
import chip_smoke
with open(os.path.join(repo, "chip_smoke.py")) as f:
    tree = ast.parse(f.read())
for node in ast.walk(tree):
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"), {})
from fastk_tpu_torch import native
from fastk_tpu_torch.tools import fastk
rc = fastk.main(["-k40", "-t1", "-p", "-N" + out,
                 os.path.join(repo, "tests/golden/inputs/small.fasta")],
                device="cpu")
leaked = sorted(m for m in sys.modules if m == "fastk_tpu"
                or m.startswith("fastk_tpu.") or m == "jax"
                or m.startswith("jax."))
print(rc, len(names), leaked, native.load() is not None)
"""


def test_cli_runs_with_the_jax_package_blocked(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = str(tmp_path / "small")
    r = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, REPO, out],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    rc, nmods, leaked, native_loaded = r.stdout.split("\n")[-2].split(" ", 3)
    assert rc == "0" and int(nmods) > 25
    assert leaked.startswith("[]")
    assert native_loaded == "True"
    golden = os.path.join(REPO, "tests", "golden", "small_k40")
    # the .hist, and the .ktab stub (the oracle cuts its parts its own way;
    # tests/test_torch_table.py holds the entries)
    for ext in (".hist", ".ktab"):
        with open(out + ext, "rb") as f, open(
                os.path.join(golden, "small" + ext), "rb") as g:
            assert f.read() == g.read(), ext
    assert os.path.exists(out + ".prof")
