"""The port's public names and launchers.

- ``fastk_tpu_torch`` exports the public names of ``fastk_tpu``, the two
  multi-device entry points among them, lazily.
- The format codecs, the algebra and every host tool import without torch,
  and run their ``main`` without loading it.
- Each launcher in ``fastk_tpu_torch/bin/`` runs its tool as a subprocess,
  with ``fastk_tpu`` blocked on the import path, and writes the JAX tool's
  bytes; ``fastk`` and ``kmermap`` count on the card, so without one they
  stop with the device error and write nothing.
- ``_gen.sh`` writes exactly the committed launchers.
"""

import filecmp
import json
import os
import shutil
import stat
import subprocess
import sys

import pytest
import torch

import fastk_tpu
import fastk_tpu_torch

from test_torch_tools import (GOLDEN, SMALL, SMALL2, TINY, _copy_set,
                              _merged_slices, _run, _tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, "fastk_tpu_torch", "bin")
INPUTS = os.path.join(GOLDEN, "inputs")

HOST_TOOLS = ["histex", "tabex", "profex", "fastrm", "fastmv", "fastcp",
              "logex", "symmex", "fastmerge", "fastcat", "vennex", "haplex",
              "homex"]
DEVICE_TOOLS = ["fastk", "kmermap"]

MULTI_DEVICE = ("count_files_sharded", "count_files_mesh")


@pytest.mark.parametrize("name", fastk_tpu.__all__)
def test_public_names_resolve(name):
    got = getattr(fastk_tpu_torch, name)
    want = getattr(fastk_tpu, name)
    if name == "__version__":
        assert got == want
        return
    assert got.__name__ == want.__name__
    assert got.__module__.startswith("fastk_tpu_torch.")
    assert name in fastk_tpu_torch.__all__


@pytest.mark.parametrize("name", MULTI_DEVICE)
def test_multi_device_names_wait(name):
    """The multi-device names waited for their slice of the port; they now
    resolve lazily to the parallel modules, which load torch only then."""
    from fastk_tpu_torch.parallel import host, meshooc

    assert name in fastk_tpu.__all__ and name in fastk_tpu_torch.__all__
    want = (host.count_files_sharded if name == "count_files_sharded"
            else meshooc.count_files_mesh)
    assert getattr(fastk_tpu_torch, name) is want
    with pytest.raises(AttributeError):
        fastk_tpu_torch.no_such_name


def test_lazy_names_are_the_device_modules():
    from fastk_tpu_torch.device import resolve_device
    from fastk_tpu_torch.pipeline.count import count_files

    assert fastk_tpu_torch.count_files is count_files
    assert fastk_tpu_torch.resolve_device is resolve_device


def _python(code, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(cwd), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_codecs_import_without_torch(tmp_path):
    out = _python(
        "import sys, fastk_tpu_torch, fastk_tpu_torch.formats.hist, "
        "fastk_tpu_torch.formats.ktab, fastk_tpu_torch.formats.prof, "
        "fastk_tpu_torch.formats.paths, fastk_tpu_torch.formats.twindow, "
        "fastk_tpu_torch.formats.onecode, fastk_tpu_torch.algebra, "
        "fastk_tpu_torch.ops.canonical, fastk_tpu_torch.native\n"
        "fastk_tpu_torch.read_ktab\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'fastk_tpu')))", tmp_path)
    assert out.strip() == "[]"


# a FASTK_PYTHON stand-in: blocks fastk_tpu, runs `-m <module> args` and
# records at exit which of torch, jax and fastk_tpu were loaded
_BLOCKER = r"""
import atexit, importlib.abc, json, os, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "fastk_tpu" or name.startswith("fastk_tpu."):
            raise ImportError("fastk_tpu is blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
report = os.environ["LAUNCHER_REPORT"]

@atexit.register
def _report():
    with open(report, "w") as f:
        json.dump(sorted({m.split(".")[0] for m in sys.modules}
                         & {"torch", "jax", "fastk_tpu"}), f)

assert sys.argv[1] == "-m"
sys.argv = sys.argv[2:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def _copy_sets(*stubs):
    def setup(d):
        for s in stubs:
            _copy_set(s, d)
    return setup


SMALL_SETS = _copy_sets(SMALL + ".hist", SMALL + ".ktab", SMALL + ".prof")
LAUNCHES = {
    "histex": ([SMALL + ".hist"], None),
    "tabex": ([TINY + ".ktab"], None),
    "profex": ([SMALL, "1-3"], None),
    "haplex": (["-g1:100", SMALL + ".ktab"], None),
    "homex": (["-e3", "-g5:100", SMALL + ".ktab"], None),
    "symmex": (["-T2", TINY + ".ktab", "sym"], None),
    "logex": (["-h1:100", "x=A&.B", SMALL + ".ktab", SMALL2 + ".ktab"],
              None),
    "vennex": (["-h1:100", SMALL + ".ktab", SMALL2 + ".ktab"], None),
    "fastmerge": (["-ht", "-T2", "m", SMALL, SMALL2], None),
    "fastcat": (["-ht", "c", "s1", "s2", "s3"], _merged_slices),
    "fastcp": (["small.ktab", "copy"], SMALL_SETS),
    "fastmv": (["small.prof", "moved"], SMALL_SETS),
    "fastrm": (["small"], SMALL_SETS),
    "fastk": (["-k40", "-t1", "-Nout", os.path.join(INPUTS, "small.fasta")],
              None),
    "kmermap": (["-m", SMALL + ".ktab", os.path.join(INPUTS, "small2.fasta"),
                 "km"], None),
}


@pytest.mark.parametrize("tool", HOST_TOOLS + DEVICE_TOOLS)
def test_launcher(tmp_path, tool):
    argv, setup = LAUNCHES[tool]
    wrap = tmp_path / "wrap"
    wrap.mkdir()
    (wrap / "blocker.py").write_text(_BLOCKER)
    py = wrap / "python"
    py.write_text(f'#!/bin/sh\nexec "{sys.executable}" '
                  f'"{wrap / "blocker.py"}" "$@"\n')
    py.chmod(0o755)
    run = tmp_path / "port"
    run.mkdir()
    if setup is not None:
        setup(str(run))
    env = dict(os.environ, FASTK_PYTHON=str(py),
               LAUNCHER_REPORT=str(wrap / "report.json"))
    r = subprocess.run([os.path.join(BIN, tool), *argv], cwd=str(run),
                       env=env, capture_output=True, timeout=600)
    with open(wrap / "report.json") as f:
        loaded = json.load(f)
    assert "fastk_tpu" not in loaded and "jax" not in loaded
    if tool in DEVICE_TOOLS:
        assert "torch" in loaded
        if not torch.cuda.is_available():
            assert r.returncode != 0
            assert b"torch.cuda.is_available() is False" in r.stderr
            assert _tree(str(run)) == {}
            return
    else:
        assert loaded == [], loaded
    assert r.returncode == 0, r.stderr[-3000:]
    ref = tmp_path / "jax"
    ref.mkdir()
    if setup is not None:
        setup(str(ref))
    rc, out, err = _run("fastk_tpu", tool, argv, str(ref))
    assert rc == 0, err
    assert r.stdout == out
    assert _tree(str(run)) == _tree(str(ref))


def test_gen_sh_writes_the_committed_launchers(tmp_path):
    d = tmp_path / "bin"
    d.mkdir()
    shutil.copy(os.path.join(BIN, "_gen.sh"), d / "_gen.sh")
    subprocess.run(["sh", str(d / "_gen.sh")], check=True, timeout=60)
    made = sorted(os.listdir(d))
    assert made == sorted(os.listdir(BIN))
    assert sorted(HOST_TOOLS + DEVICE_TOOLS + ["_gen.sh"]) == made
    assert sorted(os.listdir(os.path.join(REPO, "bin"))) == made
    for name in HOST_TOOLS + DEVICE_TOOLS:
        committed = os.path.join(BIN, name)
        assert filecmp.cmp(d / name, committed, shallow=False), name
        assert os.stat(committed).st_mode & stat.S_IXUSR, name
        with open(committed) as f:
            text = f.read()
        assert f"-m fastk_tpu_torch.tools.{name} " in text
        assert "JAX_PLATFORMS" not in text and "PALLAS" not in text
