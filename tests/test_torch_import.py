"""The PyTorch port imports without JAX and never falls back to the CPU."""

import os
import subprocess
import sys

import pytest
import torch

import fastk_tpu_torch.device as device_mod
from fastk_tpu_torch.ops.tables import merge_counted
from fastk_tpu_torch.pipeline.count import count_files
from fastk_tpu_torch.pipeline.outofcore import count_files_ooc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = os.path.join(REPO, "tests", "golden", "inputs", "small.fasta")


def test_port_imports_without_jax():
    code = ("import sys, fastk_tpu_torch, fastk_tpu_torch.pipeline.count, "
            "fastk_tpu_torch.tools.fastk, fastk_tpu_torch.ops.histker, "
            "fastk_tpu_torch.ops.count, fastk_tpu_torch.ops.kmers, "
            "fastk_tpu_torch.ops.pack, fastk_tpu_torch.convert, "
            "fastk_tpu_torch.device, fastk_tpu_torch._kernels, "
            "fastk_tpu_torch.pipeline.outofcore, fastk_tpu_torch.ops.tables, "
            "fastk_tpu_torch.tools.kmermap; "
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith('jax.')))")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(device_mod.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        count_files([SMALL], 40, device="cuda")
    with pytest.raises(RuntimeError):
        device_mod.resolve_device("cuda:0")
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kw", [dict(table_min=3, profiles=True),
                                dict(table_min=1), dict(profiles=True)])
def test_cuda_without_card_raises_in_every_mode(monkeypatch, kw):
    monkeypatch.setattr(device_mod.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        count_files([SMALL], 40, device="cuda", **kw)


@pytest.mark.parametrize("profiles", [False, True])
def test_ooc_cuda_without_card_raises(monkeypatch, tmp_path, profiles):
    monkeypatch.setattr(device_mod.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        count_files_ooc([SMALL], 40, 2, sort_path=str(tmp_path),
                        table_min=1, profiles=profiles, device="cuda")
    assert os.listdir(tmp_path) == []
    with pytest.raises(RuntimeError, match="cuda"):
        merge_counted([], [], device="cuda")
