"""The port on a CUDA card: the run-length kernel against its plain
version, and the device paths (histogram, uniques, the fused count, the
table compaction, the profile joins, the merge with want_back and the
out-of-core job) on CUDA against the same calls on the CPU.

Imports no JAX, so that it runs on a machine with a card and without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Every test skips without a card.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from fastk_tpu_torch.convert import codes_from_numpy, words_to_numpy
from fastk_tpu_torch.ops import count, histker
from fastk_tpu_torch.ops.kmers import pad_needed
from fastk_tpu_torch.pipeline.outofcore import count_files_ooc

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def test_kernel_matches_plain(cuda_device):
    cases = chip_smoke.crafted_masks()
    cases.append(("random_2^26", *chip_smoke.random_words(1 << 26)))
    for name, words, valid_end in cases:
        t = torch.from_numpy(np.ascontiguousarray(words)).to(cuda_device)
        before = histker.run_hist.launches
        got, nvalid = histker.run_hist(t, valid_end)
        assert histker.run_hist.launches == before + 1
        want, _ = histker.run_hist_ref(t, valid_end)
        torch.cuda.synchronize()
        assert nvalid == valid_end
        assert torch.equal(got, want), name


def test_kernel_rejects_cpu_only_arguments(cuda_device):
    t = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        histker.run_hist(t, 0)


def _codes(k: int, size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 5000).astype(np.uint8)
    c = np.full(size + pad_needed(k), 4, np.uint8)
    pos = 0
    while pos < size - 300:
        s = int(rng.integers(0, 4700))
        r = genome[s: s + 300]
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        c[pos: pos + 300] = r
        pos += 301
    c[rng.random(len(c)) < 0.001] = 4
    return c


@pytest.mark.parametrize("k", [17, 32, 40, 64])
def test_device_path_matches_cpu(cuda_device, k):
    size = 1 << 18
    c = _codes(k, size, k)
    cpu, gpu = torch.device("cpu"), cuda_device
    h_cpu = count.hist_batch(codes_from_numpy(c, cpu), k, size)
    before = histker.run_hist.launches
    h_gpu = count.hist_batch(codes_from_numpy(c, gpu), k, size)
    assert histker.run_hist.launches == before + 1
    assert torch.equal(h_gpu["hist"].cpu(), h_cpu["hist"])
    assert h_gpu["nvalid"] == h_cpu["nvalid"]

    u_cpu = count.unique_batch(codes_from_numpy(c, cpu), k, size)
    u_gpu = count.unique_batch(codes_from_numpy(c, gpu), k, size)
    for key in ("nseg", "nuniq", "nvalid"):
        assert int(u_gpu[key]) == int(u_cpu[key])
    assert torch.equal(u_gpu["seg_counts"].cpu(), u_cpu["seg_counts"])
    for g, w in zip(words_to_numpy(u_gpu["seg_words"]),
                    words_to_numpy(u_cpu["seg_words"])):
        assert np.array_equal(g, w)

    m_cpu = count.merge_unique_blocks(u_cpu["seg_words"], u_cpu["seg_counts"])
    m_gpu = count.merge_unique_blocks(u_gpu["seg_words"], u_gpu["seg_counts"])
    assert int(m_gpu["nuniq"]) == int(m_cpu["nuniq"])
    assert torch.equal(m_gpu["hist"].cpu(), m_cpu["hist"])


@pytest.mark.parametrize("k", [17, 40])
def test_table_and_profile_ops_match_cpu(cuda_device, k):
    """count_batch, compact_table_min and both joins on the card equal the
    same calls on the CPU; count_batch launches run_hist once."""
    size = 1 << 18
    c = _codes(k, size, k + 1)
    res = {}
    for dev in (torch.device("cpu"), cuda_device):
        before = histker.run_hist.launches
        cb = count.count_batch(codes_from_numpy(c, dev), k, size, True, True)
        if dev.type == "cuda":
            assert histker.run_hist.launches == before + 1
        kept = count.compact_table_min(cb["seg_words"], cb["seg_counts"], 3)
        n = int(kept["nkeep"])
        t_words = tuple(w[:n] for w in kept["words"])
        t_counts = kept["counts"][:n]
        q = codes_from_numpy(c[::-1].copy(), dev)  # the reverse strand
        inst = count.unique_batch_inst(q, k, size)
        res[dev.type] = dict(
            cb=cb, n=n, t_words=words_to_numpy(t_words),
            t_counts=t_counts.cpu(),
            join=count.profile_join(t_words, t_counts, q, k, size).cpu(),
            join_inst=count.profile_join_inst(t_words, t_counts,
                                              inst["s_words"],
                                              inst["s_pos"]).cpu())
    cpu, gpu = res["cpu"], res["cuda"]
    for key in ("nseg", "nvalid", "overflow"):
        assert int(gpu["cb"][key]) == int(cpu["cb"][key]), key
    for key in ("seg_counts", "seg_valid", "hist", "pos_counts"):
        assert torch.equal(gpu["cb"][key].cpu(), cpu["cb"][key]), key
    for g, w in zip(words_to_numpy(gpu["cb"]["seg_words"]),
                    words_to_numpy(cpu["cb"]["seg_words"])):
        assert np.array_equal(g, w)
    assert gpu["n"] == cpu["n"] > 0
    for g, w in zip(gpu["t_words"], cpu["t_words"]):
        assert np.array_equal(g, w)
    assert torch.equal(gpu["t_counts"], cpu["t_counts"])
    assert torch.equal(gpu["join"], cpu["join"])
    assert torch.equal(gpu["join_inst"], cpu["join"])
    assert int((cpu["join"] > 0).sum()) > 0


@pytest.mark.parametrize("k", [17, 40])
def test_merge_want_back_matches_cpu(cuda_device, k):
    """merge_unique_blocks(want_back=True) on the card equals the CPU port:
    three batches' uniques (two of them equal) with empty slots and counts
    whose sums pass 32767."""
    size = 1 << 18
    blocks = {}
    for dev in (torch.device("cpu"), cuda_device):
        ws, cs = [], []
        for seed in (1, 1, 2):
            u = count.unique_batch(codes_from_numpy(_codes(k, size, seed),
                                                    dev), k, size)
            ws.append(u["seg_words"])
            cs.append(u["seg_counts"].clone())
            cs[-1][:100] += 20000  # twice in seed 1's blocks: past 32767
        words = tuple(torch.cat([w[j] for w in ws])
                      for j in range(len(ws[0])))
        counts = torch.cat(cs)
        blocks[dev.type] = count.merge_unique_blocks(words, counts,
                                                     want_back=True)
    cpu, gpu = blocks["cpu"], blocks["cuda"]
    assert int(gpu["nuniq"]) == int(cpu["nuniq"])
    for key in ("seg_counts", "hist", "rec_counts"):
        assert torch.equal(gpu[key].cpu(), cpu[key]), key
    for g, w in zip(words_to_numpy(gpu["seg_words"]),
                    words_to_numpy(cpu["seg_words"])):
        assert np.array_equal(g, w)
    assert int(cpu["rec_counts"].max()) == 32767


def test_ooc_with_profiles_matches_cpu(cuda_device, tmp_path):
    """A small out-of-core -t1 -p job (3 parts, several batches, a
    sub-split part) writes the same file-sets on the card as on the CPU."""
    path = str(tmp_path / "reads.fasta")
    chip_smoke.write_hifi_fasta(path, 30_000, 40, seed=3, read_len=2000)
    sets = []
    for dev in ("cpu", "cuda"):
        d = tmp_path / dev
        os.mkdir(d)
        count_files_ooc([path], 40, 3, sort_path=str(d), table_min=1,
                        profiles=True, batch_bases=20_000, part_cap=20_000,
                        out_base=str(d / "o"), out_nparts=2, device=dev)
        sets.append(chip_smoke.file_set(str(d), "o"))
    assert sets[0] == sets[1]
    assert any(".ktab" in n for n in sets[0])
    assert any(".prof" in n for n in sets[0])
