"""A device slice's first upload carries its codes as bytes, and the host packs
a slice 2 bits a base only where it keeps the packed form for a second
upload. Each job kind of the port against fastk_tpu (exact .hist, .ktab and
.prof), with the slices it uploaded as codes (upload.raw_slices) and as
packed words (upload.packed_slices) counted against the path it takes. A job
that keeps nothing a batch (histogram, -t) reads batches of one device slice
and queues each while the reader reads the next (count.slices_ahead)."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fastk_tpu.pipeline.count as jpipe
import fastk_tpu_torch.pipeline.count as tpipe
from fastk_tpu.formats.hist import write_histogram
from fastk_tpu.formats.ktab import read_ktab as jax_read_ktab
from fastk_tpu.formats.ktab import write_ktab
from fastk_tpu.io.reader import batched_reads
from fastk_tpu.tools.fastk import main as jax_fastk_main
from fastk_tpu_torch import trace
from fastk_tpu_torch.convert import device_codes
from fastk_tpu_torch.formats.ktab import read_ktab
from fastk_tpu_torch.io.reader import batched_reads as port_batched_reads
from fastk_tpu_torch.ops import pack as tpack
from fastk_tpu_torch.ops.kmers import pad_needed
from fastk_tpu_torch.tools.fastk import main as fastk_main

import gen_data
from test_torch_table import file_set

K = 40
CAP = 1 << 15  # device positions a slice: each batch runs in several slices
BATCH = 70_000  # bases a batch: the input runs in several batches


@pytest.fixture(scope="module")
def reads_path(tmp_path_factory):
    """Reads with N runs, lower and upper case, errors, and reads shorter
    than k; about 200 kb, so three batches of three slices."""
    rng = np.random.default_rng(19)
    genome = gen_data.make_genome(rng, 20_000)
    reads = gen_data.sample_reads(rng, genome, 10, 2000, n_rate=0.3,
                                  upper_rate=0.3, err_rate=0.01)
    reads[5:5] = [b"acgtNNNNacgt", b"NNNNN", b"acg"]
    path = str(tmp_path_factory.mktemp("raw") / "reads.fasta")
    gen_data.write_fasta(path, reads)
    return path


def _slices(path, batch_bases):
    """Device slices of each batch, by fastk_tpu's own slicing."""
    return [len(list(jpipe._code_slices(b.codes, K)))
            for b, _ in batched_reads([path], batch_bases)]


def _slice_batches(path, cap):
    """The port's reader batches of a job that keeps nothing a batch, at
    device slices of cap positions: each is one slice."""
    sizes = [len(b.codes) for b, _ in port_batched_reads(
        [path], cap - pad_needed(K))]
    assert all(n + pad_needed(K) <= cap for n in sizes)
    return len(sizes)


def _ahead(nbatches):
    """count.slices_ahead of a job of nbatches one-slice batches, each but
    the last cut before a read that did not fit: the first is read before
    the first slice is queued, and each later read follows every slice
    queued before it."""
    return nbatches - 1


def _traced(fn, *args, **kw):
    """Run fn under a CPU profiler in a job record; (its result, the
    record)."""
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.job():
            out = fn(*args, **kw)
    return out, trace.jobs()[-1]


def _uploads(rec):
    c = rec["counters"]
    pack = rec["spans"].get("pack", {}).get("calls", 0)
    return (c.get("upload.raw_slices", 0), c.get("upload.packed_slices", 0),
            pack)


def _both(tmp_path, path, batch_bases, relative=None, **kw):
    """fastk_tpu's and the port's count_files on the same input, each
    streaming into its own directory: (JAX files, port files, the port's
    job record)."""
    sets = {}
    for name in ("jax", "port"):
        os.mkdir(tmp_path / name)
        base = str(tmp_path / name / "o")
        if name == "jax":
            rel = None if relative is None else jax_read_ktab(relative)
            out = jpipe.count_files([path], K, batch_bases=batch_bases,
                                    relative_table=rel, out_base=base, **kw)
        else:
            rel = None if relative is None else read_ktab(relative)
            out, rec = _traced(tpipe.count_files, [path], K,
                               batch_bases=batch_bases, relative_table=rel,
                               out_base=base, device="cpu", **kw)
        if out.hist is not None:
            write_histogram(base, out.hist)
        sets[name] = file_set(tmp_path / name)
    return sets["jax"], sets["port"], rec


def _kept_budget(path):
    """An instance budget that holds the first batch's slices alone."""
    return _slices(path, BATCH)[0] * tpipe._inst_bytes(CAP, K)


# name: (count_files arguments, instance budget (None: the default, a
# callable: of the input), which batches keep their packed slices for the
# join ("none", "all", "after_first"))
MULTI = {
    "hist": (dict(), None, "none"),
    "table": (dict(table_min=2), None, "none"),
    "table_profiles_fit": (dict(table_min=2, profiles=True), None, "none"),
    "table_profiles_no_room": (dict(table_min=2, profiles=True), 0, "all"),
    "table_profiles_room_for_one_batch": (
        dict(table_min=2, profiles=True), _kept_budget, "after_first"),
}


@pytest.mark.parametrize("case", list(MULTI))
def test_multi_slice_jobs_upload_codes(tmp_path, reads_path, monkeypatch,
                                       case):
    kw, budget, kept = MULTI[case]
    for mod in (jpipe, tpipe):
        monkeypatch.setattr(mod, "MAX_DEVICE_POSITIONS", CAP)
    if budget is None:
        monkeypatch.delenv("FASTK_TPU_INST_HBM", raising=False)
    else:
        b = budget(reads_path) if callable(budget) else budget
        monkeypatch.setenv("FASTK_TPU_INST_HBM", str(b))
    jax_set, port_set, rec = _both(tmp_path, reads_path, BATCH, **kw)
    assert port_set == jax_set
    assert "o.hist" in port_set
    assert any(".ktab" in n for n in port_set) == ("table_min" in kw)
    assert any(".prof" in n for n in port_set) == bool(kw.get("profiles"))
    slices = _slices(reads_path, BATCH)
    assert len(slices) == 3 and min(slices) >= 2
    packed = {"none": 0, "all": sum(slices),
              "after_first": sum(slices[1:])}[kept]
    # every slice goes up once as codes; the join uploads the kept ones. A
    # job without profiles reads batches of one slice, not of BATCH bases
    raw = (sum(slices) if kw.get("profiles")
           else _slice_batches(reads_path, CAP))
    assert _uploads(rec) == (raw, packed, packed)
    assert ("wait.unpack" in rec["spans"]) == (packed > 0)
    assert rec["spans"]["dedup"]["calls"] == raw


@pytest.mark.parametrize("cap", [CAP, 2 * CAP, 4 * CAP],
                         ids=["seven", "four", "two"])
@pytest.mark.parametrize("kw", [dict(), dict(table_min=2)],
                         ids=["hist", "table"])
def test_counting_jobs_read_a_slice_a_batch(tmp_path, reads_path,
                                            monkeypatch, kw, cap):
    """The histogram and -t2 jobs read batches of one device slice at
    the caller's batch_bases, and write fastk_tpu's bytes."""
    for mod in (jpipe, tpipe):
        monkeypatch.setattr(mod, "MAX_DEVICE_POSITIONS", cap)
    nbatches = _slice_batches(reads_path, cap)
    assert nbatches == {CAP: 7, 2 * CAP: 4, 4 * CAP: 2}[cap]
    assert len(_slices(reads_path, 64 << 20)) == 1  # fastk_tpu: one batch
    jax_set, port_set, rec = _both(tmp_path, reads_path, 64 << 20, **kw)
    assert port_set == jax_set
    assert any(".ktab" in n for n in port_set) == ("table_min" in kw)
    c = rec["counters"]
    assert c["upload.raw_slices"] == rec["spans"]["dedup"]["calls"] == (
        nbatches)
    assert c["count.slices_ahead"] == _ahead(nbatches)
    assert "wait.segment_end" not in rec["spans"]


@pytest.mark.parametrize("budget", [None, 0], ids=["fit", "no_room"])
def test_profile_jobs_keep_their_batches(tmp_path, reads_path, monkeypatch,
                                         budget):
    """A -t2 -p job keeps per-batch state for its profile pass, so it reads
    batches of batch_bases, each in several slices: two batches here, the
    first one's slices queued before the second is read."""
    for mod in (jpipe, tpipe):
        monkeypatch.setattr(mod, "MAX_DEVICE_POSITIONS", CAP)
    if budget is None:
        monkeypatch.delenv("FASTK_TPU_INST_HBM", raising=False)
    else:
        monkeypatch.setenv("FASTK_TPU_INST_HBM", str(budget))
    batch = 110_000
    slices = _slices(reads_path, batch)
    assert len(slices) == 2 and min(slices) >= 3
    jax_set, port_set, rec = _both(tmp_path, reads_path, batch, table_min=2,
                                   profiles=True)
    assert port_set == jax_set
    packed = 0 if budget is None else sum(slices)
    assert _uploads(rec) == (sum(slices), packed, packed)
    assert rec["counters"]["count.slices_ahead"] == slices[0]


def test_two_batch_job_queues_before_its_second_read(tmp_path, reads_path,
                                                     monkeypatch):
    """A -k job of two one-slice batches queues the first batch's slice
    before the reader reads the second: the first batch was cut before a
    read that did not fit, so it cannot be the whole input."""
    for mod in (jpipe, tpipe):
        monkeypatch.setattr(mod, "MAX_DEVICE_POSITIONS", 4 * CAP)
    assert _slice_batches(reads_path, 4 * CAP) == 2
    jax_set, port_set, rec = _both(tmp_path, reads_path, 64 << 20)
    assert port_set == jax_set
    main = [e for e in rec["events"] if e[3] == rec_thread(rec)]
    (first,) = [e for e in main if e[0] == "count.first_batch"]
    uploads = sorted(e[1] for e in main if e[0] == "upload")
    reads = [e for e in main if e[0] == "reader.batch"]
    assert len(uploads) == 2
    assert first[2] <= uploads[0]
    # the second batch is cut after the first slice went up
    assert max(e[2] for e in reads) > uploads[0]
    assert rec["counters"]["count.slices_ahead"] == 1


def test_single_batch_job_launches_k1_once(tmp_path, reads_path,
                                           monkeypatch):
    """A -k job of one batch still takes the single-batch path: one upload
    and one run-length histogram (K1) call, after both reads."""
    from fastk_tpu_torch.ops import histker

    calls = []
    orig = histker.run_hist
    monkeypatch.setattr(histker, "run_hist",
                        lambda *a: calls.append(1) or orig(*a))
    jax_set, port_set, rec = _both(tmp_path, reads_path, 64 << 20)
    assert port_set == jax_set
    assert len(calls) == 1
    assert _uploads(rec) == (1, 0, 0)
    assert "dedup" not in rec["spans"]  # no unique_batch, no merge of blocks
    assert rec["spans"]["count.first_batch"]["calls"] == 1


def rec_thread(rec):
    """The job's own thread in its record."""
    (job,) = [e for e in rec["events"] if e[0] == "job"]
    return job[3]


def test_relative_profiles_upload_packed(tmp_path, reads_path, monkeypatch):
    """-p:<table> keeps every slice packed and uploads it once, for the
    join."""
    for mod in (jpipe, tpipe):
        monkeypatch.setattr(mod, "MAX_DEVICE_POSITIONS", CAP)
    table = jpipe.count_files([reads_path], K, table_min=2).table
    tab = str(tmp_path / "tab")
    write_ktab(tab, table)
    (tmp_path / "run").mkdir()
    jax_set, port_set, rec = _both(tmp_path / "run", reads_path, BATCH,
                                   relative=tab + ".ktab", profiles=True)
    assert port_set == jax_set
    assert any(".prof" in n for n in port_set)
    n = sum(_slices(reads_path, BATCH))
    assert _uploads(rec) == (0, n, n)


@pytest.mark.parametrize("kw", [dict(), dict(table_min=2, profiles=True)],
                         ids=["hist", "fused"])
def test_single_batch_job_uploads_codes(tmp_path, reads_path, kw):
    jax_set, port_set, rec = _both(tmp_path, reads_path, 64 << 20, **kw)
    assert port_set == jax_set
    assert _uploads(rec) == (1, 0, 0)


def test_out_of_core_cli_uploads_codes(tmp_path, reads_path, monkeypatch,
                                       capsys):
    """-M1 with a device budget the input does not fit: the plan measures
    one slice, then the job runs out of core in one more, both as codes."""
    monkeypatch.setenv("FASTK_TPU_HBM_GB", "0.0002")
    for d in ("jax", "port", "sj", "sp"):
        os.mkdir(tmp_path / d)
    argv = ["-k40", "-t2", "-p", "-M1", "-v"]
    assert jax_fastk_main(argv + [f"-P{tmp_path}/sj", reads_path,
                                  f"-N{tmp_path}/jax/o"]) == 0
    capsys.readouterr()
    before = len(trace.jobs())
    with profile(activities=[ProfilerActivity.CPU]):
        assert fastk_main(argv + [f"-P{tmp_path}/sp", reads_path,
                                  f"-N{tmp_path}/port/o"], device="cpu") == 0
    assert "out-of-core:" in capsys.readouterr().err
    assert len(trace.jobs()) == min(before + 1, trace.JOBS_KEPT)
    rec = trace.jobs()[-1]
    got = file_set(tmp_path / "port")
    assert got == file_set(tmp_path / "jax")
    assert {"o.hist", "o.ktab", "o.prof"} <= set(got)
    assert rec["spans"]["plan"]["calls"] >= 1
    assert "wait.plan_nvalid" in rec["spans"]  # the plan measured
    assert _uploads(rec) == (2, 0, 0)


def test_device_codes_equal_the_packed_round_trip():
    """Every code 0..4, at a length that is no multiple of 16."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, size=(1 << 14) + 37, dtype=np.uint8)
    codes[:5] = np.arange(5, dtype=np.uint8)
    dev = torch.device("cpu")
    pw, exc = tpack.pack_stream_words(codes)
    want = tpack.upload_packed(pw, exc, len(codes), dev)
    got = device_codes(codes, dev)
    assert got.dtype == want.dtype == torch.uint8
    assert torch.equal(got, want)
    codes[0] = 3  # a new tensor, not a view of the host array
    assert int(got[0]) == 0


def test_kept_slices_leave_the_fill_out(reads_path, monkeypatch):
    """A kept slice is packed without the code-4 fill past its batch's end;
    its upload for the join gives back the whole slice."""
    monkeypatch.setattr(tpipe, "MAX_DEVICE_POSITIONS", CAP)
    dev = torch.device("cpu")
    codes = next(batched_reads([reads_path], BATCH))[0].codes
    short = 0
    for off, _size, buf in tpipe._code_slices(codes, K):
        n = min(len(buf), len(codes) - off)
        short += n < len(buf)
        pw, exc = tpack.pack_stream_words(buf[:n])
        got = tpipe._kept_codes(pw, exc, n, len(buf), dev)
        assert torch.equal(got, torch.from_numpy(buf))
    assert short == 1  # the batch's last slice
