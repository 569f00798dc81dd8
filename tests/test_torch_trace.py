"""The port's in-program spans and counters (fastk_tpu_torch/trace.py) on the
CPU: nothing is recorded or built without a profiler; under one, the CLI's
jobs keep records whose spans, counters and waits agree with the job, and
whose fastk:<span> ranges reach the profiler's trace."""

import gzip
import json
import os
import shutil
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fastk_tpu_torch.io.reader as treader
import fastk_tpu_torch.pipeline.count as tpipe
import fastk_tpu_torch.tools.fastk as cli
from fastk_tpu_torch import trace
from fastk_tpu_torch.formats.hist import read_histogram
from fastk_tpu_torch.ops.pack import pack_stream_words

HERE = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(HERE, "golden", "inputs")
SMALL = os.path.join(INPUTS, "small.fasta")
BATCH = 20000  # bases a batch: the small inputs run the multi-batch path

INGEST = {"reader.raw", "reader.snap", "reader.wait", "reader.parse",
          "reader.batch", "upload"}
# the spans of each job kind, on the path the benchmark's jobs take
SPANS = {
    # the small inputs' instance streams fit the budget: nothing is packed
    "t4p": INGEST | {
        "job", "plan", "count.first_batch", "dedup", "merge", "table_out",
        "ktab_write", "hist_write", "join", "prof_out.encode", "prof_out.write",
        "wait.later", "wait.fetch_u16", "wait.bincount",
        "wait.hist_bins", "wait.merge_nuniq", "wait.table_nkeep",
        "wait.table_words", "wait.plan_nvalid", "wait.plan_nuniq"},
    # every slice is packed, kept and uploaded once, for the join
    "relative": INGEST | {
        "job", "plan", "count.first_batch", "pack", "relative_table.read",
        "relative_table.upload", "join", "prof_out.encode",
        "prof_out.write", "wait.fetch_u16", "wait.unpack",
        "wait.table_upload"},
}
# the spans of the packed form, which the t4p job does not take
PACKED = {"pack", "wait.unpack"}
# sites where the host no longer waits for the card
GONE = {"wait.segment_end"}


def _raise(*args, **kwargs):
    raise AssertionError("record_function built with tracing off")


@pytest.fixture
def multi_batch(monkeypatch):
    """The CLI's batches cut to BATCH bases, and the plan forced to measure
    (a worst case that does not fit), as the benchmark's -t4 -p job does."""
    monkeypatch.setattr(cli, "_batch_bases", lambda cfg: BATCH)
    monkeypatch.setattr(cli, "_ooc_plan",
                        lambda *a: (2, 1 << 22))
    monkeypatch.setenv("FASTK_TPU_INGEST_THREADS", "1")


def _traced(argv, tmp_path):
    """Run the CLI under a CPU profiler; returns (the job's record, the
    user annotations of the exported Chrome trace)."""
    before = len(trace.jobs())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert cli.main(argv, device="cpu") == 0
    jobs = trace.jobs()
    assert len(jobs) == min(before + 1, trace.JOBS_KEPT)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {ev["name"] for ev in events
             if ev.get("cat") == "user_annotation"}
    return jobs[-1], names


def _uploads(path, k, packed=False, slices_of_first=False):
    """(bytes, slices) of every slice the job uploads: every slice of every
    batch, as its codes or as the packed words and exceptions of its codes
    before the batch's end, and, for the plan, the first batch's first
    slice again, as codes."""
    total = first = slices = 0
    for i, (batch, _) in enumerate(treader.batched_reads([path], BATCH)):
        for j, (off, _s, buf) in enumerate(
                tpipe._code_slices(batch.codes, k)):
            if packed:
                pw, exc = pack_stream_words(buf[:len(batch.codes) - off])
                total += pw.nbytes + exc.nbytes
            else:
                total += buf.nbytes
            slices += 1
            if i == 0 and j == 0:
                first = buf.nbytes
    if slices_of_first:
        return total + first, slices + 1
    return total, slices


def _bases(path):
    batches = [b for b, _ in treader.batched_reads([path], BATCH)]
    return sum(b.totlen for b in batches), batches[0].totlen


def _check_record(rec, names, kind):
    spans = rec["spans"]
    assert SPANS[kind] <= set(spans), SPANS[kind] - set(spans)
    assert not GONE & set(spans)
    main = threading_main(rec)
    for name, s in spans.items():
        assert s["calls"] >= 1
        assert s["self_s"] <= s["host_s"] + 1e-9, name
        assert s["main_s"] <= s["host_s"] + 1e-9, name
        if s["main_s"] > 0:
            assert "fastk:" + name in names, name
    top = [e for e in rec["events"] if e[4] == "job" and e[3] == main]
    assert top and sum(e[2] - e[1] for e in top) <= rec["wall_s"]
    assert 0 < rec["host_blocked_s"] <= rec["wall_s"]
    assert rec["host_blocked_s"] <= sum(
        s["host_s"] for n, s in spans.items() if n.startswith("wait."))
    # one worker: the parse is the main thread's wait for its piece
    parents = {e[4] for e in rec["events"] if e[0] == "reader.parse"}
    assert parents == {"reader.wait"}


def threading_main(rec):
    (job,) = [e for e in rec["events"] if e[0] == "job"]
    assert job[4] is None
    return job[3]


def test_off_keeps_nothing_and_builds_no_record_function(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    before = trace.jobs()
    assert not torch.autograd._profiler_enabled()
    assert cli.main(["-k40", "-t4", "-p", f"-N{tmp_path}/o", SMALL],
                    device="cpu") == 0
    assert trace.jobs() == before
    assert not trace.active()
    assert trace.span("x") is trace.wait("y") is trace.span("z")
    trace.count("x", 1)


def test_t4p_job_record(tmp_path, multi_batch):
    k = 40
    rec, names = _traced(["-k40", "-t4", "-p", f"-N{tmp_path}/o", SMALL],
                         tmp_path)
    _check_record(rec, names, "t4p")
    c = rec["counters"]
    bases, first = _bases(SMALL)
    assert c["reader.bases"] == bases + first  # the plan reads batch 1 again
    assert not PACKED & set(rec["spans"])
    nbytes, slices = _uploads(SMALL, k, slices_of_first=True)
    assert c["upload.bytes"] == nbytes
    assert c["upload.raw_slices"] == slices
    assert "upload.packed_slices" not in c
    hist = read_histogram(str(tmp_path / "o"))
    assert c["dedup.positions"] == hist.total_instances()
    assert 0 < c["dedup.uniques"] <= c["dedup.positions"]
    assert rec["spans"]["plan"]["calls"] == 2
    # the card waits for the first batch alone: the reader cut it before a
    # read that did not fit
    assert rec["spans"]["count.first_batch"]["calls"] == 1
    first = [e for e in rec["events"] if e[0] == "count.first_batch"]
    batches = [e for e in rec["events"] if e[0] == "reader.batch"
               and e[4] == "count.first_batch"]
    assert len(first) == 1 and len(batches) == 1
    assert rec["spans"]["dedup"]["calls"] == len(list(
        treader.batched_reads([SMALL], BATCH))) + 1
    # the slices queued before the last batch was read, the first batch
    # (cut before a read that did not fit) being read before any
    per_batch = [len(list(tpipe._code_slices(b.codes, k)))
                 for b, _ in treader.batched_reads([SMALL], BATCH)]
    assert len(per_batch) >= 3
    assert c["count.slices_ahead"] == sum(per_batch[:-1])
    size = os.path.getsize(SMALL)
    assert c["reader.text_bytes"] == c["reader.file_bytes"] == 2 * size


def test_relative_job_record(tmp_path, multi_batch):
    assert cli.main(["-k40", "-t4", f"-N{tmp_path}/tab", SMALL],
                    device="cpu") == 0
    query = os.path.join(INPUTS, "small2.fasta")
    rec, names = _traced(["-k40", f"-p:{tmp_path}/tab.ktab",
                          f"-N{tmp_path}/rel", query], tmp_path)
    _check_record(rec, names, "relative")
    assert "dedup" not in rec["spans"] and "merge" not in rec["spans"]
    c = rec["counters"]
    assert c["reader.bases"] == _bases(query)[0]
    nbytes, slices = _uploads(query, 40, packed=True)
    assert c["upload.bytes"] == nbytes
    assert c["upload.packed_slices"] == rec["spans"]["pack"]["calls"] == slices
    assert "upload.raw_slices" not in c
    assert "dedup.positions" not in c


def test_failed_job_leaves_no_record(tmp_path, multi_batch):
    assert cli.main(["-k40", "-t4", f"-N{tmp_path}/tab", SMALL],
                    device="cpu") == 0
    before = len(trace.jobs())
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(SystemExit):  # the table's k is not -k32's
            cli.main(["-k32", f"-p:{tmp_path}/tab.ktab", f"-N{tmp_path}/r",
                      SMALL], device="cpu")
    assert len(trace.jobs()) == before
    assert not trace.active()


def test_parse_recorded_from_worker_threads(tmp_path, monkeypatch):
    monkeypatch.setenv("FASTK_TPU_INGEST_THREADS", "2")
    chunks = treader._record_chunks
    monkeypatch.setattr(treader, "_record_chunks",
                        lambda path, fmt: chunks(path, fmt, 50000))
    rec, names = _traced(["-k40", f"-N{tmp_path}/o", SMALL], tmp_path)
    main = threading_main(rec)
    parse = [e for e in rec["events"] if e[0] == "reader.parse"]
    assert len(parse) >= 10
    assert {e[3] for e in parse} and main not in {e[3] for e in parse}
    assert all(e[4] is None for e in parse)  # top level of their thread
    s = rec["spans"]["reader.parse"]
    assert s["main_s"] == 0 and s["host_s"] > 0
    assert "fastk:reader.parse" not in names  # the profiler's thread only
    # each chunk's hand-off to the pool, then the wait for its piece
    assert rec["spans"]["reader.wait"]["calls"] == 2 * len(parse)
    assert rec["counters"]["reader.bases"] == _bases(SMALL)[0]


def test_gzipped_fastq_counts_compressed_bytes(tmp_path):
    src = os.path.join(INPUTS, "smallq.fastq")
    gz = str(tmp_path / "q.fastq.gz")
    with open(src, "rb") as f, gzip.open(gz, "wb") as g:
        shutil.copyfileobj(f, g)
    rec, _ = _traced(["-k32", f"-N{tmp_path}/q", gz], tmp_path)
    c = rec["counters"]
    assert c["reader.file_bytes"] == os.path.getsize(gz)
    assert c["reader.text_bytes"] == os.path.getsize(src)
    assert c["reader.file_bytes"] < c["reader.text_bytes"]


def test_spans_self_seconds_and_nested_waits():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.job():
            assert trace.active()
            with trace.span("outer"):
                with trace.wait("a"):
                    with trace.wait("b"):
                        trace.count("n", 2)
                trace.count("n", 3)
            with trace.span("outer"):
                pass
    rec = trace.jobs()[-1]
    assert rec["counters"] == {"n": 5}
    s = rec["spans"]
    assert s["outer"]["calls"] == 2 and s["job"]["calls"] == 1
    assert s["outer"]["self_s"] <= (s["outer"]["host_s"] - s["wait.a"]["host_s"]
                                    + 1e-9)
    # the inner wait is inside the outer one: the host blocked once
    assert rec["host_blocked_s"] == pytest.approx(s["wait.a"]["host_s"])
    parents = {e[0]: e[4] for e in rec["events"]}
    assert parents == {"wait.b": "wait.a", "wait.a": "outer", "outer": "job",
                       "job": None}


def test_spans_and_counts_from_many_threads():
    """More threads than cores, switching often: no span or count is lost."""
    nthreads, each = 4 * (os.cpu_count() or 1), 200

    def work():
        for _ in range(each):
            with trace.span("t"):
                trace.count("n", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.job():
                threads = [threading.Thread(target=work)
                           for _ in range(nthreads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
                assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rec = trace.jobs()[-1]
    assert rec["counters"]["n"] == nthreads * each
    s = rec["spans"]["t"]
    assert s["calls"] == nthreads * each and s["main_s"] == 0
    events = [e for e in rec["events"] if e[0] == "t"]
    assert len(events) == nthreads * each
    assert all(e[4] is None for e in events)
    assert len({e[3] for e in events}) > 1


def test_spans_outside_a_job_are_not_recorded():
    before = len(trace.jobs())
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("x"):
            trace.count("x", 1)
        tpipe.count_files([os.path.join(INPUTS, "tiny.fasta")], 12,
                          device="cpu")
    assert len(trace.jobs()) == before


def _kbench_targets():
    """(span, target) of every call the benchmark wraps: its gap spans and
    each per-layer metric's SPANS."""
    from kbench import spec
    from kbench.spans import GAP_NAMES

    out = dict(GAP_NAMES)
    for f in sorted(os.listdir(os.path.join(REPO, "kbench", "metrics"))):
        if f.endswith(".py"):
            for name, tgt in spec.metric_reader(f[:-3]).SPANS.items():
                out[name] = tgt if isinstance(tgt, str) else tgt[0]
    return sorted(out.items())


REPO = os.path.dirname(HERE)
KBENCH_TARGETS = _kbench_targets()


@pytest.mark.parametrize("span,target", KBENCH_TARGETS,
                         ids=[s for s, _ in KBENCH_TARGETS])
def test_kbench_targets_resolve(span, target):
    """A target that no longer resolves would drop its per-layer metric
    without an error: every one names a callable of the port."""
    from kbench.spans import _resolve

    assert _resolve(target) is not None, (span, target)


def test_kbench_harness_patch_targets():
    """The names kbench's harness tests patch to fault a job."""
    assert callable(tpipe._histogram) and callable(tpipe._table_entries)
    assert callable(tpipe._ProfSink.add_batch)
