"""CPU tests of the benchmark harness: its data files, its generator, its
reference against the port, its control and planted faults, its result line,
and that nothing it reaches imports JAX or the JAX package.

    python3 -m pytest kbench/tests -q
"""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from kbench import control, gen, run, spec
from kbench.reference import compare
from kbench.reference import count as ref
from kbench.reference import formats
from kbench.reference.parse import read_sequences

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# sizes a test holds: every width kept, the genome and the depth cut
TINY = {"hifi50x-k40": {"genome_length": 30000, "read_length": 2000,
                        "coverage": 5},
        "illumina40x-k21": {"genome_length": 30000, "coverage": 5}}
# the control's collisions need some hundred thousand distinct k-mers
CONTROL = {"hifi50x-k40": {"genome_length": 400000, "read_length": 2000,
                           "coverage": 6},
           "illumina40x-k21": {"genome_length": 400000, "coverage": 6}}


def _config_of(cell: str) -> str:
    return next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return tmp_path


# --- the data files -----------------------------------------------------------

def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["kbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for w in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = spec.load(cell)
    assert c.chips == 1
    assert c.config["k"] >= 5 and c.config["memory_gb"] >= 1
    assert c.traffic["query"] in ("reads", "assembly")
    assert set(c.traffic["outputs"]) <= {"hist", "ktab", "prof"}
    conf = next(x for x in BENCH["configs"] if x["name"] == _config_of(cell))
    assert os.path.exists(os.path.join(spec.ROOT, conf["file"]))
    assert conf["file"].startswith("kbench/")
    assert sorted(conf["reduced"]) == sorted(c.config["reduced"])
    assert c.per_layer


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_targets_exist(name):
    mod = spec.metric_reader(name)
    assert callable(mod.read)
    from kbench.spans import _resolve

    for tgt in mod.SPANS.values():
        target = tgt if isinstance(tgt, str) else tgt[0]
        assert _resolve(target) is not None, target


def test_gap_name_targets_exist():
    from kbench.spans import GAP_NAMES, _resolve

    for target in GAP_NAMES.values():
        assert _resolve(target) is not None, target


def test_missing_target_is_left_out():
    from kbench.spans import Spans

    s = Spans(None)
    assert not s.install("x", "fastk_tpu_torch.ops.count:no_such_function")
    assert not s.install("x", "fastk_tpu_torch.no_such_module:f")
    assert s.stats == {}


# --- the generator --------------------------------------------------------------

@pytest.mark.parametrize("config", sorted(TINY))
def test_generator_deterministic(config, tmp_path):
    cell = next(w for w in CELLS if _config_of(w) == config)
    sample = spec.load(cell, TINY[config]).config["sample"]
    big = 2 ** 33 + 5  # past 32 signed bits
    g1, g2 = gen.genome(big, 30000), gen.genome(big, 30000)
    assert np.array_equal(g1, g2)
    assert not np.array_equal(g1, gen.genome(big + 1, 30000))
    r1, r2 = gen.reads(big, g1, sample), gen.reads(big, g2, sample)
    assert np.array_equal(r1, r2)
    assert r1.shape == (gen.nreads(sample), sample["read_length"])
    assert r1.shape == gen.reads(big + 1, g1, sample).shape
    p1 = tmp_path / ("a." + sample["format"])
    p2 = tmp_path / ("b." + sample["format"])
    gen.write_reads(str(p1), r1, big, sample)
    gen.write_reads(str(p2), r2, big, sample)
    assert p1.read_bytes() == p2.read_bytes()
    codes, rlen = read_sequences(str(p1))
    assert (rlen == sample["read_length"]).all()
    assert np.array_equal(codes.reshape(r1.shape), r1)


def test_reads_keep_their_error_rate():
    sample = spec.load("hifi50x-k40-hist", TINY["hifi50x-k40"]).config[
        "sample"]
    sample = dict(sample, revcomp_fraction=0.0)
    g = gen.genome(3, 30000)
    r = gen.reads(3, g, sample)
    win = np.lib.stride_tricks.sliding_window_view(g, r.shape[1])
    # each read differs from its best window at about 0.3 % of bases
    diffs = [int((win != row).sum(axis=1).min()) for row in r[:20]]
    assert 0 < sum(diffs) < 0.01 * 20 * r.shape[1]


# --- the reference, the readers and the roofline --------------------------------

def test_reference_counts_a_known_example():
    # reads ACGTA and TACGT (the reverse complement), k = 3
    codes = torch.tensor([0, 1, 2, 3, 0, 3, 0, 1, 2, 3])
    rlen = torch.tensor([5, 5])
    words = ref.canonical_words(codes, rlen, 3)
    uniq, counts, inverse = ref.count(words)
    # ACG/CGT pair to ACG, GTA/TAC to GTA: each 2 a read
    got = {tuple(int(w[i]) for w in uniq): int(counts[i])
           for i in range(len(counts))}
    acg, gta = (0 * 16 + 1 * 4 + 2,), (2 * 16 + 3 * 4 + 0,)
    assert got == {acg: 4, gta: 2}
    assert ref.own_profiles(counts, inverse).tolist() == [4, 4, 2, 2, 4, 4]


def test_word_order_is_string_order():
    for k in (21, 31, 32, 40, 63):
        codes = torch.randint(0, 4, (5000,), generator=torch.Generator()
                              .manual_seed(k))
        rlen = torch.tensor([5000])
        words = ref.canonical_words(codes, rlen, k)
        packed = formats.words_to_packed(words, k)
        back = formats.packed_to_words(packed, k, "cpu")
        assert all(torch.equal(a, b) for a, b in zip(words, back))
        perm = ref.lex_order(words)
        rows = packed[perm.numpy()]
        assert all(bytes(rows[i]) <= bytes(rows[i + 1])
                   for i in range(len(rows) - 1))


def test_profile_decoder_round_trips_every_token_kind(tmp_path):
    from fastk_tpu_torch.formats.prof import write_prof

    rng = np.random.default_rng(5)
    profs = [np.zeros(0, np.uint16), np.array([200], np.uint16),
             np.array([5, 5, 5, 5] + [5] * 130 + [40, 9, 32767, 0, 100],
                      np.uint16)]
    profs += [rng.integers(0, 300, n).astype(np.uint16) for n in (1, 7, 900)]
    write_prof(str(tmp_path / "p"), 40, profs, nparts=3)
    k, lengths, values = formats.read_prof(str(tmp_path / "p"), "cpu")
    assert k == 40
    assert lengths.tolist() == [len(p) for p in profs]
    assert values.tolist() == np.concatenate(profs).astype(int).tolist()


def test_ktab_writer_is_read_back_by_the_port(tmp_path):
    from fastk_tpu_torch.formats.ktab import read_ktab as port_read

    codes = torch.randint(0, 4, (400000,), generator=torch.Generator()
                          .manual_seed(9))
    uniq, counts, _ = ref.count(ref.canonical_words(
        codes, torch.tensor([400000]), 40))
    packed = formats.words_to_packed(uniq, 40)
    c16 = counts.numpy().astype(np.uint16)
    formats.write_ktab(str(tmp_path / "t"), 40, 1, packed, c16)
    t = port_read(str(tmp_path / "t"))
    assert np.array_equal(t.packed, packed) and np.array_equal(t.counts, c16)
    k, tmin, p2, c2 = formats.read_ktab(str(tmp_path / "t"))
    assert (k, tmin) == (40, 1)
    assert np.array_equal(p2, packed) and np.array_equal(c2, c16)


def test_roofline_bytes_of_known_shapes():
    size = 1 << 20
    for k, W in ((40, 3), (21, 2)):
        codes = torch.zeros(size + k + 16, dtype=torch.uint8)
        words = tuple(torch.zeros(size, dtype=torch.int64) for _ in range(W))
        invalid = torch.zeros(size, dtype=torch.bool)
        mod = spec.metric_reader("canonical_kmers_roofline")
        _, fn = mod.SPANS["canonical_kmers"]
        assert fn((codes, k, size), {}, (words, invalid)) == (
            size + k + 16) + W * 8 * size + size
    mod = spec.metric_reader("sort_keys_roofline")
    _, fn = mod.SPANS["sort_keys"]
    vals = (torch.zeros(size, dtype=torch.int32),)
    assert fn((words,), {}, (words, vals)) == 2 * (2 * 8 * size + 4 * size)
    from kbench.roofline import share_pct

    # 3.35 GB in a millisecond is the whole bandwidth
    assert share_pct(3_350_000_000, 1e-3) == pytest.approx(100.0)
    assert share_pct(0, 1.0) is None and share_pct(10, 0.0) is None


# --- whole runs on the CPU: the reference against the port ----------------------

@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tmpdir_env):
    result, limits = run.run(cell, 2 ** 31 + 11, 0.2, False, device="cpu",
                             sample=TINY[_config_of(cell)])
    assert result["correct"], result["checks"]
    outputs = spec.load(cell).traffic["outputs"]
    assert set(limits) == {o + "_off" for o in outputs}
    assert result["run_hist_launches"] == 0
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    assert set(result["metrics"]) == {"bases_per_s", "device_peak_gb",
                                      "host_peak_gb", "setup_s"}
    assert set(result["device"]) >= {"platform", "kind", "count",
                                      "memory_peak_bytes"}
    json.dumps(result)


def test_traced_run_reports_per_layer_metrics(tmpdir_env):
    cell = "hifi50x-k40-asmprof"
    result, _ = run.run(cell, 3, 0.2, True, device="cpu",
                        sample=TINY["hifi50x-k40"])
    assert result["correct"]
    # no device work on the CPU: the outside spans and the port's own job
    # records remain; the card's idle share and the rooflines are left out
    assert set(result["metrics"]) == {"ingest.host_s_per_gbp",
                                      "prof_out.host_s_per_gbp",
                                      "relative_table.host_ms_per_job",
                                      "reader.raw_s_per_gbp",
                                      "reader.parse_wait_s_per_gbp",
                                      "upload.host_ms_per_gbp",
                                      "host_blocked_ms_per_job",
                                      "prof_out.encode_s_per_gbp"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_prints_no_result(tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "kbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=spec.ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no result" in r.stderr


# --- the control and planted faults must come out not correct -------------------

@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tmp_path):
    c = spec.load(cell, CONTROL[_config_of(cell)])
    k = c.config["k"]
    inputs = spec.make_inputs(c, 77, str(tmp_path), "cpu")
    want = compare.expected(c.traffic, k, inputs, "cpu")
    assert all(v == 0 for v in compare.compare(
        k, want, control.as_got(k, want)).values())
    ctl = compare.compare(k, want, control.as_got(
        k, control.outputs(c.traffic, k, inputs, "cpu")))
    assert any(v > compare.LIMITS[n] for n, v in ctl.items()), ctl


def _half_the_reads(monkeypatch):
    from fastk_tpu_torch.io.reader import ReadBatch
    from fastk_tpu_torch.pipeline import count as pc

    orig = pc.batched_reads

    def half(*args, **kwargs):
        for batch, ordinal in orig(*args, **kwargs):
            if batch.nreads > 1:  # the first half of the reads
                n = batch.nreads // 2
                end = int(batch.boff[n])
                yield ReadBatch(batch.codes[:end], batch.boff[: n + 1],
                                batch.rlen[:n]), ordinal
            else:  # the first half of the one read
                m = int(batch.rlen[0]) // 2
                codes = np.append(batch.codes[:m], np.uint8(4))
                yield ReadBatch(codes, np.array([0, m + 1]),
                                np.array([m])), ordinal

    monkeypatch.setattr(pc, "batched_reads", half)


def _one_count_altered(monkeypatch):
    from fastk_tpu_torch.pipeline import count as pc

    hist, table, sink = pc._histogram, pc._table_entries, pc._ProfSink.add_batch

    def histogram(*args):
        h = hist(*args)
        h.counts[2] += 1
        return h

    def table_entries(*args):
        packed, counts = table(*args)
        counts = counts.copy()
        counts[len(counts) // 2] += 1
        return packed, counts

    def add_batch(self, boff, rlen, pos_counts):
        pos_counts = pos_counts.copy()
        pos_counts[len(pos_counts) // 3] += 1
        return sink(self, boff, rlen, pos_counts)

    monkeypatch.setattr(pc, "_histogram", histogram)
    monkeypatch.setattr(pc, "_table_entries", table_entries)
    monkeypatch.setattr(pc._ProfSink, "add_batch", add_batch)


@pytest.mark.parametrize("fault", [_half_the_reads, _one_count_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, tmpdir_env, monkeypatch):
    fault(monkeypatch)
    result, limits = run.run(cell, 5, 0.1, False, device="cpu",
                             sample=TINY[_config_of(cell)])
    assert not result["correct"]
    assert any(v > lim for v, lim in limits.values())


# --- no JAX ---------------------------------------------------------------------

def _kbench_files():
    for d, _dirs, files in os.walk(os.path.join(spec.ROOT, "kbench")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax():
    for path in _kbench_files():
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in run.FORBIDDEN, (path, n)


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, json\n"
        "from kbench import run, spec, control\n"
        "for name in [m['name'] for m in spec.benchmark()['per_layer']]:\n"
        "    spec.metric_reader(name)\n"
        "res, _ = run.run('hifi50x-k40-t4p', 1, 0.1, True, device='cpu',\n"
        "                 sample=json.loads(sys.argv[1]))\n"
        "assert res['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code,
                        json.dumps(TINY["hifi50x-k40"])], cwd=spec.ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "fastk_tpu_torch" in top
    assert not top & set(run.FORBIDDEN)


# --- on the card ----------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, tmpdir_env):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = run.run(cell, 2 ** 31 + 3, 1.0, False)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


def test_without_the_port_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "kbench"), tmp_path / "kbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import sys\n"
            "from kbench import run\n"
            "try:\n"
            "    run.run('hifi50x-k40-hist', 1, 0.1, False, device='cpu')\n"
            "except run.NotRun as e:\n"
            "    print(e, file=sys.stderr)\n"
            "    sys.exit(7)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TMPDIR"] = str(tmp_path)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 7, r.stderr[-2000:]
    assert "does not import" in r.stderr
    assert r.stdout.strip() == ""
