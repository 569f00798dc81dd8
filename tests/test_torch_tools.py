"""The port's table tools against their JAX twins, exactly: each CLI runs
through ``main(argv)`` of both packages on the same goldens, each in a
directory of its own, and the return code, stdout, stderr and the bytes of
every file left in the directory must be equal. Tolerance: none.

Outputs are named relative to the working directory so that both runs print
the same text; sources that a tool removes or moves (fastcat by default,
fastmv, fastrm) are copied into that directory first.
"""

import importlib
import io
import os
import shutil
import time
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from fastk_tpu_torch.formats.hist import read_histogram
from fastk_tpu_torch.formats.ktab import read_ktab
from fastk_tpu_torch.formats.paths import hidden_files_of

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
SMALL = os.path.join(GOLDEN, "small_k40", "small")
SMALL2 = os.path.join(GOLDEN, "small2_k40", "small2")
SMALL_T3 = os.path.join(GOLDEN, "small_k40_t3", "small")
SMALLQ = os.path.join(GOLDEN, "smallq_k32", "smallq")
TINY = os.path.join(GOLDEN, "tiny_k12_t1", "tiny")
REL = os.path.join(GOLDEN, "rel_smallq_vs_small", "smallq")

PACKAGES = ("fastk_tpu", "fastk_tpu_torch")


def _tree(d):
    """{relative path: bytes} of every file under d, hidden parts included."""
    out = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def _copy_set(stub, dest_dir, name=None):
    """Copy a stub and its hidden parts into dest_dir (renamed to name)."""
    d, b = os.path.split(stub)
    root, ext = os.path.splitext(b)
    name = name or root
    shutil.copy(stub, os.path.join(dest_dir, name + ext))
    for h in hidden_files_of(stub):
        rest = os.path.basename(h)[len("." + root):]
        shutil.copy(h, os.path.join(dest_dir, "." + name + rest))


def _run(pkg, tool, argv, cwd):
    """(rc, stdout bytes, stderr text) of <pkg>.tools.<tool>.main(argv)
    run in cwd."""
    mod = importlib.import_module(f"{pkg}.tools.{tool}")
    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    err = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with redirect_stdout(out), redirect_stderr(err):
            try:
                rc = mod.main(list(argv))
            except SystemExit as e:
                rc = e.code
        out.flush()
    finally:
        os.chdir(old)
    return rc, buf.getvalue(), err.getvalue()


@pytest.fixture(autouse=True)
def _fixed_clock(monkeypatch):
    """ONEcode headers carry the date: fix it, so both runs write it alike."""
    monkeypatch.setattr(time, "strftime", lambda *a: "2026-01-01_00:00:00")


def run_both(tmp_path, tool, argv, setup=None):
    """Run the tool of both packages; assert equal results; return the
    port's (rc, stdout, stderr, {path: bytes}) and its directory."""
    res = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        if setup is not None:
            setup(str(d))
        rc, out, err = _run(pkg, tool, argv, str(d))
        res[pkg] = (rc, out, err, _tree(str(d)))
    want, got = res["fastk_tpu"], res["fastk_tpu_torch"]
    assert got[0] == want[0], (got[2], want[2])
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert sorted(got[3]) == sorted(want[3])
    for name in want[3]:
        assert got[3][name] == want[3][name], name
    return got, str(tmp_path / "fastk_tpu_torch")


def _entries(path):
    t = read_ktab(path)
    return t.packed, t.counts


def _agg(path):
    """{key: count} of a table, equal keys summed and clipped (the
    reference Fastmerge may split a key's count over two entries)."""
    t = read_ktab(path)
    kb = t.packed.shape[1]
    d = {}
    for k, c in zip(t.packed.view(f"S{kb}").ravel(), t.counts):
        d[bytes(k)] = min(d.get(bytes(k), 0) + int(c), 32767)
    return d


# --- the report tools: histex, tabex, profex, haplex, homex ----------------

HISTEX = [
    [SMALL + ".hist"],
    ["-k", SMALL + ".hist"],
    ["-A", SMALL + ".hist"],
    ["-G", SMALL + ".hist"],
    ["-k", "-h2:50", SMALL + ".hist"],
    ["-1", SMALL + ".hist"],
    ["-1a", "-h1:40", SMALL + ".hist"],
    ["-1", "-k", SMALLQ],
    [SMALLQ],
    ["-h5:20", SMALL2 + ".hist"],
]


@pytest.mark.parametrize("argv", HISTEX, ids=[" ".join(
    a[:-1]) or "default" for a in HISTEX])
def test_histex(tmp_path, argv):
    (rc, out, _, _), _ = run_both(tmp_path, "histex", argv)
    assert rc == 0 and out


def test_histex_goldens(tmp_path):
    """The oracle's Histex reports, through the port."""
    for argv, gold in (([], "histex_default.txt"), (["-A"], "histex_A.txt"),
                       (["-G"], "histex_G.txt"),
                       (["-k", "-h2:50"], "histex_k_h2_50.txt")):
        rc, out, _ = _run("fastk_tpu_torch", "histex",
                          argv + [SMALL + ".hist"], str(tmp_path))
        with open(os.path.join(GOLDEN, "small_k40", gold), "rb") as f:
            assert rc == 0 and out == f.read(), gold


TABEX = [
    [TINY + ".ktab"],
    ["-t5", TINY + ".ktab"],
    ["-C", SMALL + ".ktab"],
    ["-A", TINY + ".ktab"],
    [SMALL + ".ktab", "10-20"],
    [SMALL + ".ktab", "acg-acgt"],
    [SMALL + ".ktab", "gattaca"],
    ["-1", TINY + ".ktab"],
    ["-1a", "-t3", TINY + ".ktab"],
    [SMALL + ".ktab", "99999999"],
]


@pytest.mark.parametrize("argv", TABEX, ids=[" ".join(
    os.path.basename(x) for x in a) for a in TABEX])
def test_tabex(tmp_path, argv):
    (rc, out, err, _), _ = run_both(tmp_path, "tabex", argv)
    assert out or err


PROFEX = [
    [SMALL, "1-3"],
    ["-z", SMALL, "2"],
    ["-A", SMALL, "1"],
    ["-1", SMALL, "1-#"],
    ["-1a", SMALL, "1-5"],
    [REL, "1-2"],
    [SMALL + ".prof", "0"],
]


@pytest.mark.parametrize("argv", PROFEX, ids=[" ".join(
    os.path.basename(x) for x in a) for a in PROFEX])
def test_profex(tmp_path, argv):
    (rc, out, err, _), _ = run_both(tmp_path, "profex", argv)
    assert out or err


@pytest.mark.parametrize("argv", [["-g1:100", SMALL + ".ktab"],
                                  ["-H", "-g2:50", SMALL + ".ktab"],
                                  [SMALLQ + ".ktab"]],
                         ids=["g1_100", "H_g2_50", "smallq"])
def test_haplex(tmp_path, argv):
    (rc, _, _, _), _ = run_both(tmp_path, "haplex", argv)
    assert rc == 0


@pytest.mark.parametrize("argv", [["-e3", "-g5:100", SMALL + ".ktab"],
                                  ["-e2", "-g1:50", SMALLQ],
                                  ["-g5:100", SMALL + ".ktab"]],
                         ids=["e3_g5_100", "smallq", "no_e"])
def test_homex(tmp_path, argv):
    (rc, out, _, _), _ = run_both(tmp_path, "homex", argv)
    if argv[0] == "-e3":
        with open(os.path.join(GOLDEN, "homex", "small_e3_g5_100.txt"),
                  "rb") as f:
            assert rc == 0 and out == f.read()


# --- symmex, logex, vennex --------------------------------------------------

@pytest.mark.parametrize("argv", [["-T1", TINY + ".ktab", "sym"],
                                  ["-T4", SMALL + ".ktab", "sym"],
                                  ["-v", "-T2", SMALL_T3, "sym.ktab"],
                                  ["-T3", f"-P.", SMALLQ, "sym"]],
                         ids=["tiny_T1", "small_T4", "t3_T2_v", "smallq_P"])
def test_symmex(tmp_path, argv):
    (rc, _, _, files), d = run_both(tmp_path, "symmex", argv)
    assert rc == 0 and "sym.ktab" in files
    if argv[1] == TINY + ".ktab":
        for a, b in zip(_entries(os.path.join(d, "sym")),
                        _entries(os.path.join(GOLDEN, "symmex", "tinysym"))):
            assert np.array_equal(a, b)


# the oracle's Logex on the goldens (tests/test_logex.py)
LOGEX_GOLDEN = [
    ("inter", "A &. B"), ("uni", "A |+ B"), ("onlyA", "A - B"),
    ("sym", "A ^ B"), ("filt", "(A &> B)[5-20]"), ("gcf", "A{40-60}"),
    ("cnt1", "#A |+ #B"), ("avg", "(A |* B)[2-]"),
]


@pytest.mark.parametrize("name,expr", LOGEX_GOLDEN,
                         ids=[n for n, _ in LOGEX_GOLDEN])
def test_logex_goldens(tmp_path, name, expr):
    tabs = [SMALL + ".ktab", SMALL2 + ".ktab"][: 2 if "B" in expr else 1]
    (rc, _, _, _), d = run_both(
        tmp_path, "logex", ["-T2", "-h1:100", f"{name}={expr}", *tabs])
    assert rc == 0
    for a, b in zip(_entries(os.path.join(d, name)),
                    _entries(os.path.join(GOLDEN, "logex", name))):
        assert np.array_equal(a, b), name
    assert read_histogram(os.path.join(d, name)) == read_histogram(
        os.path.join(GOLDEN, "logex", name))


# every expression shape of the grammar (tests/test_stream_tools.py)
ALL_SHAPES = [
    ("XU", "A|+B|+C"), ("XI", "A&.B&.C"), ("XD", "(A-B)-C"),
    ("XX", "A^B"), ("XN", "#(A|B)"), ("XM1", "A|<B"), ("XM2", "A|>B"),
    ("XM3", "A|*B"), ("XM4", "A&-B"), ("XF", "A[5-200]|+B[2-]"),
    ("XG", "A{40-60}"), ("XC", "(A&+B)[10-3000]{20-80}"),
    ("XP", "#A|+#B|+#C"),
]
ABC = [SMALL + ".ktab", SMALL2 + ".ktab", SMALL_T3 + ".ktab"]


@pytest.mark.parametrize("name,expr", ALL_SHAPES,
                         ids=[n for n, _ in ALL_SHAPES])
def test_logex_all_shapes(tmp_path, name, expr):
    ntabs = 1 + max("ABC".index(c) for c in expr if c in "ABC")
    (rc, _, _, files), _ = run_both(
        tmp_path, "logex", ["-T1", "-h2:120", f"{name}={expr}",
                            *ABC[:ntabs]])
    assert rc == 0 and f"{name}.ktab" in files and f"{name}.hist" in files


@pytest.mark.parametrize("argv", [
    ["-T4", "U=A|+B|+C", *ABC],
    ["-T3", "-h1:50", "I=A&.B", "D=A-B", "F=A{30-70}[3-]", *ABC],
    ["-H1:100", "H=A|+B", *ABC[:2]],
    ["-h", "V=A|.B", *ABC[:2]],
    ["bad=A&B", *ABC[:2]],
    ["unused=A|+B", *ABC],
], ids=["sum_union_T4", "three_assignments_T3", "hist_only", "h_default",
        "parse_error", "unused_table"])
def test_logex_options(tmp_path, argv):
    run_both(tmp_path, "logex", argv)


@pytest.mark.parametrize("argv", [["-h1:100", SMALL + ".ktab",
                                   SMALL2 + ".ktab"],
                                  ["-h1:60", *ABC],
                                  [SMALL, SMALLQ]],
                         ids=["two", "three", "k_mismatch"])
def test_vennex(tmp_path, argv):
    (rc, _, _, files), d = run_both(tmp_path, "vennex", argv)
    if argv[0] != "-h1:100":
        return
    # the regions against the port's in-memory evaluator on the CPU
    from fastk_tpu_torch.algebra import logex_apply

    assert rc == 0 and len(files) == 3
    tabs = [read_ktab(SMALL), read_ktab(SMALL2)]
    for fname, expr in (("SMALL_small2.hist", "A - B"),
                        ("small_SMALL2.hist", "B - A"),
                        ("SMALL_SMALL2.hist", "A &< B")):
        h = read_histogram(os.path.join(d, fname))
        (_, t, _), = logex_apply([("x", expr)], tabs, device="cpu")
        assert np.array_equal(h.counts, np.bincount(
            np.clip(t.counts.astype(int), 1, 100) - 1, minlength=100))


# --- fastmerge and fastcat --------------------------------------------------

FASTMERGE = [
    ["-ht", "-T2", "m", SMALL, SMALL2],
    ["-ht", "-T1", "m", SMALL, SMALL2],
    ["-ht", "-T4", "m", SMALL + ".ktab", SMALL2 + ".hist", SMALL_T3],
    ["-h", "m", SMALL, SMALL2],
    ["-t", "-T1", "-S1of3", "m", SMALL, SMALL2],
    ["-t", "-T1", "-S2of3", "m", SMALL, SMALL2],
    ["-t", "-T2", "-S3of3", "m", SMALL, SMALL2],
    ["-ht", "-T3", "-S2of3", "-P.", "m", SMALL, SMALL2],
    ["-th", "-#2", "m", SMALLQ, SMALLQ],
    ["-t", "m", SMALL, SMALLQ],
    ["-t", "-S3of2", "m", SMALL, SMALL2],
]


@pytest.mark.parametrize("argv", FASTMERGE, ids=[
    " ".join(os.path.basename(x) for x in a) for a in FASTMERGE])
def test_fastmerge(tmp_path, argv):
    (rc, _, _, _), d = run_both(tmp_path, "fastmerge", argv)
    # against the oracle's merge and slices of the same two tables
    if argv[-2:] == [SMALL, SMALL2] and "-t" in argv[0] and rc == 0:
        s = [a for a in argv if a.startswith("-S")]
        gold = (os.path.join(GOLDEN, "fastmerge", "slices",
                             f"slice{s[0][2]}") if s else
                os.path.join(GOLDEN, "fastmerge", "merged"))
        assert _agg(os.path.join(d, "m")) == _agg(gold)


def test_fastmerge_threads_give_the_same_table(tmp_path):
    """-T sets the output's part count, so -T1 and -T4 cut their parts
    differently: the entries and the .hist are the same."""
    outs = []
    for t in (1, 4):
        d = tmp_path / f"T{t}"
        d.mkdir()
        rc, _, _ = _run("fastk_tpu_torch", "fastmerge",
                        ["-ht", f"-T{t}", "m", SMALL, SMALL2, SMALL_T3],
                        str(d))
        assert rc == 0 and len(_tree(str(d))) == 2 + t
        with open(d / "m.hist", "rb") as f:
            outs.append((_entries(str(d / "m")), f.read()))
    (e1, h1), (e4, h4) = outs
    assert h1 == h4
    assert all(np.array_equal(a, b) for a, b in zip(e1, e4))


def _merged_slices(d):
    for n in (1, 2, 3):
        assert _run("fastk_tpu_torch", "fastmerge",
                    ["-ht", "-T1", f"-S{n}of3", f"s{n}", SMALL, SMALL2],
                    d)[0] == 0


FASTCAT = [
    ["-t", "whole", "s1", "s2", "s3"],
    ["-k", "-ht", "whole.ktab", "s1.ktab", "s2.hist", "s3"],
    ["-vh", "whole", "s1", "s3"],
    ["-t", "s1", "s1", "s2"],
    ["-kp", "pc", "pa", "pb"],
]


def _fastcat_setup(d):
    _merged_slices(d)
    _copy_set(SMALL + ".prof", d, "pa")
    _copy_set(REL + ".prof", d, "pb")


@pytest.mark.parametrize("argv", FASTCAT, ids=["t", "k_ht", "vh",
                                               "target_is_source", "kp"])
def test_fastcat(tmp_path, argv):
    (rc, _, _, files), d = run_both(tmp_path, "fastcat", argv,
                                    setup=_fastcat_setup)
    if argv[0] in ("-t", "-k") and rc == 0:
        # the splice of the slices equals the unsliced merge
        full = tmp_path / "full"
        full.mkdir()
        assert _run("fastk_tpu_torch", "fastmerge",
                    ["-ht", "-T1", "m", SMALL, SMALL2], str(full))[0] == 0
        for a, b in zip(_entries(os.path.join(d, "whole")),
                        _entries(str(full / "m"))):
            assert np.array_equal(a, b)
        assert ("s1.ktab" in files) == (argv[0] == "-k")


# --- fastcp, fastmv, fastrm: file-sets with hidden parts --------------------

def _sets_setup(d):
    os.mkdir(os.path.join(d, "src"))
    os.mkdir(os.path.join(d, "dst"))
    for ext in (".hist", ".ktab", ".prof"):
        _copy_set(SMALL + ext, os.path.join(d, "src"))
    _copy_set(SMALL2 + ".ktab", os.path.join(d, "src"))


FILESETS = [
    ("fastcp", ["src/small.ktab", "dst"]),
    ("fastcp", ["src/small", "dst"]),
    ("fastcp", ["src/small.prof", "dst/copy"]),
    ("fastcp", ["-n", "src/small.ktab", "src/small.ktab"]),
    ("fastcp", ["src/small", "dst/nodir"]),
    ("fastmv", ["src/small.prof", "dst/moved.prof"]),
    ("fastmv", ["src/small", "src/small2", "dst"]),
    ("fastmv", ["src/none", "dst"]),
    ("fastrm", ["src/small.ktab"]),
    ("fastrm", ["src/small", "src/small2.ktab"]),
    ("fastrm", ["-f", "src/none"]),
    ("fastrm", ["src/none"]),
    ("fastrm", ["src/*.ktab"]),
]


@pytest.mark.parametrize("tool,argv", FILESETS, ids=[
    f"{t} {' '.join(a)}" for t, a in FILESETS])
def test_file_sets(tmp_path, tool, argv):
    (rc, _, _, files), _ = run_both(tmp_path, tool, argv, setup=_sets_setup)
    if rc == 0:
        # every hidden part went with its stub
        stubs = [f for f in files if not os.path.basename(f).startswith(".")]
        parts = [f for f in files if os.path.basename(f).startswith(".")]
        for p in parts:
            root = os.path.basename(p)[1:].rsplit(".", 2)[0]
            assert any(os.path.basename(s).startswith(root + ".")
                       and os.path.dirname(s) == os.path.dirname(p)
                       for s in stubs), p
