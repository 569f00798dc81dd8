"""The port's copies of the JAX package's host modules against the originals,
exactly: the readers on every input format, the .hist/.ktab/.prof writers
on the oracle goldens, and the native codecs (built from the port's own
fastk_native.c into fastk_tpu_torch/_build/)."""

import gzip
import os

import numpy as np
import pytest

import fastk_tpu.formats.hist as jhist
import fastk_tpu.formats.ktab as jktab
import fastk_tpu.formats.prof as jprof
import fastk_tpu.io.reader as jreader
import fastk_tpu.native as jnative
import fastk_tpu_torch.formats.hist as thist
import fastk_tpu_torch.formats.ktab as tktab
import fastk_tpu_torch.formats.prof as tprof
import fastk_tpu_torch.io.reader as treader
import fastk_tpu_torch.native as tnative

import gen_data
from test_inputs import _write_bam, _write_dazz, _write_sam

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden")
INPUTS = os.path.join(GOLDEN, "inputs")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """{format: path}: the golden FASTA and FASTQ, gzip'd copies, and SAM,
    gzip'd SAM, BAM and a Dazzler DB of seeded shotgun reads."""
    d = tmp_path_factory.mktemp("formats")
    rng = np.random.default_rng(21)
    genome = gen_data.make_genome(rng, 5000)
    reads = [r.upper() for r in gen_data.sample_reads(rng, genome, 6, 250)]
    out = {"fasta": os.path.join(INPUTS, "small.fasta"),
           "fastq": os.path.join(INPUTS, "smallq.fastq")}
    for fmt, src in (("fasta.gz", out["fasta"]), ("fastq.gz", out["fastq"])):
        out[fmt] = str(d / f"in.{fmt}")
        with open(src, "rb") as f, gzip.open(out[fmt], "wb") as g:
            g.write(f.read())
    out["sam"] = str(d / "in.sam")
    _write_sam(out["sam"], reads)
    out["sam.gz"] = str(d / "in2.sam.gz")
    with open(out["sam"], "rb") as f, gzip.open(out["sam.gz"], "wb") as g:
        g.write(f.read())
    out["bam"] = str(d / "in.bam")
    _write_bam(out["bam"], reads)
    dz = d / "dazz"
    dz.mkdir()
    out["db"] = _write_dazz(str(dz), [r.lower() for r in reads])
    return out


FORMATS = ["fasta", "fastq", "fasta.gz", "fastq.gz", "sam", "sam.gz", "bam",
           "db"]


@pytest.mark.parametrize("batch_bases", [1 << 20, 3000])
@pytest.mark.parametrize("fmt", FORMATS)
def test_batched_reads_match_jax(inputs, fmt, batch_bases):
    for hc, bc in ((False, 0), (True, 3)):
        got = list(treader.batched_reads([inputs[fmt]], batch_bases, hc=hc,
                                         bc=bc))
        want = list(jreader.batched_reads([inputs[fmt]], batch_bases,
                                          hc=hc, bc=bc))
        assert len(got) == len(want) > 0
        assert batch_bases > 3000 or len(got) > 1 or fmt == "db"
        for (g, go), (w, wo) in zip(got, want):
            assert type(g).__module__ == "fastk_tpu_torch.io.reader"
            assert go == wo
            for a in ("codes", "boff", "rlen"):
                assert np.array_equal(getattr(g, a), getattr(w, a)), a


@pytest.mark.parametrize("fmt", FORMATS)
def test_iter_reads_match_jax(inputs, fmt):
    assert list(treader.iter_reads(inputs[fmt])) == list(
        jreader.iter_reads(inputs[fmt]))


# (golden dir, stem) of every golden file-set
GOLDENS = [("tiny_k12_t1", "tiny"), ("tiny_k12_t2", "tiny"),
           ("small_k40", "small"), ("small_k40_t3", "small"),
           ("small_k40_c", "small"), ("smallq_k32", "smallq"),
           ("small2_k40", "small2")]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("golden,stem", GOLDENS)
def test_writers_rewrite_goldens_as_jax(tmp_path, golden, stem):
    base = os.path.join(GOLDEN, golden, stem)
    files = os.listdir(os.path.join(GOLDEN, golden))
    for name in ("port", "jax"):
        os.mkdir(tmp_path / name)
    if stem + ".hist" in files:
        h = thist.read_histogram(base)
        assert h == thist.read_histogram(base)
        jh = jhist.read_histogram(base)
        assert np.array_equal(h.counts, jh.counts)
        thist.write_histogram(str(tmp_path / "port" / stem), h)
        jhist.write_histogram(str(tmp_path / "jax" / stem), jh)
        assert _bytes(tmp_path / "port" / f"{stem}.hist") == _bytes(
            base + ".hist")
    if stem + ".ktab" in files:
        t, jt = tktab.read_ktab(base), jktab.read_ktab(base)
        assert np.array_equal(t.packed, jt.packed)
        assert np.array_equal(t.counts, jt.counts)
        nparts = tktab._read_stub(base)[1]
        tktab.write_ktab(str(tmp_path / "port" / stem), t, nparts=nparts)
        jktab.write_ktab(str(tmp_path / "jax" / stem), jt, nparts=nparts)
        # the streamed writer too, in several blocks
        with tktab.KtabWriter(str(tmp_path / "port" / "w"), t.kmer,
                              t.minval, nparts=3) as w:
            for lo in range(0, len(t), 700):
                w.add(t.packed[lo: lo + 700], t.counts[lo: lo + 700])
        with jktab.KtabWriter(str(tmp_path / "jax" / "w"), jt.kmer,
                              jt.minval, nparts=3) as w:
            for lo in range(0, len(jt), 700):
                w.add(jt.packed[lo: lo + 700], jt.counts[lo: lo + 700])
    if stem + ".prof" in files:
        ref = jprof.read_profiles(base)
        assert all(np.array_equal(a, b) for a, b in
                   zip(tprof.read_profiles(base), ref))
        cnts = np.concatenate(ref).astype(np.uint16)
        plen = np.array([len(p) for p in ref], np.int64)
        boff = np.concatenate([[0], np.cumsum(plen)[:-1]]).astype(np.int64)
        kmer = tprof.ProfileIndex(base).kmer
        assert kmer == jprof.ProfileIndex(base).kmer
        for mod, name in ((tprof, "port"), (jprof, "jax")):
            blob, ends = mod.encode_profiles_bulk(cnts, boff, plen)
            with mod.ProfWriter(str(tmp_path / name / stem), kmer, len(ref),
                                nparts=2) as w:
                w.add_block(blob, ends)
    port, jax_ = (os.listdir(tmp_path / n) for n in ("port", "jax"))
    assert sorted(port) == sorted(jax_) and port
    for n in port:
        assert _bytes(tmp_path / "port" / n) == _bytes(tmp_path / "jax" / n), n


def test_native_library_is_the_ports_own():
    lib = tnative.load()
    assert lib is not None
    build = os.path.join(REPO, "fastk_tpu_torch", "_build")
    assert os.path.realpath(lib._name) == os.path.realpath(
        os.path.join(build, "fastk_native.so"))
    assert os.path.realpath(tnative._SRC) == os.path.realpath(os.path.join(
        REPO, "fastk_tpu_torch", "native", "fastk_native.c"))
    assert _bytes(tnative._SRC) == _bytes(jnative._SRC)
    assert jnative.load() is not None and lib is not jnative.load()


def _codes(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, n).astype(np.uint8)
    c[rng.random(n) < 0.03] = 4
    c[-1] = 4
    return c


@pytest.mark.parametrize("n", [16, 1000, 65_536, 100_000])
def test_native_pack2_matches_jax(n):
    codes = _codes(n + (-n) % 16, n)
    got = tnative.pack2(codes, ecap=len(codes))
    want = jnative.pack2(codes, ecap=len(codes))
    assert got is not None and got[2] == want[2] > 0
    ne = got[2]
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1][:ne], want[1][:ne])


def _profiles(seed):
    rng = np.random.default_rng(seed)
    plen = rng.integers(-3, 400, 300).astype(np.int64)
    plen[::17] = 0
    cnts = rng.integers(1, 40, int(np.maximum(plen, 0).sum()) + 10)
    cnts[rng.random(len(cnts)) < 0.02] = 32767
    cnts = np.repeat(cnts, rng.integers(1, 4, len(cnts)))[: len(cnts)]
    boff = np.concatenate([[0], np.cumsum(np.maximum(plen, 0))[:-1]])
    return cnts.astype(np.uint16), boff.astype(np.int64), plen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_prof_encode_bulk_matches_jax(seed, monkeypatch):
    cnts, boff, plen = _profiles(seed)
    got = tnative.prof_encode_bulk(cnts, boff, plen)
    want = jnative.prof_encode_bulk(cnts, boff, plen)
    assert got is not None
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    # the port's numpy fallback writes the same bytes
    monkeypatch.setattr(tnative, "prof_encode_bulk", lambda *a: None)
    blob, ends = tprof.encode_profiles_bulk(cnts, boff, plen)
    assert np.array_equal(blob, want[0]) and np.array_equal(ends, want[1])


@pytest.mark.parametrize("kb", [3, 10, 16])
def test_native_writer_add_matches_jax(kb):
    rng = np.random.default_rng(kb)
    packed = rng.integers(0, 256, (5000, kb), dtype=np.uint8)
    counts = rng.integers(1, 1 << 15, 5000).astype(np.uint16)
    h2t = np.zeros(1 << 16, np.int64)
    h2j = np.zeros(1 << 16, np.int64)
    got = tnative.writer_add(packed, counts, h2t)
    want = jnative.writer_add(packed, counts, h2j)
    assert got is not None
    assert np.array_equal(got, want) and np.array_equal(h2t, h2j)
    assert h2t.sum() == 5000


# --- the copies of this slice: twindow, onecode, algebra and the tools ------

import io as _io
import re
import time

import fastk_tpu.formats.onecode as jone
import fastk_tpu.formats.twindow as jtw
import fastk_tpu_torch.formats.onecode as tone
import fastk_tpu_torch.formats.twindow as ttw

# modules copied whole, their imports (lazy ones too) pointed at the port
WHOLE_COPIES = ["formats/twindow.py", "formats/onecode.py", "formats/hist.py",
                "formats/ktab.py", "formats/prof.py", "formats/paths.py",
                "tools/_cli.py", "_version.py"] + [
    f"tools/{t}.py" for t in ("logex", "vennex", "histex", "tabex", "profex",
                              "haplex", "homex", "symmex", "fastrm",
                              "fastxfer", "fastcp", "fastmv", "fastcat")]


@pytest.mark.parametrize("rel", WHOLE_COPIES)
def test_whole_copy_differs_only_in_its_imports(rel):
    with open(os.path.join(REPO, "fastk_tpu", rel)) as f:
        want = f.read()
    want = re.sub(r"\bfastk_tpu\.", "fastk_tpu_torch.", want)
    want = want.replace("from fastk_tpu import", "from fastk_tpu_torch import")
    with open(os.path.join(REPO, "fastk_tpu_torch", rel)) as f:
        assert f.read() == want


KTABS = [os.path.join(GOLDEN, "small_k40", "small"),
         os.path.join(GOLDEN, "small2_k40", "small2"),
         os.path.join(GOLDEN, "small_k40_t3", "small")]


@pytest.mark.parametrize("window,bounds", [(500, (None, None)),
                                          (1 << 20, (None, None)),
                                          (333, (7000, 30000))])
@pytest.mark.parametrize("use_native", [True, False])
def test_twindow_matches_jax(monkeypatch, window, bounds, use_native):
    if not use_native:
        monkeypatch.setattr(tnative, "load", lambda: None)
        monkeypatch.setattr(jnative, "load", lambda: None)
    ts = [tktab.KmerStream(p) for p in KTABS]
    js = [jktab.KmerStream(p) for p in KTABS]
    kb = ts[0].kbyte
    lo_key, hi_key = (None if b is None else ttw.key_at(ts[0], b)
                      for b in bounds)
    if bounds[0] is not None:
        assert lo_key == jtw.key_at(js[0], bounds[0])
    got = list(ttw.stream_windows(ts, window, lo_key, hi_key))
    want = list(jtw.stream_windows(js, window, lo_key, hi_key))
    assert len(got) == len(want) > (1 if window < 1000 else 0)
    for g, w in zip(got, want):
        for (gp, gc), (wp, wc) in zip(g, w):
            assert np.array_equal(gp, wp) and np.array_equal(gc, wc)
        gu, gv = ttw.window_union(g, kb)
        wu, wv = jtw.window_union(w, kb)
        assert np.array_equal(gu, wu)
        assert all(np.array_equal(a, b) for a, b in zip(gv, wv))
        gs = ttw.window_sum(g, kb)
        ws = jtw.window_sum(w, kb)
        assert np.array_equal(gs[0], ws[0]) and np.array_equal(gs[1], ws[1])


@pytest.mark.parametrize("binary", [True, False])
def test_onecode_writers_match_jax(monkeypatch, binary):
    monkeypatch.setattr(time, "strftime", lambda *a: "2026-01-01_00:00:00")
    base = os.path.join(GOLDEN, "small_k40", "small")
    tiny = os.path.join(GOLDEN, "tiny_k12_t1", "tiny")
    outs = {}
    for name, one, hist, ktab, prof in (
            ("port", tone, thist, tktab, tprof),
            ("jax", jone, jhist, jktab, jprof)):
        h = hist.read_histogram(base)
        pi = prof.ProfileIndex(base)
        res = []
        for write in (
                lambda out: one.write_khist(h.counts[:40], "small.hist", 1,
                                            40, "histex -1", out, binary),
                lambda out: one.write_kmr(ktab.KmerStream(tiny), 2,
                                          "tabex -1", out, binary),
                lambda out: one.write_prf(
                    (pi.fetch(p) for p in range(pi.nreads)), "profex -1",
                    out, binary)):
            out = _io.BytesIO() if binary else _io.StringIO()
            write(out)
            res.append(out.getvalue())
        outs[name] = res
    assert outs["port"] == outs["jax"]
    assert all(len(x) > 20 for x in outs["port"])
