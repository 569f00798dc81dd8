"""The port's chunk reader (io/reader.py): each chunk is read into a buffer of
its own after the carry, and cut at its last whole record, with the snap
copying only the carry. Its views and batches are held to fastk_tpu's reader byte for
byte on FASTA and FASTQ, plain, gzip'd and BGZF, at chunk sizes below one
record, of one record and the default; a parse that sleeps finds its view
unchanged; the pool hands each piece over as soon as it is parsed, in file
order, with at most workers + 1 chunks in flight."""

import gzip
import threading
import time

import numpy as np
import pytest

import fastk_tpu.io.reader as jreader
import fastk_tpu_torch.io.reader as treader

import gen_data
from test_bgzf import write_bgzf

WORKERS = 3  # parse threads: several chunks in flight


def _fasta_text(rng, n):
    genome = gen_data.make_genome(rng, 3000)
    lines = []
    for i, r in enumerate(gen_data.sample_reads(rng, genome, 4, 200,
                                                n_rate=0.3, upper_rate=0.3)):
        r = r[: int(rng.integers(20, len(r) + 1))]
        lines.append(f">read{i} len={len(r)}\n")
        for j in range(0, len(r), 61):
            lines.append(r[j: j + 61].decode() + "\n")
        if i == n:
            break
    return "".join(lines).encode()


def _fastq_text(rng, n):
    genome = gen_data.make_genome(rng, 3000)
    out = []
    for i, r in enumerate(gen_data.sample_reads(rng, genome, 4, 150,
                                                n_rate=0.3)):
        r = r[: int(rng.integers(10, len(r) + 1))]
        # '@' and '+' inside quality lines: only newlines anchor a record
        qual = bytes(rng.choice(np.frombuffer(b"@+I#5", np.uint8), len(r)))
        out.append(b"@q%d\n%s\n+\n%s\n" % (i, r, qual))
        if i == n:
            break
    return b"".join(out)


TEXT = {"fasta": lambda: _fasta_text(np.random.default_rng(5), 60),
        "fastq": lambda: _fastq_text(np.random.default_rng(6), 80)}


def _first_record(text, fmt):
    if fmt == "fasta":
        return text.index(b"\n>") + 1
    end = 0
    for _ in range(4):
        end = text.index(b"\n", end) + 1
    return end


def _write(path, text, comp):
    if comp == "gzip":
        with gzip.open(path, "wb") as g:
            g.write(text)
    elif comp == "bgzf":
        write_bgzf(path, text, block=997)
    else:
        with open(path, "wb") as f:
            f.write(text)
    return path


def _with_chunk(monkeypatch, chunk):
    """Both readers' _scan_stream_native read chunks of `chunk` bytes."""
    for mod in (treader, jreader):
        orig = mod._record_chunks
        monkeypatch.setattr(mod, "_record_chunks",
                            lambda path, fmt, _o=orig: _o(path, fmt, chunk))


def _same_as_jax(path, fmt, chunk, monkeypatch, batch_bases):
    got = [bytes(v) for v in treader._record_chunks(path, fmt, chunk)]
    want = list(jreader._record_chunks(path, fmt, chunk))
    assert got == want
    _with_chunk(monkeypatch, chunk)
    for threads in ("1", str(WORKERS)):
        monkeypatch.setenv("FASTK_TPU_INGEST_THREADS", threads)
        got = list(treader.batched_reads([path], batch_bases))
        want = list(jreader.batched_reads([path], batch_bases))
        assert len(got) == len(want)
        for (g, go), (w, wo) in zip(got, want):
            assert go == wo
            for a in ("codes", "boff", "rlen"):
                assert np.array_equal(getattr(g, a), getattr(w, a)), a
    return want


@pytest.mark.parametrize("chunk", ["below_record", "one_record", "default"])
@pytest.mark.parametrize("comp", ["plain", "gzip", "bgzf"])
@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_chunks_and_batches_match_jax(tmp_path, monkeypatch, fmt, comp,
                                      chunk):
    text = TEXT[fmt]()
    suffix = "" if comp == "plain" else ".gz"
    path = _write(str(tmp_path / f"r.{fmt}{suffix}"), text, comp)
    size = {"below_record": 23, "one_record": _first_record(text, fmt),
            "default": treader.INGEST_CHUNK}[chunk]
    want = _same_as_jax(path, fmt, size, monkeypatch, 1500)
    assert len(want) > 3


# name: (format, text, chunk bytes)
EDGES = {
    # one FASTA read of 5 kb on one line, and a FASTQ record of 3 kb: each
    # carry outgrows the buffer many times before a cut
    "fasta_carry_over_chunks": ("fasta", b">a\n" + b"acgt" * 1250 + b"\n>b\n"
                                + b"ggcc" * 30 + b"\n", 64),
    "fastq_carry_over_chunks": ("fastq", b"@a\n" + b"acgt" * 750 + b"\n+\n"
                                + b"I" * 3000 + b"\n@b\nacgtac\n+\nIIIIII\n",
                                64),
    "fasta_no_final_newline": ("fasta", b">a\nacgtacgtac\n>b\nggttaacc", 7),
    "fastq_no_final_newline": ("fastq", b"@a\nacgtacgt\n+\nIIIIIIII\n"
                               b"@b\nggtta\n+\nIIIII", 9),
    "fasta_empty": ("fasta", b"", 16),
    "fastq_empty": ("fastq", b"", 16),
}


@pytest.mark.parametrize("edge", list(EDGES))
def test_edge_inputs_match_jax(tmp_path, monkeypatch, edge):
    fmt, text, chunk = EDGES[edge]
    path = _write(str(tmp_path / f"e.{fmt}"), text, "plain")
    want = _same_as_jax(path, fmt, chunk, monkeypatch, 10_000)
    assert len(want) == (0 if not text else 1)


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_view_unchanged_while_it_is_parsed(tmp_path, monkeypatch, fmt):
    """A parse that sleeps, on every chunk of a pool of WORKERS, finds the
    bytes its view held when it was handed over: the reader writes no
    buffer again once its chunk is in flight."""
    monkeypatch.setenv("FASTK_TPU_INGEST_THREADS", str(WORKERS))
    text = TEXT[fmt]()
    path = _write(str(tmp_path / f"s.{fmt}"), text, "plain")
    rng = np.random.default_rng(11)
    delays = iter(rng.uniform(0, 0.004, 10_000))

    def parse(item):
        view, held = item
        time.sleep(next(delays))
        return bytes(view) == held, len(held)

    chunks = ((v, bytes(v)) for v in treader._record_chunks(path, fmt, 211))
    pieces = list(treader._pooled(chunks, parse))
    assert len(pieces) > 4 * (WORKERS + 2)  # many times the chunks in flight
    assert all(same for same, _n in pieces)
    assert sum(n for _s, n in pieces) == len(text)


def test_batches_say_when_more_follows(tmp_path):
    """The reader marks a batch it cut before a read that did not fit; it
    cannot tell where a batch ends with its piece."""
    text = TEXT["fasta"]()
    path = _write(str(tmp_path / "m.fasta"), text, "plain")
    batches = [b for b, _ in treader.batched_reads([path], 1500)]
    assert len(batches) > 3
    assert [b.more for b in batches] == [True] * (len(batches) - 1) + [False]
    # pieces of one read of 6 bases (7 positions) against batches of 10: the
    # second piece's read is taken whole, and ends the batch with its piece
    accum = treader._PieceAccum(10)
    piece = (np.zeros(7, np.uint8), np.array([0, 7]), np.array([6]))
    got = [list(accum.add(*piece)) for _ in range(3)]
    assert [len(g) for g in got] == [0, 1, 0]
    assert got[1][0].nreads == 2 and not got[1][0].more


def _source(n, log, before=None):
    """n chunks, each logged as ("read", i) when it is handed out; before(i)
    runs first."""
    for i in range(n):
        if before is not None:
            before(i)
        log.append(("read", i))
        yield i


def test_pool_hands_over_the_first_piece_early(monkeypatch):
    monkeypatch.setenv("FASTK_TPU_INGEST_THREADS", str(WORKERS))
    parsed = threading.Event()
    log = []

    def before(i):
        if i:  # the next read starts after the first parse ended
            assert parsed.wait(30)
            time.sleep(0.05)

    def parse(i):
        parsed.set()
        return i

    out = []
    for piece in treader._pooled(_source(3 * WORKERS, log, before), parse):
        log.append(("piece", piece))
        out.append(piece)
    assert out == list(range(3 * WORKERS))
    # the first piece comes out before the (workers + 1)-th chunk is read
    assert log.index(("piece", 0)) < log.index(("read", WORKERS))


def test_pool_keeps_file_order_and_its_bound(monkeypatch):
    """Later chunks parse faster, so pieces finish out of order; they come
    out in file order, and at most workers + 1 chunks are ever in flight
    (read and not yet handed over)."""
    monkeypatch.setenv("FASTK_TPU_INGEST_THREADS", str(WORKERS))
    n = 6 * WORKERS
    log = []
    taken = []

    def before(i):
        assert i - len(taken) + 1 <= WORKERS + 1

    def parse(i):
        time.sleep(0.002 * (n - i) * (i % 3 == 0))
        return i

    for piece in treader._pooled(_source(n, log, before), parse):
        taken.append(piece)
        assert sum(1 for e in log if e[0] == "read") - len(taken) <= WORKERS
    assert taken == list(range(n))


def test_serial_pool_yields_the_same_pieces(tmp_path, monkeypatch):
    text = TEXT["fastq"]()
    path = _write(str(tmp_path / "p.fastq"), text, "plain")
    runs = {}
    for threads in ("1", str(WORKERS)):
        monkeypatch.setenv("FASTK_TPU_INGEST_THREADS", threads)
        runs[threads] = list(treader._pooled(
            treader._record_chunks(path, "fastq", 300), bytes))
    assert runs["1"] == runs[str(WORKERS)]
    assert b"".join(runs["1"]) == text
