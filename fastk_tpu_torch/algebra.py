"""K-mer table algebra: the expression language of the reference's Logex
(reference: Logex.c:36-557 parser, 608-750 evaluator), evaluated vectorized
over the merged k-mer universe of the argument tables instead of a scalar
stream merge.

Grammar (precedence low to high):  or := minus ('|' MOD minus)*
  minus := xor ('-' xor)*          xor := and ('^' and)*
  and := filter ('&' MOD filter)*  filter := atom ( '[' ranges ']' | '{' ranges '}' )*
  atom := '#' atom | '(' or ')' | letter
MOD is one of + - < > * . (sum, left-minus-right floored at 0, min, max,
average-floor, left-else-right); a missing modulator means "count 1" and is
only legal under a '#' or when a count/GC filter absorbs the result.

Count 0 == absent, throughout. GC% of a k-mer is (100 * #gc) // k.

The port's copy of ``fastk_tpu/algebra.py``. Only ``merge_universe`` and
``logex_apply`` differ: they take the device of the union (default
``"cuda"``), which from ``ops.tables.DEVICE_MIN_ROWS`` rows on runs as torch
ops there. The streamed evaluator and the CLIs built on it stay on the host
and never import torch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fastk_tpu_torch.formats.hist import Histogram
from fastk_tpu_torch.formats.ktab import KmerTable, unpack_codes

MODS = "+-<>*."


class ParseError(ValueError):
    def __init__(self, msg: str, pos: int):
        super().__init__(f"{msg} (at column {pos})")
        self.pos = pos


@dataclass
class Node:
    op: str  # 'arg' | 'or' | 'and' | 'xor' | 'minus' | 'num' | 'cnt' | 'gc'
    mode: Optional[str] = None
    lft: Optional["Node"] = None
    rgt: Optional["Node"] = None
    var: int = -1
    ranges: Optional[List[Tuple[int, int]]] = None


class _Parser:
    def __init__(self, s: str, ntabs: int):
        self.s = s
        self.i = 0
        self.ntabs = ntabs
        self.vars_seen = 0
        self.no_mode_at: Optional[int] = None

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1

    def peek(self) -> str:
        self._ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def parse(self) -> Node:
        v = self.or_()
        if self.peek() != "":
            raise ParseError("Extra characters at end of expression", self.i)
        if self.no_mode_at is not None:
            raise ParseError("& or | operator has no mode and result counts"
                             " are used", self.no_mode_at)
        return v

    def or_(self) -> Node:
        v = self.minus()
        while self.peek() == "|":
            self.i += 1
            m = self._mode()
            v = Node("or", m, v, self.minus())
        return v

    def minus(self) -> Node:
        v = self.xor()
        while self.peek() == "-":
            self.i += 1
            v = Node("minus", None, v, self.xor())
        return v

    def xor(self) -> Node:
        v = self.and_()
        while self.peek() == "^":
            self.i += 1
            v = Node("xor", None, v, self.and_())
        return v

    def and_(self) -> Node:
        v = self.filter()
        while self.peek() == "&":
            self.i += 1
            m = self._mode()
            v = Node("and", m, v, self.filter())
        return v

    def _mode(self) -> Optional[str]:
        c = self.s[self.i] if self.i < len(self.s) else ""
        if c in MODS:
            self.i += 1
            return c
        if c == "(" or c == "#" or c.isalpha() or c.isspace() or c == "":
            if self.no_mode_at is None:
                self.no_mode_at = self.i
            return None
        raise ParseError("Invalid modulator", self.i)

    def filter(self) -> Node:
        saved = self.no_mode_at
        self.no_mode_at = None
        v = self.atom()
        had_inner = self.no_mode_at
        self.no_mode_at = saved
        got_filter = False
        while self.peek() in ("[", "{"):
            close = "]" if self.peek() == "[" else "}"
            self.i += 1
            rngs = self._ranges(close)
            v = Node("cnt" if close == "]" else "gc", None, v, ranges=rngs)
            got_filter = True
        if had_inner is not None and not got_filter:
            # a count/GC filter "absorbs" modeless subexpressions
            # (reference: Logex.c:356-358); otherwise the flag propagates
            if self.no_mode_at is None:
                self.no_mode_at = had_inner
        return v

    def _ranges(self, close: str) -> List[Tuple[int, int]]:
        rngs = []
        while True:
            self._ws()
            lo = hi = None
            if self.i < len(self.s) and self.s[self.i].isdigit():
                lo = self._number()
            self._ws()
            if self.i < len(self.s) and self.s[self.i] == "-":
                self.i += 1
                self._ws()
                if self.i < len(self.s) and self.s[self.i].isdigit():
                    hi = self._number()
                else:
                    hi = 0x7FFF
                if lo is None:
                    lo = 1
            else:
                if lo is None:
                    raise ParseError("Invalid range", self.i)
                hi = lo
            rngs.append((lo, hi))
            self._ws()
            if self.i < len(self.s) and self.s[self.i] == ",":
                self.i += 1
                continue
            if self.i < len(self.s) and self.s[self.i] == close:
                self.i += 1
                break
            raise ParseError("Invalid range syntax", self.i)
        # normalize: sort and merge overlaps (reference: Logex.c:336-349)
        rngs.sort()
        merged = [list(rngs[0])]
        for lo, hi in rngs[1:]:
            if lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return [tuple(r) for r in merged]

    def _number(self) -> int:
        j = self.i
        while j < len(self.s) and self.s[j].isdigit():
            j += 1
        n = int(self.s[self.i: j])
        self.i = j
        return n

    def atom(self) -> Node:
        c = self.peek()
        if c == "#":
            self.i += 1
            sub = self.atom()
            self.no_mode_at = None  # '#' discards counts, excusing modeless ops
            return Node("num", None, sub)
        if c == "(":
            self.i += 1
            v = self.or_()
            if self.peek() != ")":
                raise ParseError("Unbalanced parentheses", self.i)
            self.i += 1
            return v
        if c.isalpha():
            var = ord(c.lower()) - ord("a")
            if var >= self.ntabs:
                raise ParseError(
                    f"Variable '{c}' out of range for {self.ntabs} tables", self.i)
            self.i += 1
            self.vars_seen |= 1 << var
            return Node("arg", var=var)
        raise ParseError("Expected an argument or (", self.i)


def parse_expression(s: str, ntabs: int) -> Node:
    return _Parser(s, ntabs).parse()


def vars_referenced(s: str, ntabs: int) -> int:
    """Bitmask of table variables an expression references (for the
    every-argument-must-be-used check, Logex.c main)."""
    p = _Parser(s, ntabs)
    p.parse()
    return p.vars_seen


def _modulate(x: np.ndarray, y: np.ndarray, mode: Optional[str]) -> np.ndarray:
    if mode == "*":
        return (x + y) >> 1
    if mode == "+":
        return x + y
    if mode == "-":
        return np.maximum(x - y, 0)
    if mode == "<":
        return np.minimum(x, y)
    if mode == ">":
        return np.maximum(x, y)
    if mode == ".":
        return np.where(x == 0, y, x)
    return np.ones_like(x)  # modeless


def evaluate(node: Node, counts: Sequence[np.ndarray], gc: np.ndarray) -> np.ndarray:
    """Evaluate to an int64 count vector over the universe; 0 == rejected."""
    if node.op == "arg":
        return counts[node.var]
    if node.op == "num":
        return (evaluate(node.lft, counts, gc) > 0).astype(np.int64)
    if node.op == "cnt":
        x = evaluate(node.lft, counts, gc)
        ok = np.zeros(x.shape, bool)
        for lo, hi in node.ranges:
            ok |= (x >= lo) & (x <= hi)
        return np.where(ok, x, 0)
    if node.op == "gc":
        x = evaluate(node.lft, counts, gc)
        ok = np.zeros(x.shape, bool)
        for lo, hi in node.ranges:
            ok |= (gc >= lo) & (gc <= hi)
        return np.where(ok, x, 0)
    x = evaluate(node.lft, counts, gc)
    y = evaluate(node.rgt, counts, gc)
    if node.op == "or":
        return np.where(x == 0, y, np.where(y == 0, x, _modulate(x, y, node.mode)))
    if node.op == "and":
        return np.where((x == 0) | (y == 0), 0, _modulate(x, y, node.mode))
    if node.op == "xor":
        return np.where(x == 0, y, np.where(y == 0, x, 0))
    if node.op == "minus":
        return np.where(y == 0, x, 0)
    raise ValueError(node.op)


def merge_universe(tables: Sequence[KmerTable], device="cuda"):
    """Union of the tables' k-mers (sorted packed rows) + aligned count
    vectors per table (0 where absent).

    The union itself runs on `device` for large inputs (ops.tables
    .merge_counted — the counting pipeline's merge machinery); per-table
    alignment is one vectorized searchsorted each."""
    from fastk_tpu_torch.ops.kmers import packed_to_words, words_to_packed
    from fastk_tpu_torch.ops.tables import merge_counted

    kmer = tables[0].kmer
    kb = tables[0].packed.shape[1]
    uwords, _ = merge_counted(
        [packed_to_words(t.packed, kmer) for t in tables],
        [np.ones(len(t), np.int64) for t in tables], device=device)
    universe = words_to_packed(uwords, kmer)
    uview = universe.view(f"S{kb}").ravel()
    cvecs = []
    for t in tables:
        pos = np.searchsorted(uview, t.packed.view(f"S{kb}").ravel())
        c = np.zeros(len(universe), np.int64)
        c[pos] = t.counts
        cvecs.append(c)
    return universe, cvecs


def gc_percent(packed: np.ndarray, kmer: int) -> np.ndarray:
    """(100 * #gc) // k per k-mer (reference: gc_setup/gcontent
    Logex.c:927-963 computes 100*count summed then /kmer)."""
    codes = unpack_codes(packed, kmer)
    ngc = ((codes == 1) | (codes == 2)).sum(axis=1).astype(np.int64)
    return (100 * ngc) // kmer


def histogram_of(counts: np.ndarray, kmer: int, low: int, high: int) -> Histogram:
    """Boundary-accumulating histogram of accepted counts (reference:
    Logex.c:1143-1165)."""
    c = counts[counts > 0]
    bins = np.bincount(np.clip(c, low, high) - low, minlength=high - low + 1
                       ).astype(np.int64)
    ilow = int(c[c <= low].sum())
    ihigh = int(c[c >= high].sum())
    return Histogram(kmer, low, high, bins, ilow, ihigh)


def logex_apply(
    assignments: Sequence[Tuple[str, str]],
    tables: Sequence[KmerTable],
    hist_range: Optional[Tuple[int, int]] = None,
    device="cuda",
):
    """Apply `name=expr` assignments to the tables, their union merged on
    `device` (merge_universe).

    Returns a list of (name, KmerTable, Histogram|None); table counts clip
    at 32767 (reference: Logex.c:1143-1144)."""
    ntabs = len(tables)
    kmer = tables[0].kmer
    for t in tables[1:]:
        if t.kmer != kmer:
            raise ValueError("tables have different k-mer sizes")
    parsed = [(name, parse_expression(expr, ntabs)) for name, expr in assignments]

    universe, cvecs = merge_universe(tables, device)
    need_gc = any(_has_gc(n) for _, n in parsed)
    gc = gc_percent(universe, kmer) if need_gc else np.zeros(len(universe), np.int64)

    out = []
    for name, node in parsed:
        c = evaluate(node, cvecs, gc)
        acc = c > 0
        table = KmerTable(kmer, 1, universe[acc],
                          np.minimum(c[acc], 32767).astype(np.uint16))
        h = None
        if hist_range is not None:
            h = histogram_of(c, kmer, hist_range[0], hist_range[1])
        out.append((name, table, h))
    return out


def _has_gc(n: Node) -> bool:
    if n is None:
        return False
    return n.op == "gc" or _has_gc(n.lft) or _has_gc(n.rgt)


HIST_HIGH_BINS = 32768  # fk_merge_windows' clipped-count histogram size

# RPN opcodes of the native per-key evaluator (fk_logex_windows); the
# role of the reference's compiled truth table + eval_expression
# (Logex.c:608-750), as a stack program evaluated per union key in C.
_LXO = {"arg": 0, "num": 1, "cnt": 2, "gc": 3,
        "or": 4, "and": 5, "xor": 6, "minus": 7}
_LX_MODE = {None: 0, "+": 1, "-": 2, "<": 3, ">": 4, "*": 5, ".": 6}


def compile_program(node: Node) -> Optional[np.ndarray]:
    """Flatten a parsed expression to the int32 RPN program
    fk_logex_windows evaluates per union key; None if the tree exceeds
    the engine's 64-slot stack (not reachable from the 8-table CLI)."""
    prog: List[int] = []
    depth = 0
    max_depth = 0

    def emit(n: Node) -> None:
        nonlocal depth, max_depth
        if n.op == "arg":
            prog.extend((_LXO["arg"], n.var))
            depth += 1
            max_depth = max(max_depth, depth)
            return
        if n.op == "num":
            emit(n.lft)
            prog.append(_LXO["num"])
            return
        if n.op in ("cnt", "gc"):
            emit(n.lft)
            prog.extend((_LXO[n.op], len(n.ranges)))
            for lo, hi in n.ranges:
                prog.extend((lo, hi))
            return
        emit(n.lft)
        emit(n.rgt)
        prog.append(_LXO[n.op])
        if n.op in ("or", "and"):
            prog.append(_LX_MODE[n.mode])
        depth -= 1

    emit(node)
    if max_depth > 64:
        return None
    return np.array(prog, dtype=np.int32)


def _strip_gc(n: Optional[Node]) -> Optional[Node]:
    """Copy of the tree with GC filters replaced by their operand — for
    presence analysis, where a GC filter may pass any key."""
    if n is None:
        return None
    if n.op == "gc":
        return _strip_gc(n.lft)
    return Node(n.op, n.mode, _strip_gc(n.lft), _strip_gc(n.rgt), n.var,
                n.ranges)


def _solo_emits(node: Node, var: int, ntabs: int) -> bool:
    """True iff the expression can yield a nonzero count for a key present
    ONLY in table `var` — proven exhaustively by evaluating over ALL 2^15
    possible counts at once (GC filters treated as passing). Keys failing
    this for every assignment are skipped inside the native merge loop
    without evaluation (fk_logex_windows' solo_ok)."""
    c = np.arange(1, 32768, dtype=np.int64)
    counts = [c if i == var else np.zeros(len(c), np.int64)
              for i in range(ntabs)]
    gc = np.zeros(len(c), np.int64)
    return bool((evaluate(_strip_gc(node), counts, gc) > 0).any())


def solo_ok_mask(parsed_nodes: Sequence[Node], ntabs: int) -> int:
    """Bit i set iff ANY assignment can emit a key present only in
    table i."""
    mask = 0
    for i in range(ntabs):
        if any(_solo_emits(n, i, ntabs) for n in parsed_nodes):
            mask |= 1 << i
    return mask


def _sum_union_vars(node: Node):
    """The set of argument variables when `node` is a pure '|+' tree over
    distinct variables (the fastmerge-equivalent expression), else None."""
    if node.op == "arg":
        return {node.var}
    if node.op == "or" and node.mode == "+":
        l = _sum_union_vars(node.lft)
        r = _sum_union_vars(node.rgt)
        if l is not None and r is not None and not (l & r):
            return l | r
    return None


def logex_apply_streamed(
    assignments: Sequence[Tuple[str, str]],
    source_paths: Sequence[str],
    hist_range: Optional[Tuple[int, int]] = None,
    out_nparts: int = 4,
    do_table: bool = True,
    window: Optional[int] = None,
    nthreads: int = 1,
):
    """logex_apply over STREAMED tables: sources advance through bounded
    keyspace windows (formats.twindow) and each assignment's output table
    streams through its own KtabWriter — expression evaluation is windowed
    exactly like the reference's per-bucket streaming evaluation
    (Logex.c:1403-1478), so tables larger than RAM evaluate in O(window).

    Returns a list of (name, Histogram|None); tables land on disk.
    """
    from fastk_tpu_torch import native
    from fastk_tpu_torch.formats.ktab import KmerStream, KtabWriter
    from fastk_tpu_torch.formats.twindow import (
        DEFAULT_WINDOW, stream_window_ranges, stream_windows, window_union)

    streams = [KmerStream(p) for p in source_paths]
    ntabs = len(streams)
    kmer = streams[0].kmer
    kb = streams[0].kbyte
    for s in streams[1:]:
        if s.kmer != kmer:
            raise ValueError("tables have different k-mer sizes")
    parsed = [(name, parse_expression(expr, ntabs))
              for name, expr in assignments]
    need_gc = any(_has_gc(n) for _, n in parsed)

    writers = {}
    if do_table:
        # reference Logex output layout, known up front (so parts stream
        # out single-pass, no RAM spool): ibyte = the pivot (largest)
        # input's (Logex.c:1427 IB_OUT = S[pivot]->ibyte), part cuts at
        # pivot quantiles snapped to prefix boundaries (Logex.c:1447-1478),
        # the same cuts for every assignment
        from fastk_tpu_torch.formats.ktab import KtabDirectWriter
        from fastk_tpu_torch.formats.twindow import key_at

        pivot = max(streams, key=lambda s: s.nels)
        ib_out = pivot.ibyte
        cut_keys = []
        for t in range(1, out_nparts):
            p = pivot.nels * t // out_nparts
            if p >= pivot.nels:
                cut_keys.append(b"\xff" * kb)
            else:
                key = bytearray(key_at(pivot, p).ljust(kb, b"\x00"))
                key[ib_out:] = b"\x00" * (kb - ib_out)
                cut_keys.append(bytes(key))
        for name, _ in parsed:
            writers[name] = KtabDirectWriter(name, kmer, 1, ib_out,
                                             cut_keys)
    hacc = None
    if hist_range is not None:
        low, high = hist_range
        hacc = {name: [np.zeros(high - low + 1, np.int64), 0, 0]
                for name, _ in parsed}

    use_native = (native.load() is not None and len(streams) <= 64
                  and kb <= 62)

    # sum-union fast path: `X = A |+ B |+ ...` over ALL tables is exactly
    # the fastmerge job, whose fused native window engine (part memmaps ->
    # writer rows with clipped sums + the stub's prefix histogram in one
    # pass, fk_merge_windows) is the fastest path through this machinery —
    # the reference's Logex runs the same stream merge its Fastmerge does
    # for this expression shape (Logex.c:972-1215 vs Fastmerge.c:168-450)
    if (use_native and do_table and hist_range is None
            and len(parsed) == 1 and nthreads <= 1
            and _sum_union_vars(parsed[0][1]) == set(range(ntabs))):
        name = parsed[0][0]
        w = writers[name]
        if w.ibyte <= 2:
            w.skip_prefix = True
        h2 = np.zeros(1 << 16, np.int64)
        chist = np.zeros(HIST_HIGH_BINS, np.int64)
        ok2 = False
        try:
            for ranges in stream_window_ranges(
                    streams, window or DEFAULT_WINDOW):
                rec = native.merge_windows(streams, ranges, kb, h2, chist)
                assert rec is not None
                w.add_records(rec)
            if w.skip_prefix:
                w.set_pindex(h2 if w.ibyte == 2
                             else h2.reshape(256, 256).sum(axis=1))
            w.close()
            ok2 = True
        finally:
            if not ok2:
                try:
                    w.abort()
                except Exception:
                    pass
        return [(name, None)]

    # general fused path: EVERY expression shape (intersections,
    # differences, xor, modulators, count/GC filters, '#', multiple
    # assignments, -h histograms) compiles to an RPN program evaluated
    # per union key inside the native cursor merge (fk_logex_windows) —
    # one pass from part memmaps to writer rows, no numpy materialization.
    # With nthreads > 1 the OUTPUT PART ranges split across worker
    # threads (the reference's Logex thread split, Logex.c:1447-1478):
    # each worker walks its contiguous keyspace range with its own
    # cursors and writes its own part files (ctypes releases the GIL, so
    # the C merges run truly parallel); the stub assembles from the
    # summed per-thread prefix histograms.
    # The windowed-numpy evaluate below remains as the no-native fallback.
    progs = ([compile_program(n) for _, n in parsed] if use_native else [])
    if use_native and len(parsed) <= 16 and all(
            p is not None for p in progs):
        from fastk_tpu_torch.formats.ktab import KtabDirectWriter, part_path
        from fastk_tpu_torch.formats.twindow import key_at

        nasg = len(parsed)
        solo_ok = solo_ok_mask([n for _, n in parsed], ntabs)
        span = (high - low + 1) if hist_range is not None else 1
        T = max(1, int(nthreads))
        if do_table:
            T = min(T, out_nparts)
        if do_table:
            starts = [r * out_nparts // T for r in range(T + 1)]
            key_ranges = [
                (cut_keys[starts[r] - 1] if starts[r] > 0 else None,
                 cut_keys[starts[r + 1] - 1] if starts[r + 1] < out_nparts
                 else None) for r in range(T)]
        else:
            # histogram-only: split at pivot quantile keys
            pivot = max(streams, key=lambda s: s.nels)
            if pivot.nels == 0:
                T = 1
            qs = [key_at(pivot, pivot.nels * r // T).ljust(kb, b"\x00")
                  for r in range(1, T)]
            key_ranges = [(qs[r - 1] if r > 0 else None,
                           qs[r] if r < T - 1 else None) for r in range(T)]

        def _work(r):
            lo_key, hi_key = key_ranges[r]
            strs = ([KmerStream(p) for p in source_paths] if T > 1
                    else streams)
            h2_r = np.zeros((nasg, 1 << 16), np.int64) if do_table else None
            hbins_r = (np.zeros((nasg, span), np.int64)
                       if hist_range is not None else None)
            hsum_r = (np.zeros((nasg, 2), np.int64)
                      if hist_range is not None else None)
            ws = {}
            ok_r = False
            try:
                if do_table:
                    local = cut_keys[starts[r]: starts[r + 1] - 1]
                    for name, _ in parsed:
                        w = KtabDirectWriter(name, kmer, 1, ib_out, local,
                                             part_base=starts[r],
                                             write_stub=False)
                        if ib_out <= 2:
                            w.skip_prefix = True
                        ws[name] = w
                for ranges in stream_window_ranges(
                        strs, window or DEFAULT_WINDOW, lo_key, hi_key):
                    recs = native.logex_windows(
                        strs, ranges, kb, kmer, progs, need_gc, solo_ok,
                        do_table, h2_r, hist_range, hbins_r, hsum_r)
                    assert recs is not None  # limits checked above
                    if do_table:
                        for (name, _), rec in zip(parsed, recs):
                            ws[name].add_records(rec)
                for w in ws.values():
                    w.close()
                ok_r = True
            finally:
                if not ok_r:
                    for w in ws.values():
                        try:
                            w.abort()
                        except Exception:
                            pass
            return ws, h2_r, hbins_r, hsum_r

        ok2 = False
        try:
            if T == 1:
                results = [_work(0)]
            else:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(T) as pool:
                    results = list(pool.map(_work, range(T)))
            if do_table:
                for a, (name, _) in enumerate(parsed):
                    pind = np.zeros(1 << (8 * ib_out), np.int64)
                    for ws, h2_r, _hb, _hs in results:
                        w = ws[name]
                        if w.skip_prefix:
                            pind += (h2_r[a] if ib_out == 2 else
                                     h2_r[a].reshape(256, 256).sum(axis=1))
                        else:
                            pind += w._pindex
                    from fastk_tpu_torch.formats.ktab import write_direct_stub

                    write_direct_stub(name, kmer, out_nparts, 1, ib_out,
                                      pind)
            ok2 = True
        finally:
            if not ok2 and do_table:
                # remove any part files the finished workers left behind
                for name, _ in parsed:
                    for p in range(out_nparts):
                        try:
                            os.unlink(part_path(name, ".ktab", p + 1))
                        except OSError:
                            pass
        out = []
        for a, (name, _) in enumerate(parsed):
            h = None
            if hist_range is not None:
                hbins_t = sum(res[2][a] for res in results)
                hsum_t = sum(res[3][a] for res in results)
                h = Histogram(kmer, low, high, np.asarray(hbins_t),
                              int(hsum_t[0]), int(hsum_t[1]))
            out.append((name, h))
        return out

    def _windows():
        """Yield (universe (U, kb) uint8, per-source int64-safe count
        vectors) per aligned window: the native cursor union reads part
        memmaps directly (no full-key materialization per stream); the
        fallback materializes windows and merges with searchsorted."""
        if use_native:
            for ranges in stream_window_ranges(
                    streams, window or DEFAULT_WINDOW):
                res = native.union_cvecs(streams, ranges, kb)
                assert res is not None  # load() checked above
                uni, cv = res
                # int32: modulators sum counts (up to ns * 32767), which
                # overflows the uint16 the kernel emits
                yield uni, [v.astype(np.int32) for v in cv]
        else:
            for chunk in stream_windows(streams, window or DEFAULT_WINDOW):
                yield window_union(chunk, kb)

    ok = False
    closed = set()
    try:
        for universe, cvecs in _windows():
            if len(universe) == 0:
                continue
            gc = (gc_percent(universe, kmer) if need_gc
                  else np.zeros(len(universe), np.int64))
            for name, node in parsed:
                c = evaluate(node, cvecs, gc)
                acc = c > 0
                if do_table:
                    if acc.all():  # common (e.g. unions): skip compaction
                        writers[name].add(
                            universe,
                            np.minimum(c, 32767).astype(np.uint16))
                    else:
                        writers[name].add(
                            universe[acc],
                            np.minimum(c[acc], 32767).astype(np.uint16))
                if hacc is not None:
                    cp = c[acc]
                    a = hacc[name]
                    a[0] += np.bincount(np.clip(cp, low, high) - low,
                                        minlength=high - low + 1)
                    a[1] += int(cp[cp <= low].sum())
                    a[2] += int(cp[cp >= high].sum())
        for name, w in writers.items():
            w.close()
            closed.add(name)
        ok = True
    finally:
        if not ok:
            # a failure mid-stream (disk full, bad expression at runtime)
            # must not leave open handles or partial .ktab file-sets —
            # but writers that finished close() are complete outputs;
            # aborting them would unlink their parts under a live stub
            for name, w in writers.items():
                if name in closed:
                    continue
                try:
                    w.abort()
                except Exception:
                    pass
    out = []
    for name, _ in parsed:
        h = None
        if hacc is not None:
            bins, ilow, ihigh = hacc[name]
            h = Histogram(kmer, low, high, bins, ilow, ihigh)
        out.append((name, h))
    return out
