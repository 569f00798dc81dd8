"""The sort layouts at 2^26 records, and the hash-grouped histogram; the
port's counterpart of ``benchmarks/_r3sort.py``, ``_sortexp2.py``,
``_sortexp3.py``, ``_sortsweep.py`` and ``_hashsort.py``.

    python -m fastk_tpu_torch.probes.sorts [sweep case ...]

Every case keeps its script's name and runs on one numpy draw (seed 0; the
scripts each draw their own): w0, w1 and w2 of 32 random bits, w2_16 = w2 >>
16, u16v = w0 >> 16, and vals in [0, 32768). ``_hashsort.py``'s cases run
on the bench's batch at the same size (probes/common.py bench_batch).

How a JAX layout maps to torch ops:
- torch.sort takes one key. A JAX sort of n key operands is the port's
  sort_keys: the 32-bit words packed two to an int64 key (the sign bit
  flipped so that signed order is unsigned order), sorted least significant
  key first, each later pass stable. So a (u32, u32) sort and a fused u64
  sort are the same torch ops, and (u32, u32, u16), (u32, u32, u32),
  (u64, u16) and (u64, u32) are all two passes; the x64 scripts' fused keys
  need no x64 mode here.
- Carried values are a gather by the sort's indices.
- is_stable is torch.sort's stable=; sort_keys' first pass is unstable.
- A (B, L) row sort is the same passes along dim=-1, gathers by
  torch.gather.
- uint16 and uint32 operands are int32 and int64 (torch's unsigned dtypes
  lack most ops); the u8 key stays uint8.
- Each case returns the whole sorted output, not the scalar that the
  script fetched as its sync.

``_hashsort.py``: ``mix64`` is the script's 64-bit mix (two murmur3-style
32-bit avalanches) in int64, each product taken mod 2^32 by a mask. A key's
hash mixes (w0, w1, w2 >> 16): the last word of a k = 40 key holds 16 bits,
high-aligned, and the shift is JAX's narrow_words, so the hash is the
script's. Invalid keys hash to all-ones. ``sort_hash`` is one torch.sort of
the int64 hash plus gathers of the three words; ``sort_hash_flag`` adds the
exact collision flag (equal hashes, different words); ``hash_hist`` bins the
runs of equal hashes with the run-length kernel (K1, through start words),
reads the flag once after the histogram, and on a collision bins the exact
sort_keys order instead. ``old hist_batch`` is the port's hist_batch.

``_sortexp2.py``'s pair histogram: hist[h * 256 + l] is the product of the
one-hots of v >> 8 (128 wide) and v & 255 (256 wide) over chunks, in int8
through torch._int_mm where it accepts the shapes, else in float32 through
torch.matmul (exact while a chunk holds at most 2^24 values). Its line
``mxu hist correct:`` holds it against torch.bincount.

Cases that are one torch form on one input, so one measurement printed
under several names (the torch forms above merge the JAX layouts):
- (w0, w1, w2_16): ``_r3sort.py`` a), ``_sortexp2.py``'s 3key,
  ``_sortexp3.py``'s (u64,u16) 2key, the sweep's s32_32_16 and s64_16;
- (w0, w1): ``_r3sort.py`` c), ``_sortexp2.py``'s 2key, ``_sortexp3.py``'s
  (u64) 1key, the sweep's s64;
- (w0, w1, w2): the sweep's s3x32 and s64_32;
- (w0, w1) with w2_16 carried: ``_r3sort.py`` b), ``_sortexp3.py``'s
  (u64)+u16 val;
- w0 with w1 carried: ``_sortexp2.py``'s (u32 key)+u32 val,
  ``_sortexp3.py``'s (u32)+1 u32 val;
- w0 with w1 and w2_16 carried: ``_r3sort.py`` e), ``_sortexp3.py``'s
  (u32)+2 vals;
- w0 alone: ``_sortexp2.py``'s (u32) 1key, the sweep's s32;
- w2_16 alone: ``_r3sort.py`` d), ``_sortexp2.py``'s (u16) 1key;
- (w0, w1, w2_16) in 64 rows: ``_sortexp2.py``'s and ``_sortexp3.py``'s
  row sorts at 64, the sweep's s64_16_b64; in 256 rows: the two scripts'
  row sorts at 256.

Times: min of 5 runs (``_r3sort.py``, ``_hashsort.py``) and median of 3
(the others, without ``_sortsweep.py``'s 52 ms fetch subtraction), each after
a warm-up; see probes/common.py. As in ``_sortsweep.py``, a sweep case that
raises prints a FAILED line. After the timings main() holds the row sorts,
the stable sorts and the hash grouping against sort_keys (layout_mismatches)
and prints any that differ. The module's command exits 1 on a failed case, a
pair histogram unlike torch.bincount or a layout unlike sort_keys. Runs on
the card and raises without one; ``main(device="cpu")`` runs the same code
on the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from fastk_tpu_torch.device import resolve_device
from fastk_tpu_torch.ops.count import (
    _SIGN,
    _packed_keys,
    _unpacked_words,
    fold_invalid,
    hist_batch,
    is_invalid_key,
    run_starts,
    sort_keys,
)
from fastk_tpu_torch.ops.histker import pack_valid_starts, run_hist, start_words
from fastk_tpu_torch.ops.kmers import canonical_kmers
from fastk_tpu_torch.ops.pack import unpack_words
from fastk_tpu_torch.probes.common import (
    K,
    Sorted,
    bench_batch,
    bincount_by_sort,
    bincount_rows,
    card_name,
    folded_keys,
    median,
    run_ms,
    to_device,
)

SORT_SIZE = 1 << 26
SWEEP = {  # _sortsweep.py's argv name -> its line; {n}: size, {c}: columns
    "s3x32": "sort (u32,u32,u32) 64M",
    "s32_32_16": "sort (u32,u32,u16) 64M",
    "s64_16": "sort (u64,u16) 64M",
    "s64_32": "sort (u64,u32) 64M",
    "s64": "sort (u64) 64M",
    "s32": "sort (u32) 64M",
    "s16": "sort (u16) 64M flat",
    "s16_b64": "sort (u16) 64M batched 64x{c}",
    "s16_b256": "sort (u16) 64M batched 256x{c}",
    "s16_b1024": "sort (u16) 64M batched 1024x{c}",
    "s3x32_b64": "sort (u32,u32,u32) batched 64x1M",
    "s64_16_b64": "sort (u64,u16) batched 64x1M",
    "hist_flat": "hist 32k: flat sort+searchsorted",
    "hist_b256": "hist 32k: batched 256 rows sort+ss",
}
# per script: (label width, statistic, runs, warm-ups)
TIMING = {"_r3sort.py": (30, min, 5, 1), "_sortexp2.py": (44, median, 3, 1),
          "_sortexp3.py": (44, median, 3, 1),
          "_sortsweep.py": (46, median, 3, 1),
          "_hashsort.py": (40, min, 5, 2)}
M32 = 0xFFFFFFFF
_ALL_ONES = (1 << 63) - 1  # an all-ones hash, its sign bit flipped


def sort_inputs(size: int) -> dict:
    rng = np.random.default_rng(0)
    w0, w1, w2 = (rng.integers(0, 1 << 32, size, dtype=np.int64)
                  for _ in range(3))
    vals = rng.integers(0, 32768, size, dtype=np.int64)
    return dict(w0=w0, w1=w1, w2=w2, w2_16=w2 >> 16, u16v=w0 >> 16,
                vals=vals)


def keyed(words, values=()) -> Sorted:
    """The port's sort_keys: `words` most significant first."""
    s_words, s_values = sort_keys(tuple(words), tuple(values))
    return Sorted(s_words, s_values)


def stable_sort(key, values=()) -> Sorted:
    s, perm = torch.sort(key, stable=True)
    return Sorted((s,), tuple(v[perm] for v in values), stable=True)


def _row_words(keys, nwords: int):
    words = _unpacked_words(keys, nwords)
    R, L = keys[0].shape
    row = torch.arange(R, device=keys[0].device).repeat_interleave(L)
    return (row,) + tuple(w.reshape(-1) for w in words)


def sort_rows(words, rows: int) -> Sorted:
    """sort_keys' passes along each of `rows` rows (dim=-1)."""
    keys = _packed_keys(tuple(w.view(rows, -1) for w in words))
    s, perm = torch.sort(keys[-1], dim=-1)
    s_keys = [s]
    for key in reversed(keys[:-1]):
        s, p2 = torch.sort(torch.gather(key, -1, perm), dim=-1, stable=True)
        perm = torch.gather(perm, -1, p2)
        s_keys = [s] + [torch.gather(k, -1, p2) for k in s_keys]
    n = len(words)
    return Sorted(tuple(s_keys), words=lambda k: _row_words(k, n))


def mxu_hist(v, chunk: int = 1 << 19) -> torch.Tensor:
    """The 32768-bin histogram of v (values in [0, 32768)) as one-hot
    products, `chunk` values a product: int32 [32768]."""
    chunk = min(chunk, v.numel())
    if chunk > 1 << 24:
        raise ValueError("a float32 count is exact only to 2^24")
    dev = v.device
    span_hi = torch.arange(128, dtype=v.dtype, device=dev)
    span_lo = torch.arange(256, dtype=v.dtype, device=dev)
    int8 = chunk % 8 == 0  # torch._int_mm's shapes: (>16, 8k) @ (8k, 8n)
    acc = torch.zeros(128, 256, dtype=torch.int32, device=dev)
    for cv in v.view(-1, chunk):
        oh_hi = span_hi[:, None] == (cv >> 8)[None, :]  # (128, chunk)
        oh_lo = span_lo[:, None] == (cv & 255)[None, :]  # (256, chunk)
        if int8:  # mat2 column-major: see mm_layout_ms
            acc += torch._int_mm(oh_hi.to(torch.int8),
                                 oh_lo.to(torch.int8).t())
        else:
            acc += (oh_hi.to(torch.float32) @ oh_lo.to(torch.float32).t()
                    ).to(torch.int32)
    return acc.reshape(-1)


def mm_layout_ms(v, dev) -> tuple:
    """ms of one chunk's int8 product (a chunk of 2^19 values, or v whole)
    with its right operand row-major and column-major: why mxu_hist passes
    it column-major. The median of 5 after a warm-up."""
    cv = v[: 1 << 19]
    a = (torch.arange(128, dtype=v.dtype, device=dev)[:, None]
         == (cv >> 8)[None, :]).to(torch.int8)
    col = (torch.arange(256, dtype=v.dtype, device=dev)[:, None]
           == (cv & 255)[None, :]).to(torch.int8).t()
    row = col.contiguous()
    return tuple(median(run_ms(lambda b=b: torch._int_mm(a, b), dev, 5))
                 for b in (row, col))


def _avalanche(a):
    a = a ^ (a >> 16)
    a = (a * 0x7FEB352D) & M32
    a = a ^ (a >> 15)
    a = (a * 0x846CA68B) & M32
    return a ^ (a >> 16)


def mix64(w0, w1, w2):
    """``_hashsort.py``'s mix64 of three 32-bit values held in int64: two
    32-bit halves. An int64 product of two values below 2^32 wraps mod
    2^64, so its low 32 bits, kept by the mask, are the uint32 product.

    Its front end is linear in the top bit: (w + 2^31) * c = w * c + 2^31
    mod 2^32 for an odd c, so keys that differ only in bit 31 of both w0
    and w1 get equal halves, and collide (the bench's batch has such pairs;
    hash_hist then falls back to sort_keys)."""
    a = (w0 * 0x85EBCA6B ^ w1 * 0xC2B2AE35 ^ w2 * 0x27D4EB2F) & M32
    b = (w0 * 0x165667B1 ^ w1 * 0x9E3779B9 ^ w2 * 0x5851F42D) & M32
    return _avalanche(a), _avalanche(b)


def key_hash(f) -> torch.Tensor:
    """int64 sort key of each folded k = 40 key's hash: the halves packed
    and sign-flipped; all-ones for an invalid key."""
    h0, h1 = mix64(f[0], f[1], f[2] >> 16)
    hk = ((h0 << 32) | h1) ^ _SIGN
    return torch.where(is_invalid_key(f), _ALL_ONES, hk)


def _unfuse(keys):
    k = keys[0] ^ _SIGN
    return ((k >> 32) & M32, k & M32)


def sort_hash(f) -> Sorted:
    """The folded key words grouped by their hash: one int64 sort, three
    gathers."""
    s_hk, perm = torch.sort(key_hash(f))
    return Sorted((s_hk,), tuple(w[perm] for w in f), words=_unfuse)


def _hash_runs(s: Sorted):
    """(hash equal to the record before's, and also words unequal: a
    collision), each bool [n - 1]."""
    s_hk = s.keys[0]
    eq = s_hk[1:] == s_hk[:-1]
    ne = s.values[0][1:] != s.values[0][:-1]
    for w in s.values[1:]:
        ne |= w[1:] != w[:-1]
    return eq, eq & ne


def sort_hash_flag(f):
    """sort_hash and the collision flag: (the last hash's high half,
    flag)."""
    s = sort_hash(f)
    _, coll = _hash_runs(s)
    return _unfuse(s.keys)[0][-1], coll.any()


def hash_hist(pd, excd, total: int, size: int) -> dict:
    """The histogram job grouped by hash: dict(hist int64 [32768], nvalid
    int, coll — the collision flag, ncoll — the records whose hash equals
    the one before's while their words differ; tensors). Waits for ninv
    (valid_end), as the port's hist_batch does, and for the flag after the
    histogram."""
    codes = unpack_words(pd, excd, total)
    words, invalid = canonical_kmers(codes, K, size)
    ninv = invalid.sum()
    f = fold_invalid(words, invalid)
    del words, invalid
    s = sort_hash(f)
    eq, colliding = _hash_runs(s)
    coll = colliding.any()
    starts = torch.ones(size, dtype=torch.bool, device=pd.device)
    starts[1:] = ~eq
    valid_end = size - int(ninv)
    hist, _ = run_hist(pack_valid_starts(starts, valid_end), valid_end)
    if bool(coll):
        hist, _ = run_hist(start_words(sort_keys(f)[0], valid_end), valid_end)
    return dict(hist=hist, nvalid=valid_end, coll=coll,
                ncoll=colliding.sum())


def _sections(dev, size: int, sweep=tuple(SWEEP)) -> list:
    """[(script, label, fn, layout)]: layout is (word columns, rows) of a
    key sort whose words sort_keys must match, ("hash", folded words) for
    a hash grouping, None otherwise."""
    x = {k: torch.from_numpy(v).to(dev) for k, v in sort_inputs(size).items()}
    w0, w1, w2, w2_16 = x["w0"], x["w1"], x["w2"], x["w2_16"]
    u16v, vals = x["u16v"], x["vals"]
    n23 = min(size, 1 << 23)
    out = []

    def add(script, label, fn, layout=None):
        out.append((script, label, fn, layout))

    def lay(words, values=(), rows=None):
        if rows:
            return (lambda: sort_rows(words, rows)), (words, rows)
        return (lambda: keyed(words, values)), None  # sort_keys itself

    s = "_r3sort.py"
    for label, words, values in [
            ("a) 3-key (u32,u32,u16)", (w0, w1, w2_16), ()),
            ("b) 2-key (u32,u32) + u16 value", (w0, w1), (w2_16,)),
            ("c) 2-key (u32,u32)", (w0, w1), ()),
            ("d) 1-key u16", (w2_16,), ()),
            ("e) 1-key u32 + u32,u16 values", (w0,), (w1, w2_16)),
            ("f) 1-key u16 at 2^23", (w2_16[:n23],), ())]:
        add(s, label, *lay(words, values))

    s = "_sortexp2.py"
    add(s, "null (sync latency)", lambda: w0[:8].sum())
    for label, words, values in [
            ("sort (u32,u32,u16) 3key", (w0, w1, w2_16), ()),
            ("sort (u32,u32) 2key", (w0, w1), ()),
            ("sort (u32) 1key", (w0,), ()),
            ("sort (u16) 1key", (w2_16,), ()),
            ("sort (u32 key)+u32 val", (w0,), (w1,))]:
        add(s, label, *lay(words, values))
    for B in (4, 16, 64, 256):
        add(s, f"row sort ({B}, {size // B}) 3key",
            *lay((w0, w1, w2_16), rows=B))
    add(s, "bincount_by_sort 32769", lambda: bincount_by_sort(vals, 32769))
    add(s, "mxu pair-hist 32768 (chunk 512K)", lambda: mxu_hist(vals))
    add(s, "mxu pair-hist 32768 (chunk 64K)", lambda: mxu_hist(vals, 1 << 16))

    s = "_sortexp3.py"
    sv = torch.sort(vals).values
    add(s, "null (sync latency)", lambda: w0[:8].sum())
    for label, words, values in [
            ("sort (u64) 1key [fuse incl]", (w0, w1), ()),
            ("sort (u64,u16) 2key", (w0, w1, w2_16), ()),
            ("sort (u64)+u16 val", (w0, w1), (w2_16,)),
            ("sort (u64,u64) 2key", (w0, w1, w1, w0), ()),
            ("sort (u32)+1 u32 val", (w0,), (w1,)),
            ("sort (u32)+2 vals", (w0,), (w1, w2_16))]:
        add(s, label, *lay(words, values))
    add(s, "sort stable (u32)+2 vals",
        lambda: stable_sort(w0, (w1, w2_16)), ((w0,), None))
    u8 = (w0 & 255).to(torch.uint8)
    add(s, "sort stable (u8)+3 vals",
        lambda: stable_sort(u8, (w0, w1, w2_16)), ((w0 & 255,), None))
    for B in (64, 256, 1024):
        add(s, f"row sort ({B},{size // B}) (u64,u16) 2key",
            *lay((w0, w1, w2_16), rows=B))
    add(s, "u16 1key sort alone", *lay((vals,)))
    add(s, "searchsorted 32770 edges in 64M", lambda: torch.searchsorted(
        sv, torch.arange(32770, dtype=sv.dtype, device=dev)))

    s = "_sortsweep.py"
    h16 = u16v & 0x7FFF
    sweep_cases = {
        "s3x32": lay((w0, w1, w2)),
        "s32_32_16": lay((w0, w1, w2_16)),
        "s64_16": lay((w0, w1, w2_16)),
        "s64_32": lay((w0, w1, w2)),
        "s64": lay((w0, w1)),
        "s32": lay((w0,)),
        "s16": lay((u16v,)),
        "s16_b64": lay((u16v,), rows=64),
        "s16_b256": lay((u16v,), rows=256),
        "s16_b1024": lay((u16v,), rows=1024),
        "s3x32_b64": lay((w0, w1, w2), rows=64),
        "s64_16_b64": lay((w0, w1, w2_16), rows=64),
        "hist_flat": (lambda: bincount_by_sort(h16, 32768), None),
        "hist_b256": (lambda: bincount_rows(h16, 256, 32768), None),
    }
    for c in sweep:
        if c not in SWEEP:
            raise ValueError(f"unknown sweep case {c!r}")
        rows = int(c.split("_b")[1]) if "_b" in c else 1
        add(s, SWEEP[c].format(c=size // rows), *sweep_cases[c])

    s = "_hashsort.py"
    pw, exc, total = bench_batch(size)
    pd, excd = to_device(pw, dev), to_device(exc, dev)
    f, _ = folded_keys(pd, excd, total, size)
    add(s, "a) 3-key sort (current)", *lay(f))
    add(s, "c) hash 2-key sort + 3 values", lambda: sort_hash(f), ("hash", f))
    add(s, "b) hash sort + collision flag", lambda: sort_hash_flag(f))
    add(s, "d) old hist_batch end-to-end",
        lambda: hist_batch(unpack_words(pd, excd, total), K, size))
    add(s, "e) hash hist end-to-end",
        lambda: hash_hist(pd, excd, total, size))
    return out


def cases(dev, size: int) -> list:
    """[("script: label", fn)] of every case; fn() returns its output."""
    return [(f"{s}: {label}", fn) for s, label, fn, _ in _sections(dev, size)]


def layout_mismatches(sections) -> list:
    """The cases of `sections` (from _sections) whose sorted words differ
    from sort_keys' on the same words (the row sorts, the row index leading,
    and the two stable sorts), or, for a hash layout, whose records are not
    sort_keys' or whose runs of equal hashes are not sort_keys' runs while
    no collision is flagged (or are, while one is). The other key sorts are
    sort_keys itself and are not compared with it."""
    bad = []
    for s, label, fn, layout in sections:
        if layout is None:
            continue
        got = fn()
        if layout[0] == "hash":
            # the same records, grouped as sort_keys groups them unless a
            # collision (a hash run of two keys) is flagged
            ref = sort_keys(layout[1])[0]
            eq, colliding = _hash_runs(got)
            exact = int((~eq).sum()) == int(run_starts(ref).sum()) - 1
            ok = (all(map(torch.equal, sort_keys(got.values)[0], ref))
                  and exact != bool(colliding.any()))
        else:
            words, rows = layout
            if rows:
                n = words[0].numel()
                words = (torch.arange(rows, device=words[0].device)
                         .repeat_interleave(n // rows),) + tuple(words)
            ref = sort_keys(tuple(words))[0]
            ok = all(torch.equal(a.to(b.dtype), b) for a, b in zip(
                got.word_tensors(), ref))
        if not ok:
            bad.append(f"{s}: {label}")
    return bad


def main(device="cuda", size=SORT_SIZE, sweep=tuple(SWEEP)) -> dict:
    """Print every line; returns dict(times={"script: label": ms},
    failed=[sweep lines that raised], mxu_correct=bool,
    mismatches=layout_mismatches of the same cases)."""
    dev = resolve_device(device)
    name = card_name(dev)
    times, failed, mxu_correct = {}, [], None
    sections = _sections(dev, size, sweep)
    print(f"n = {size} platform: {dev.type}   [{name}]", flush=True)
    for s, label, fn, _ in sections:
        width, stat, reps, warmup = TIMING[s]
        if s == "_hashsort.py" and label.startswith("d)"):
            old = fn()
            new = next(g for t, lb, g, _ in sections
                       if t == s and lb.startswith("e)"))()
            if not torch.equal(old["hist"], new["hist"]):
                raise AssertionError("hash_hist differs from hist_batch")
            print(f"hash collisions on the bench batch: {int(new['ncoll'])}"
                  f" (flag {bool(new['coll'])}; on a collision hash_hist "
                  f"bins sort_keys' order)   [{name}]", flush=True)
        try:
            ms = stat(run_ms(fn, dev, reps, warmup))
        except Exception as e:  # noqa: BLE001 -- _sortsweep.py's FAILED line
            if s != "_sortsweep.py":
                raise
            failed.append(label)
            print(f"{label:{width}s} FAILED: {type(e).__name__}: "
                  f"{str(e)[:120]}   [{name}]", flush=True)
            continue
        times[f"{s}: {label}"] = ms
        print(f"{label:{width}s} {ms:9.3f} ms   [{name}]", flush=True)
        if s == "_sortexp2.py" and label.endswith("(chunk 64K)"):
            vals = torch.from_numpy(sort_inputs(size)["vals"]).to(dev)
            mxu_correct = torch.equal(
                mxu_hist(vals).to(torch.int64),
                torch.bincount(vals, minlength=32768))
            print(f"mxu hist correct: {mxu_correct}   [{name}]", flush=True)
            row, col = mm_layout_ms(vals, dev)
            print(f"mxu chunk product int8 (right operand row-major "
                  f"{row:.3f} ms, column-major {col:.3f} ms)   [{name}]",
                  flush=True)
    mismatches = layout_mismatches(sections)
    if mismatches:
        print(f"layouts unlike sort_keys': {mismatches}   [{name}]",
              flush=True)
    return dict(times=times, failed=failed, mxu_correct=mxu_correct,
                mismatches=mismatches)


if __name__ == "__main__":
    res = main(sweep=tuple(sys.argv[1:]) or tuple(SWEEP))
    sys.exit(1 if res["failed"] or not res["mxu_correct"]
             or res["mismatches"] else 0)
