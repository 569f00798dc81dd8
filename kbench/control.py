"""The control of the output check: the reference, put in the program's place,
with one guarantee broken. It counts k-mers by a 32-bit hash of the k-mer in
place of the k-mer itself (one 32-bit sort key in place of two 64-bit ones,
the step that would tempt a faster count), so k-mers whose hashes collide
are counted as one. The check has to find it not correct.

    python3 -m kbench.control --workload <cell> --seed <n> [--seed <n> ...]

Makes each seed's inputs as a run does, and prints one JSON line a seed: the
numbers compared for the reference against itself (all 0) and for the
control, each with its limit. Exits 1 when the control passes any seed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys

import torch

from kbench import spec
from kbench.reference import compare
from kbench.reference import count as ref

PRIME = 4294967291  # the largest prime below 2^32


def hash32(words) -> torch.Tensor:
    """A hash of each k-mer into [0, 2^32), over 31-bit pieces of its words
    so that no product leaves int64."""
    h = torch.zeros_like(words[0])
    for w in words:
        for piece in (w & 0x7FFFFFFF, w >> 31):
            h = (h * 1000003 + piece * 48271 + 12345) % PRIME
    return h


def _count_hashed(words):
    """count() of the reference by hash: (one k-mer a hash, the smallest;
    counts by hash; each window's hash bucket)."""
    h = hash32(words)
    perm = ref.lex_order((h,) + tuple(words))
    s_h = h[perm]
    starts = torch.zeros_like(s_h, dtype=torch.bool)
    starts[:1] = True
    starts[1:] = s_h[1:] != s_h[:-1]
    run = torch.cumsum(starts.to(torch.int64), 0) - 1
    counts = torch.bincount(run)
    inverse = torch.empty_like(run)
    inverse[perm] = run
    return tuple(w[perm][starts] for w in words), counts, inverse


def _sorted(words, counts):
    perm = ref.lex_order(words)
    return tuple(w[perm] for w in words), counts[perm]


def outputs(traffic: dict, k: int, inputs: dict, device) -> dict:
    """compare.expected's outputs, counted by hash."""
    codes, rlen = compare.load_reads(inputs[traffic["query"]], device)
    lengths = torch.clamp(rlen - k + 1, min=0)
    words = ref.canonical_words(codes, rlen, k)
    out = {}
    if "relative_table_min" in traffic:
        rcodes, rrlen = compare.load_reads(inputs["reads"], device)
        uniq, counts, _ = _count_hashed(ref.canonical_words(rcodes, rrlen, k))
        t_words, t_counts = ref.table(uniq, counts,
                                      traffic["relative_table_min"])
        out["prof"] = lengths, ref.relative_profiles(
            (hash32(t_words),), t_counts, (hash32(words),))
        return out
    uniq, counts, inverse = _count_hashed(words)
    if "hist" in traffic["outputs"]:
        out["hist"] = ref.histogram(counts)
    if "ktab" in traffic["outputs"]:
        tmin = traffic["table_min"]
        out["ktab"] = (tmin, *_sorted(*ref.table(uniq, counts, tmin)))
    if "prof" in traffic["outputs"]:
        out["prof"] = lengths, ref.own_profiles(counts, inverse)
    return out


def as_got(k: int, out: dict) -> dict:
    """Outputs in the form compare.compare reads a job's files into."""
    got = {}
    if "hist" in out:
        header, bins = out["hist"]
        got["hist"] = [(k, header, bins)]
    if "ktab" in out:
        got["ktab"] = (k, *out["ktab"])
    if "prof" in out:
        got["prof"] = (k, *out["prof"])
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    k = cell.config["k"]
    passed = 0
    for seed in args.seed:
        work = spec.workdir(args.workload + ".control")
        inputs = spec.make_inputs(cell, seed, work, args.device)
        want = compare.expected(cell.traffic, k, inputs, args.device)
        sound = compare.compare(k, want, as_got(k, want))
        got = as_got(k, outputs(cell.traffic, k, inputs, args.device))
        ctl = compare.compare(k, want, got)
        shutil.rmtree(work, ignore_errors=True)
        fails = any(v > compare.LIMITS[n] for n, v in ctl.items())
        passed += not fails
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reference": sound, "control": ctl,
                          "limits": {n: compare.LIMITS[n] for n in ctl},
                          "control_fails": fails}), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
