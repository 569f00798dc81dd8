"""The port's ``fastk`` CLI: the in-core counting job on the card.

    python -m fastk_tpu_torch.tools.fastk [-k<int(40)>] [-t[<int(1)>]]
        [-p[:<table>[.ktab]]] [-c] [-bc<int>] [-v] [-N<path_name>]
        [-M<int(12)>] [-T<int(4)>] <source>[.fast[aq][.gz]] ...

Writes <source>.hist (or <path_name>.hist), <source>.ktab with -t and
<source>.prof with -p, each table and profile set in -T parts. With
-p:<table> only the relative profiles are written, and -t is ignored. Flags
and their parsing are the JAX package's (``fastk_tpu.tools.fastk
.parse_argv``); FASTK_TPU_BATCH_BASES caps the batch size as there. On
failure the partial file-sets are removed.

The job always runs in core: the out-of-core plan (the JAX CLI's
``_ooc_plan`` and ``_measure_dedup``), its fallback when the device runs
out of memory, and resume (-R, which stops with an error) are not ported
yet. -P is accepted and unused.
"""

from __future__ import annotations

import os
import sys

from fastk_tpu.formats.hist import write_histogram
from fastk_tpu.formats.ktab import read_ktab
from fastk_tpu.tools._cli import die, print_number, source_root
from fastk_tpu.tools.fastk import _clean_outputs, _Timer, parse_argv
from fastk_tpu_torch.pipeline.count import count_files


def _batch_bases(cfg) -> int:
    """Bases per batch: the -M memory budget at ~24 bytes a base, capped by
    FASTK_TPU_BATCH_BASES (at least 2^20) when it is set."""
    batch_bases = min(256 << 20, int(cfg["M"] * 1e9 / 24))
    env_cap = os.environ.get("FASTK_TPU_BATCH_BASES")
    if env_cap:
        batch_bases = min(batch_bases, max(1 << 20, int(env_cap)))
    return batch_bases


def main(argv=None, device="cuda") -> int:
    cfg = parse_argv(sys.argv[1:] if argv is None else argv)
    if cfg["R"]:
        die("fastk: -R is not yet ported")
    for p in cfg["inputs"]:
        if not os.path.exists(p):
            die(f"fastk: cannot open {p}")
    out_base = cfg["N"] or source_root(cfg["inputs"][0])
    timer = _Timer()

    rel = None
    if cfg["ptable"]:
        rel = read_ktab(cfg["ptable"])
        if rel.kmer != cfg["k"]:
            die(f"fastk: -p table k-mer size ({rel.kmer}) != k-mer "
                f"specified ({cfg['k']})")
        if cfg["t"] is not None:
            if cfg["v"]:
                print(f"fastk: Warning: -p:{cfg['ptable']} overides -t "
                      "option", file=sys.stderr)
            cfg["t"] = None

    try:
        out = count_files(cfg["inputs"], cfg["k"], table_min=cfg["t"],
                          profiles=cfg["p"], hc=cfg["c"], bc=cfg["bc"],
                          batch_bases=_batch_bases(cfg), relative_table=rel,
                          verbose=cfg["v"], out_base=out_base,
                          out_nparts=max(1, cfg["T"]), device=device)
        if out.nshort:
            print(f"Warning: {print_number(out.nshort)} reads are shorter "
                  f"than the k-mer size ({cfg['k']}) and contribute no "
                  "k-mers", file=sys.stderr)
        if cfg["v"]:
            print(f"  {print_number(out.nreads)} reads, "
                  f"{print_number(out.totlen)} bases", file=sys.stderr)
            timer.phase()
        # .ktab and .prof were streamed by the pipeline
        if rel is None:
            write_histogram(out_base, out.hist)
            if cfg["t"] is not None and cfg["v"]:
                print(f"  There are {print_number(out.table_entries)} "
                      f"{cfg['k']}-mers that occur {cfg['t']}-or-more "
                      "times", file=sys.stderr)
    except BaseException:
        _clean_outputs(out_base)
        raise
    if cfg["v"]:
        timer.phase()
        timer.total()
    return 0


if __name__ == "__main__":
    sys.exit(main())
