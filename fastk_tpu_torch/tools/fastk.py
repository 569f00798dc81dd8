"""The port's ``fastk`` CLI: the histogram job on the card.

    python -m fastk_tpu_torch.tools.fastk [-k<int(40)>] [-c] [-bc<int>] [-v]
        [-N<path_name>] [-M<int(12)>] <source>[.fast[aq][.gz]] ...

Writes <source>.hist (or <path_name>.hist). Flags and their parsing are the
JAX package's (``fastk_tpu.tools.fastk.parse_argv``). The table (-t), profile
(-p, -p:<table>) and resume (-R) modes, and out-of-core planning, are not
ported yet: -t, -p, -p: and -R stop with an error; -P and -T are accepted and
unused.
"""

from __future__ import annotations

import os
import sys

from fastk_tpu.formats.hist import write_histogram
from fastk_tpu.tools._cli import die, print_number, source_root
from fastk_tpu.tools.fastk import _Timer, parse_argv
from fastk_tpu_torch.pipeline.count import count_files


def main(argv=None, device="cuda") -> int:
    cfg = parse_argv(sys.argv[1:] if argv is None else argv)
    for flag, name in (("t", "-t"), ("p", "-p"), ("R", "-R")):
        if cfg[flag]:
            die(f"fastk: {name} is not yet ported")
    for p in cfg["inputs"]:
        if not os.path.exists(p):
            die(f"fastk: cannot open {p}")
    out_base = cfg["N"] or source_root(cfg["inputs"][0])
    timer = _Timer()
    # memory budget -> batch size in bases, as the JAX CLI sizes it
    batch_bases = min(256 << 20, int(cfg["M"] * 1e9 / 24))
    out = count_files(cfg["inputs"], cfg["k"], hc=cfg["c"], bc=cfg["bc"],
                      batch_bases=batch_bases, verbose=cfg["v"],
                      device=device)
    if out.nshort:
        print(f"Warning: {print_number(out.nshort)} reads are shorter "
              f"than the k-mer size ({cfg['k']}) and contribute no "
              "k-mers", file=sys.stderr)
    if cfg["v"]:
        print(f"  {print_number(out.nreads)} reads, "
              f"{print_number(out.totlen)} bases", file=sys.stderr)
        timer.phase()
    write_histogram(out_base, out.hist)
    if cfg["v"]:
        timer.total()
    return 0


if __name__ == "__main__":
    sys.exit(main())
