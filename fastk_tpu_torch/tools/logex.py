"""`logex` — k-mer table algebra CLI (reference: Logex.c usage):

    logex [-T<int(4)>] [-[hH][<int(1)>:]<int(32767)>]
          <output:name=expr> ... <source_root>[.ktab] ...
"""

from __future__ import annotations

import sys

from fastk_tpu_torch.tools._cli import die

USAGE = """Usage: logex  [-T<int(4)>] [-[hH][<int(1)>:]<int(32767)>]
                <output:name=expr> ... <source_root>[.ktab] ..."""


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    nthreads = 4
    hist_range = None
    do_table = True
    pos = []
    for a in argv:
        if a.startswith("-T"):
            nthreads = int(a[2:])
        elif a.startswith("-h") or a.startswith("-H"):
            if a.startswith("-H"):
                do_table = False
            body = a[2:]
            low, high = 1, 0x7FFF
            if body:
                try:
                    if ":" in body:
                        lo, hi = body.split(":")
                        low, high = int(lo), int(hi)
                    else:
                        high = int(body)
                except ValueError:
                    die(f"logex: invalid -h syntax: {a}")
            if not (1 <= low <= high <= 0x7FFF):
                die("logex: invalid histogram range")
            hist_range = (low, high)
        elif a.startswith("-") and "=" not in a:
            die(f"logex: {a} is an illegal option\n{USAGE}")
        else:
            pos.append(a)

    assignments = [p for p in pos if "=" in p]
    sources = [p for p in pos if "=" not in p]
    if not assignments or not sources:
        die(USAGE)
    if len(sources) > 8:
        die("logex: at most 8 source tables")
    if not do_table and hist_range is None:
        hist_range = (1, 0x7FFF)

    from fastk_tpu_torch.algebra import ParseError, logex_apply_streamed
    from fastk_tpu_torch.formats.hist import write_histogram

    for s in sources:
        import os

        from fastk_tpu_torch.formats.paths import stub_path

        if not os.path.exists(stub_path(s, ".ktab")):
            die(f"logex: Cannot open {s}")

    parsed_assignments = []
    for a in assignments:
        name, expr = a.split("=", 1)
        parsed_assignments.append((name.strip(), expr))

    try:
        # every source table must appear in some expression (Logex.c main:
        # "There are tables not referred to by an expression")
        from fastk_tpu_torch.algebra import vars_referenced

        seen = 0
        for _, expr in parsed_assignments:
            seen |= vars_referenced(expr, len(sources))
        if seen != (1 << len(sources)) - 1:
            die("logex: There are tables not referred to by an expression")

        # tables stream window-by-window; outputs stream through the
        # direct writers; -T workers each own a contiguous part range
        # (the reference's thread split, Logex.c:1447-1478)
        results = logex_apply_streamed(
            parsed_assignments, sources, hist_range,
            out_nparts=max(1, nthreads), do_table=do_table,
            nthreads=max(1, nthreads))
    except ParseError as e:
        die(f"logex: Expression syntax error: {e}")
    except ValueError as e:
        die(f"logex: {e}")

    for name, hist in results:
        if hist is not None:
            write_histogram(name, hist)
    return 0


if __name__ == "__main__":
    sys.exit(main())
