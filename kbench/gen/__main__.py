"""Make a cell's inputs in a process of their own, so that the generator's
arrays never count in the measured process's peak host memory.

    python3 -m kbench.gen --cell '<json: the cell's config and traffic>'
        --seed <n> --dir <dir> [--device cuda|cpu]

Writes the inputs into <dir> and their paths, as JSON, to <dir>/inputs.json.
The cell comes whole from the caller (``kbench.run``), which has read it from
``BENCHMARK.json`` and applied any override of its sample.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from kbench import spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = json.loads(args.cell)
    cell = spec.Cell(cell["name"], cell["chips"], cell["config"],
                     cell["traffic"], [])
    inputs = spec.make_inputs(cell, args.seed, args.dir, args.device)
    with open(os.path.join(args.dir, "inputs.json"), "w") as f:
        json.dump(inputs, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
