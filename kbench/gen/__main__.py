"""Make a cell's inputs in a process of their own, so that the generator's
arrays never count in the measured process's peak host memory.

    python3 -m kbench.gen --workload <cell> --seed <n> --dir <dir>
        [--device cuda|cpu] [--sample '<json of sample keys to override>']

Writes the inputs into <dir> and their paths, as JSON, to <dir>/inputs.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from kbench import spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sample", default="{}")
    args = ap.parse_args(argv)
    cell = spec.load(args.workload, json.loads(args.sample))
    inputs = spec.make_inputs(cell, args.seed, args.dir, args.device)
    with open(os.path.join(args.dir, "inputs.json"), "w") as f:
        json.dump(inputs, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
