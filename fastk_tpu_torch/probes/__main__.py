"""python -m fastk_tpu_torch.probes: every probe on the card; exits 1 if any
probe failed."""

import sys

from fastk_tpu_torch.probes import main

if __name__ == "__main__":
    sys.exit(0 if all(ok for _, ok, _ in main()) else 1)
