"""`fastmv` (reference: Fastxfer.c with -DMOVE)."""

import sys

from fastk_tpu_torch.tools.fastxfer import xfer_main


def main(argv=None):
    return xfer_main(sys.argv[1:] if argv is None else argv, move=True)


if __name__ == "__main__":
    sys.exit(main())
