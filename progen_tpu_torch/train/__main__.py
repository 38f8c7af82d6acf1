"""``python -m progen_tpu_torch.train``: see :mod:`progen_tpu_torch.train.cli`."""

import sys

from progen_tpu_torch.train.cli import main

if __name__ == "__main__":
    main(sys.argv[1:])
