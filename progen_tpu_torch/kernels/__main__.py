"""Print ptxas's resource report (registers, shared memory, spills) of the
kernels of each named source, or of every source:

    python -m progen_tpu_torch.kernels [sgu_bwd ...]
"""

import sys

from progen_tpu_torch import kernels

for name in sys.argv[1:] or kernels.SOURCES:
    print(f"== {name}")
    print(kernels.resource_report(name))
