"""progen-tpu on PyTorch and CUDA: the port of ``progen_tpu`` to an NVIDIA H100.

The JAX package ``progen_tpu`` stays the reference; this package runs the
same model with PyTorch, and its TPU kernels are written again by hand for
Hopper in CUDA C++ (``kernels/csrc``).  Nothing here imports JAX or the JAX
package.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on a CPU tensor every kernel wrapper takes its plain
PyTorch version.
"""

__version__ = "0.1.0"

from progen_tpu_torch.models.progen import ProGen, ProGenConfig

__all__ = ["ProGen", "ProGenConfig", "__version__"]
