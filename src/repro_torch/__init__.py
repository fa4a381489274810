"""repro_torch: the PyTorch + CUDA port of the zero-copy SpTRSV stack.

Mirrors the reference package's layout (``sparse``, ``core``, ``kernels``,
``api``, ``krylov``). It imports torch, numpy and scipy, never jax and
nothing of the reference package. Entry points run on the CUDA device
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
