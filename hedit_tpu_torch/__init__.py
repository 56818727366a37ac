"""hedit_tpu_torch: the PyTorch / CUDA port of hedit_tpu for one NVIDIA H100.

Module paths mirror ``hedit_tpu/`` so each counterpart is easy to find.  The
JAX package stays the reference; this package imports ``torch`` and never
``jax``.  Hand-written kernels: ``csrc/flash_attention.cu`` (CUDA C++, built
by ``_build.py`` at first use) and the GroupNorm+SiLU kernel in
``ops/groupnorm.py`` (Triton).  See README.md, "PyTorch/CUDA port".
"""

__version__ = "0.1.0"
