"""hedit_tpu_torch: the PyTorch / CUDA port of hedit_tpu for one NVIDIA H100.

Module paths mirror ``hedit_tpu/`` so each counterpart is easy to find.  The
JAX package stays the reference; this package imports ``torch`` and never
``jax``.  Hand-written kernels: CUDA C++ for sm_90a under ``csrc/`` (flash
attention, the probes' kernels, GroupNorm+SiLU over channels-last
activations), built by ``_build.py`` at first use.  See README.md,
"PyTorch/CUDA port".
"""

__version__ = "0.1.0"
