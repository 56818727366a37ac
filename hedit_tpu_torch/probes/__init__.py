"""Ports of the JAX package's kernel cost probes (``scripts/``): each module
builds its probe's inputs and chains on the card and times the port's
kernels there.  Run one with ``python -m hedit_tpu_torch.probes.<name>``."""
