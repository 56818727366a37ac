"""h-Edit configuration (port of ``hedit_tpu/edit/h_edit.py:HEditConfig``).

The loops of this module (explicit / implicit h-Edit-R without control,
``ef_sample``) are still to be ported; the flagship loop is in
``edit/h_edit_p2p.py``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HEditConfig:
    """What the flagship loop reads (CLI parity: ``main_p2p.py:49-70``).  The
    JAX config's other fields take one value in the flagship (cfg_src 1,
    implicit, one optimisation step, DDPM inversion); the CLI refuses others
    until the general loops are ported (ROADMAP queue 1 item 7)."""

    cfg_src_edit: float = 5.0   # \\hat{w}^orig (--cfg_src_edit)
    cfg_tar: float = 7.5        # w^edit       (--cfg_tar)
    eta: float = 1.0
