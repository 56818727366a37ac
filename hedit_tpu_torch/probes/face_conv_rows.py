"""The face DDPM's forward at 1-10 rows under cuDNN's heuristics alone.

    python -m hedit_tpu_torch.probes.face_conv_rows

Times one forward of the CelebA-HQ DDPM (256x256, float32, seeded weights)
at 1, 2, 3, 4, 5 and 10 rows, three calls each (the first picks the
algorithms), with cuDNN's TF32 off and then on, and prints each call's
host-clock ms and the peak memory.  The process never turns cuDNN's search
on: PyTorch's cuDNN algorithm cache would serve a searched shape to the
heuristics mode too, so a search earlier in the process hides their pick.
This is why ``invert_sde`` runs 1 row a call by default.
"""

from __future__ import annotations

import sys
import time

import torch

from hedit_tpu_torch.pipelines.face import create_face_pipeline
from hedit_tpu_torch.probes.timing import require_cuda

ROWS = (1, 2, 3, 4, 5, 10)


def main() -> int:
    require_cuda("probes.face_conv_rows")
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = create_face_pipeline(num_inference_steps=100, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(max(ROWS), 256, 256, 3, generator=g, device="cuda")
    t = pipe.schedule.timesteps[:max(ROWS)].cuda()
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        for b in ROWS:
            ms = []
            with torch.no_grad():
                for _ in range(3):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    pipe.unet(x[:b], t[:b])
                    torch.cuda.synchronize()
                    ms.append(round((time.perf_counter() - t0) * 1e3, 1))
            print(f"heuristics tf32={tf32} rows {b}: ms {ms} peak GiB "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
