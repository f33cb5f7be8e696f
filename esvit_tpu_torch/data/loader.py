"""Synthetic multi-crop batches on the device
(port of esvit_tpu/data/loader.py ``synthetic_batches``).

The real-data feed (datasets, sampler, host and device augmentation) is
ROADMAP queue 1 item 6.
"""

from __future__ import annotations

import torch

from esvit_tpu_torch.config import CropConfig


def synthetic_batches(crops: CropConfig, batch_size: int, *, steps: int,
                      seed: int = 0, device: torch.device | str = "cuda",
                      dtype=torch.float32):
    """``steps`` random (global, local) NHWC batches drawn on ``device``
    from a generator seeded with ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    B = batch_size
    for _ in range(steps):
        g = torch.randn((2 * B, crops.global_size, crops.global_size, 3),
                        generator=gen, device=device, dtype=dtype)
        loc = torch.randn((crops.local_crops_number * B, crops.local_size,
                           crops.local_size, 3),
                          generator=gen, device=device, dtype=dtype)
        yield g, loc
