"""Multi-crop training batches (port of esvit_tpu/data/loader.py).

Host side: decode and RandomResizedCrop per view (PIL) on worker threads,
into view-major uint8 batches ``(2B, Sg, Sg, 3)`` / ``(L*B, Sl, Sl, 3)``,
pinned when the device is a card. Device side: the batches are uploaded
as uint8 and the photometric augmentation (data/augment_device.py) runs
there in fp32, with a ``torch.Generator`` seeded as esvit_tpu seeds its
key. The crops are esvit_tpu's byte for byte: the same sampler, the same
per-sample seeds, the same box order and the same PIL resampling.

Unlike esvit_tpu's iterator, which decodes the whole epoch ahead, the
workers run at most ``prefetch`` batches ahead of the consumer.
``synthetic_batches`` draws random crops on the device for benches and
smoke runs.
"""

from __future__ import annotations

import random
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from esvit_tpu_torch.config import CropConfig
from esvit_tpu_torch.data import augment_device
from esvit_tpu_torch.data.augment_host import crop_views_host_rrc
from esvit_tpu_torch.data.sampler import repeated_aug_indices, sharded_indices


class MultiCropIterator:
    """One epoch of multi-crop batches from a map-style dataset, augmented
    on ``device``. ``waits`` holds, per batch taken, the seconds the
    consumer waited for the workers' host batch."""

    def __init__(self, dataset, crops: CropConfig, batch_size: int, *,
                 epoch: int = 0, seed: int = 0, host_aug: bool = False,
                 out_dtype=torch.float32, num_threads: int = 4,
                 prefetch: int = 4, process_index: int = 0,
                 process_count: int = 1,
                 sampler_kind: str = "sharded", num_repeats: int = 3,
                 device: torch.device | str = "cuda"):
        if host_aug:
            raise NotImplementedError(
                "host_aug (the full-PIL DINO pipeline) is not ported yet "
                "(ROADMAP queue 1 item 6b)")
        if prefetch < 1:
            raise ValueError(f"prefetch must be at least 1, got {prefetch}")
        self.dataset = dataset
        self.crops = crops
        self.B = batch_size
        self.epoch = epoch
        self.seed = seed
        self.out_dtype = out_dtype
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            (seed << 16) + epoch)
        if sampler_kind == "sharded":
            self.indices = sharded_indices(
                len(dataset), epoch=epoch, seed=seed,
                process_index=process_index, process_count=process_count)
        elif sampler_kind == "repeated_aug":
            self.indices = repeated_aug_indices(
                len(dataset), epoch=epoch, seed=seed, num_repeats=num_repeats,
                process_index=process_index, process_count=process_count)
        elif sampler_kind == "chunk":
            raise NotImplementedError(
                "sampler_kind='chunk' needs the TSV readers, not ported yet "
                "(ROADMAP queue 1 item 6b)")
        else:
            raise ValueError(f"unknown sampler_kind {sampler_kind!r}")
        self.waits: list[float] = []

    def __len__(self):
        return len(self.indices) // self.B

    def _views(self, pos: int) -> list[np.ndarray]:
        """The views of the sample at ``pos`` in the epoch, seeded by its
        position as well as its index, so the repeats of ``repeated_aug``
        draw distinct crops (esvit_tpu's seed, stable across processes: a
        hash of ints)."""
        i = int(self.indices[pos])
        img, _ = self.dataset[i]
        if img.mode != "RGB":
            img = img.convert("RGB")
        seed = hash((self.seed, self.epoch, i, pos)) & 0x7FFFFFFF
        return crop_views_host_rrc(img, self.crops, random.Random(seed))

    def _host_batch(self, b: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Batch b's views, view-major: rows [g1 of each sample; g2 of each]
        and [local j of each sample, for j in order], as uint8 tensors,
        pinned for a card."""
        B, L = self.B, self.crops.local_crops_number
        views = [self._views(b * B + s) for s in range(B)]
        pin = self.device.type == "cuda"
        g = torch.empty((2 * B,) + views[0][0].shape, dtype=torch.uint8,
                        pin_memory=pin)
        loc = torch.empty((L * B,) + views[0][2].shape, dtype=torch.uint8,
                          pin_memory=pin)
        np.stack([v[0] for v in views] + [v[1] for v in views],
                 out=g.numpy())
        np.stack([v[2 + j] for j in range(L) for v in views], out=loc.numpy())
        return g, loc

    def host_batches(self) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """The epoch's uint8 host batches in order, made by ``num_threads``
        workers that run at most ``prefetch`` batches ahead of the
        consumer: batch b is started only once the consumer has taken
        batch b - prefetch. A worker's error is raised in its batch's
        turn."""
        nb = len(self)
        workers = max(1, min(self.num_threads, nb))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            pending = deque(pool.submit(self._host_batch, b)
                            for b in range(min(self.prefetch, nb)))
            try:
                for b in range(nb):
                    t0 = time.perf_counter()
                    out = pending.popleft().result()
                    self.waits.append(time.perf_counter() - t0)
                    if b + self.prefetch < nb:
                        pending.append(pool.submit(self._host_batch,
                                                   b + self.prefetch))
                    yield out
            finally:
                for f in pending:
                    f.cancel()

    def __iter__(self) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """Augmented (global, local) NHWC batches of ``out_dtype`` on the
        device: each host batch uploaded as uint8, then augmented there."""
        for g, loc in self.host_batches():
            g = g.to(self.device, non_blocking=True)
            loc = loc.to(self.device, non_blocking=True)
            yield augment_device.augment_multicrop(g, loc, self.generator,
                                                   self.out_dtype)


def build_train_iterator(dataset, crops: CropConfig, batch_size: int, **kw
                         ) -> MultiCropIterator:
    """One epoch's training iterator: the entry that train() and the
    learning gate take (``kw`` as MultiCropIterator's)."""
    return MultiCropIterator(dataset, crops, batch_size, **kw)


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
