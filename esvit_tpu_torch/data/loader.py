"""Multi-crop training batches (port of esvit_tpu/data/loader.py).

Host side, on worker threads: decode and RandomResizedCrop per view into
view-major batches ``(2B, Sg, Sg, 3)`` / ``(L*B, Sl, Sl, 3)``, pinned when
the device is a card. Three ways to fill them, chosen per sample:

- **native** (``native_decode``; on by default when the dataset hands out
  encoded bytes and the native library builds): the boxes are drawn in
  Python from the JPEG's header, then one ``multicrop_batch`` call per
  batch decodes each JPEG once and writes every view straight into the
  batch buffer, outside the GIL (native/, csrc/datapath.cpp). Where the
  library was built without libjpeg (no headers on the machine), PIL
  decodes and the library crops (``crop_batch``).
- **PIL**: the image from ``dataset[i]``, each view a PIL bicubic resize
  of its box: a sample that is not a JPEG, a dataset without
  ``raw_bytes``, or ``native_decode=False``. A JPEG whose native decode
  fails after its boxes were drawn takes this path with the same boxes.
- **host_aug**: the full-PIL DINO pipeline (augment_host.py
  ``DataAugmentationDINO``), float32 views, uploaded as they are.

``native_images`` / ``pil_images`` count the samples of the batches taken
so far by the native path and by PIL (host_aug included).

Device side (unless ``host_aug``): the uint8 batches are uploaded and the
photometric augmentation (data/augment_device.py) runs there in fp32,
with a ``torch.Generator`` seeded as esvit_tpu seeds its key. The crops
are esvit_tpu's: the same sampler, the same per-sample seeds, the same
box order; the PIL path's views are the same bytes, the native path's
are esvit_tpu.native's (within 1 LSB of PIL's resample).

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

from esvit_tpu_torch import native
from esvit_tpu_torch.config import CropConfig
from esvit_tpu_torch.data import augment_device
from esvit_tpu_torch.data.augment_host import (DataAugmentationDINO,
                                               crop_views,
                                               crop_views_host_rrc,
                                               sample_multicrop_boxes)
from esvit_tpu_torch.data.sampler import (chunk_aware_indices,
                                          repeated_aug_indices,
                                          sharded_indices)


class MultiCropIterator:
    """One epoch of multi-crop batches from a map-style dataset, augmented
    on ``device`` (or on the host, ``host_aug``). ``waits`` holds, per
    batch taken, the seconds the consumer waited for the workers' host
    batch.

    sampler_kind: 'sharded', 'repeated_aug' (``num_repeats``) or 'chunk'
    (over ``dataset.chunk_sizes``, the TSV shards). native_decode: None
    (on when the dataset has ``raw_bytes`` and the library builds), True
    (the library's build error is raised) or False. native_scaled: let
    libjpeg decode at 1/2, 1/4 or 1/8 size where every crop still
    downscales by 2x or more (esvit_tpu's default)."""

    def __init__(self, dataset, crops: CropConfig, batch_size: int, *,
                 epoch: int = 0, seed: int = 0, host_aug: bool = False,
                 out_dtype=torch.float32, num_threads: int = 4,
                 prefetch: int = 4, process_index: int = 0,
                 process_count: int = 1,
                 sampler_kind: str = "sharded", num_repeats: int = 3,
                 native_decode: bool | None = None,
                 native_scaled: bool = True,
                 device: torch.device | str = "cuda"):
        if prefetch < 1:
            raise ValueError(f"prefetch must be at least 1, got {prefetch}")
        if host_aug and native_decode:
            raise ValueError("host_aug decodes with PIL: native_decode "
                             "applies to the device-augmentation feed")
        self.dataset = dataset
        self.crops = crops
        self.B = batch_size
        self.epoch = epoch
        self.seed = seed
        self.host_aug = host_aug
        self.out_dtype = out_dtype
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            (seed << 16) + epoch)
        if host_aug:
            self.aug = DataAugmentationDINO(
                global_size=crops.global_size, global_scale=crops.global_scale,
                local_size=crops.local_size, local_scale=crops.local_scale,
                local_crops_number=crops.local_crops_number)
        shard = dict(epoch=epoch, seed=seed, process_index=process_index,
                     process_count=process_count)
        if sampler_kind == "sharded":
            self.indices = sharded_indices(len(dataset), **shard)
        elif sampler_kind == "repeated_aug":
            self.indices = repeated_aug_indices(
                len(dataset), num_repeats=num_repeats, **shard)
        elif sampler_kind == "chunk":
            if not hasattr(dataset, "chunk_sizes"):
                raise ValueError("sampler_kind='chunk' needs a dataset of "
                                 "shards with chunk_sizes (the TSV readers)")
            self.indices = chunk_aware_indices(list(dataset.chunk_sizes),
                                               **shard)
        else:
            raise ValueError(f"unknown sampler_kind {sampler_kind!r}")
        if native_decode is None:
            native_decode = (not host_aug and hasattr(dataset, "raw_bytes")
                             and native.available())
        self.native = native.library() if native_decode else None
        self.native_scaled = native_scaled
        self.waits: list[float] = []
        self.native_images = 0
        self.pil_images = 0

    def __len__(self):
        return len(self.indices) // self.B

    def _seed(self, pos: int) -> int:
        """The seed of the sample at ``pos`` in the epoch: by position as
        well as index, so the repeats of ``repeated_aug`` draw distinct
        crops (esvit_tpu's seed, stable across processes: a hash of
        ints)."""
        return hash((self.seed, self.epoch, int(self.indices[pos]), pos)
                    ) & 0x7FFFFFFF

    def _views(self, pos: int) -> list[np.ndarray]:
        """The sample's views through PIL: uint8 crops, or with host_aug
        float32 views of the full pipeline."""
        img, _ = self.dataset[int(self.indices[pos])]
        if img.mode != "RGB":
            img = img.convert("RGB")
        rng = random.Random(self._seed(pos))
        if self.host_aug:
            return self.aug(img, rng)
        return crop_views_host_rrc(img, self.crops, rng)

    def _native_job(self, pos: int):
        """(the library's source, boxes) of the sample at ``pos``, or None
        (with no random draw made) for a sample the library does not
        take (native.Datapath.source: the JPEG's bytes, or PIL's pixels
        where the library has no JPEG half)."""
        item = self.dataset.raw_bytes(int(self.indices[pos]))
        source = None if item is None else self.native.source(item[0])
        if source is None:
            return None
        boxes, _ = sample_multicrop_boxes(
            self.crops, random.Random(self._seed(pos)), *source[1])
        return source[0], boxes

    def _host_batch(self, b: int):
        """Batch b's views, view-major: rows [g1 of each sample; g2 of
        each] and [local j of each sample, for j in order], as uint8
        tensors (float32 with host_aug), pinned for a card; and the counts
        of its samples that the native path and PIL made."""
        B, c = self.B, self.crops
        L = c.local_crops_number
        dtype = torch.float32 if self.host_aug else torch.uint8
        pin = self.device.type == "cuda"
        g = torch.empty((2 * B, c.global_size, c.global_size, 3), dtype=dtype,
                        pin_memory=pin)
        loc = torch.empty((L * B, c.local_size, c.local_size, 3), dtype=dtype,
                          pin_memory=pin)
        gn, ln = g.numpy(), loc.numpy()
        # View v's rows; sample s's view lands at row s of each.
        outs = [gn[:B], gn[B:]] + [ln[j * B:(j + 1) * B] for j in range(L)]
        sizes = [c.global_size] * 2 + [c.local_size] * L
        jobs, pil = [], 0
        for s in range(B):
            job = self._native_job(b * B + s) if self.native else None
            if job is None:
                for out, view in zip(outs, self._views(b * B + s)):
                    out[s] = view
                pil += 1
            else:
                jobs.append((s, *job))
        if not jobs:
            return g, loc, 0, pil
        status = self.native.crops(
            [src for _, src, _ in jobs], np.stack([bx for _, _, bx in jobs]),
            sizes, outs, [s for s, _, _ in jobs],
            allow_scaled=self.native_scaled)
        failed = 0
        for (s, _, bx), st in zip(jobs, status):
            if st == native.DP_OK:
                continue
            # The native decode failed after the boxes were drawn (a CMYK
            # JPEG): the same views through PIL.
            failed += 1
            img, _ = self.dataset[int(self.indices[b * B + s])]
            for out, view in zip(outs, crop_views(img.convert("RGB"), bx,
                                                  sizes)):
                out[s] = view
        return g, loc, len(jobs) - failed, pil + failed

    def host_batches(self) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """The epoch's host batches in order, made by ``num_threads``
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
                    g, loc, n_native, n_pil = pending.popleft().result()
                    self.waits.append(time.perf_counter() - t0)
                    self.native_images += n_native
                    self.pil_images += n_pil
                    if b + self.prefetch < nb:
                        pending.append(pool.submit(self._host_batch,
                                                   b + self.prefetch))
                    yield g, loc
            finally:
                for f in pending:
                    f.cancel()

    def __iter__(self) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """(global, local) NHWC batches of ``out_dtype`` on the device:
        each host batch uploaded, then augmented there (host_aug: already
        augmented)."""
        for g, loc in self.host_batches():
            g = g.to(self.device, non_blocking=True)
            loc = loc.to(self.device, non_blocking=True)
            if self.host_aug:
                yield g.to(self.out_dtype), loc.to(self.out_dtype)
            else:
                yield augment_device.augment_multicrop(
                    g, loc, self.generator, self.out_dtype)


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
