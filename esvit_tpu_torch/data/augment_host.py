"""Host-side (PIL) image transforms: the part of
esvit_tpu/data/augment_host.py (and of esvit_tpu/data/loader.py's host
crops) that the evals and the device-augmentation feed use.

The ImageNet normalisation constants and RandomResizedCrop, whose
parameter sampling mirrors torchvision's (10 attempts of area-scale and
log-uniform aspect in 3/4..4/3, then a centre-crop fallback); the
multi-crop boxes and their uint8 views, the host half of the training
feed (photometrics run on the card, data/augment_device.py). With the
same ``random.Random`` stream the boxes and views are esvit_tpu's, byte
for byte. The full-PIL DINO pipeline (``DataAugmentationDINO``) is ROADMAP
queue 1 item 6b. PIL is imported where an image is resampled, so
importing this module needs no PIL.
"""

from __future__ import annotations

import math
import random

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def sample_rrc_params(rng: random.Random, width: int, height: int,
                      scale: tuple[float, float],
                      ratio: tuple[float, float] = (3 / 4, 4 / 3)):
    """(top, left, h, w): torchvision RandomResizedCrop.get_params logic."""
    area = width * height
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = rng.randint(0, height - h)
            left = rng.randint(0, width - w)
            return top, left, h, w
    # fallback: centre crop at a valid aspect
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    top = (height - h) // 2
    left = (width - w) // 2
    return top, left, h, w


def random_resized_crop(img, size: int, scale, rng: random.Random):
    """The sampled box of ``img`` resized to (size, size), bicubic."""
    from PIL import Image

    top, left, h, w = sample_rrc_params(rng, img.width, img.height, scale)
    return img.resize((size, size), Image.BICUBIC,
                      box=(left, top, left + w, top + h))


def sample_multicrop_boxes(crops, rng: random.Random, width: int,
                           height: int):
    """RRC boxes for all views in the order the PIL path draws them (g1,
    g2, then the locals), so both consume the rng stream alike
    (esvit_tpu/data/loader.py ``_sample_multicrop_boxes``). Returns (boxes
    (n_views, 4) float64 (top, left, h, w), sizes list)."""
    boxes = [sample_rrc_params(rng, width, height, crops.global_scale)
             for _ in range(2)]
    boxes += [sample_rrc_params(rng, width, height, crops.local_scale)
              for _ in range(crops.local_crops_number)]
    sizes = [crops.global_size] * 2 + \
        [crops.local_size] * crops.local_crops_number
    return np.asarray(boxes, np.float64), sizes


def crop_views_host_rrc(img, crops, rng: random.Random) -> list[np.ndarray]:
    """RandomResizedCrop only: one uint8 HWC view per crop, bicubic from
    the box (esvit_tpu/data/loader.py ``_crop_views_host_rrc``); the
    photometrics run on the device."""
    from PIL import Image

    boxes, sizes = sample_multicrop_boxes(crops, rng, img.width, img.height)
    return [np.asarray(img.resize((s, s), Image.BICUBIC,
                                  box=(left, top, left + w, top + h)),
                       np.uint8)
            for (top, left, h, w), s in zip(boxes, sizes)]
