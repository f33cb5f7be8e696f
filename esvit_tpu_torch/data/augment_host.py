"""Host-side (PIL) image transforms: the part of
esvit_tpu/data/augment_host.py the evals use.

The ImageNet normalisation constants and RandomResizedCrop, whose
parameter sampling mirrors torchvision's (10 attempts of area-scale and
log-uniform aspect in 3/4..4/3, then a centre-crop fallback). The DINO
multi-crop pipeline is the data feed's (ROADMAP queue 1 item 6). PIL is
imported where an image is resampled, so importing this module needs no
PIL.
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
