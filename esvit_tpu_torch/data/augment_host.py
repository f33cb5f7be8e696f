"""Host-side (PIL) image transforms (port of esvit_tpu/data/augment_host.py,
and of esvit_tpu/data/loader.py's host crops).

- RandomResizedCrop, whose parameter sampling mirrors torchvision's (10
  attempts of area-scale and log-uniform aspect in 3/4..4/3, then a
  centre-crop fallback), and the multi-crop boxes and their uint8 views:
  the host half of the training feed whose photometrics run on the card
  (data/augment_device.py).
- The full-PIL DINO pipeline, ``DataAugmentationDINO`` (ref:
  datasets/build.py:203-261; utils.py:43-75): per view RandomResizedCrop
  (bicubic) + flip + colour jitter (0.4, 0.4, 0.2, 0.1) at p=0.8 +
  grayscale at p=0.2 + Gaussian blur (p=1.0 for the first global view,
  0.1 for the second, 0.5 for the locals) + solarize (p=0.2, the second
  global view), then ImageNet normalisation, float32 HWC. The loader's
  ``host_aug`` path.
- ``DataAugmentationDEIT`` and ``RandomErasing``: the supervised-style
  single view (RandomResizedCrop + flip + jitter + normalise + random
  erasing).

With the same ``random.Random`` stream every box, view and array is
esvit_tpu's, byte for byte: the same PIL and numpy calls in the same
order. PIL is imported where an image is touched, so importing this
module needs no PIL.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

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


def crop_views(img, boxes, sizes) -> list[np.ndarray]:
    """The uint8 HWC views of ``img`` at ``boxes`` (top, left, h, w),
    each resized bicubic to (s, s)."""
    from PIL import Image

    return [np.asarray(img.resize((s, s), Image.BICUBIC,
                                  box=(left, top, left + w, top + h)),
                       np.uint8)
            for (top, left, h, w), s in zip(boxes, sizes)]


def crop_views_host_rrc(img, crops, rng: random.Random) -> list[np.ndarray]:
    """RandomResizedCrop only: one uint8 HWC view per crop, bicubic from
    the box (esvit_tpu/data/loader.py ``_crop_views_host_rrc``); the
    photometrics run on the device."""
    boxes, sizes = sample_multicrop_boxes(crops, rng, img.width, img.height)
    return crop_views(img, boxes, sizes)


def color_jitter(img, rng: random.Random, brightness=0.4, contrast=0.4,
                 saturation=0.2, hue=0.1):
    """torchvision ColorJitter: a random factor per operation, the four
    operations in a random order."""
    from PIL import Image, ImageEnhance

    ops = []
    b = rng.uniform(max(0, 1 - brightness), 1 + brightness)
    ops.append(lambda im: ImageEnhance.Brightness(im).enhance(b))
    c = rng.uniform(max(0, 1 - contrast), 1 + contrast)
    ops.append(lambda im: ImageEnhance.Contrast(im).enhance(c))
    s = rng.uniform(max(0, 1 - saturation), 1 + saturation)
    ops.append(lambda im: ImageEnhance.Color(im).enhance(s))
    h = rng.uniform(-hue, hue)

    def adjust_hue(im):
        if h == 0:
            return im
        hsv = np.array(im.convert("HSV"), np.uint8)
        hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(h * 255)) % 256
        return Image.fromarray(hsv, "HSV").convert("RGB")

    ops.append(adjust_hue)
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


def _normalize(img) -> np.ndarray:
    x = np.asarray(img, np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD        # HWC float32


@dataclass
class ViewTransform:
    """One crop view: RRC + flip + jitter/gray + blur/solarize + normalise."""

    size: int
    scale: tuple[float, float]
    blur_p: float
    solarize_p: float = 0.0

    def __call__(self, img, rng: random.Random) -> np.ndarray:
        from PIL import Image, ImageFilter, ImageOps

        img = random_resized_crop(img, self.size, self.scale, rng)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if rng.random() < 0.8:
            img = color_jitter(img, rng)
        if rng.random() < 0.2:
            img = img.convert("L").convert("RGB")
        if rng.random() < self.blur_p:
            # ref utils.py:43-61: radius uniform in [0.1, 2.0]
            img = img.filter(ImageFilter.GaussianBlur(rng.uniform(0.1, 2.0)))
        if rng.random() < self.solarize_p:
            img = ImageOps.solarize(img)          # threshold 128, as the ref
        return _normalize(img)


class RandomErasing:
    """timm-style random erasing, 'pixel' mode: a random rectangle is
    replaced with Gaussian noise (ref: the AUG.TIMM_AUG RE_* knobs of
    DataAugmentationDEIT, datasets/build.py:265-310)."""

    def __init__(self, prob: float = 0.25, area=(0.02, 1 / 3),
                 ratio=(0.3, 3.3), count: int = 1):
        self.prob, self.area, self.ratio, self.count = prob, area, ratio, count

    def __call__(self, x: np.ndarray, rng: random.Random) -> np.ndarray:
        """x: HWC float array, normalised (timm erases after it)."""
        if rng.random() >= self.prob:
            return x
        h, w, c = x.shape
        out = x.copy()
        for _ in range(self.count):
            for _attempt in range(10):
                target = rng.uniform(*self.area) * h * w
                aspect = math.exp(rng.uniform(math.log(self.ratio[0]),
                                              math.log(self.ratio[1])))
                eh = int(round(math.sqrt(target * aspect)))
                ew = int(round(math.sqrt(target / aspect)))
                if eh < h and ew < w:
                    top = rng.randint(0, h - eh)
                    left = rng.randint(0, w - ew)
                    noise = np.random.default_rng(
                        rng.getrandbits(32)).normal(size=(eh, ew, c))
                    out[top:top + eh, left:left + ew] = noise.astype(x.dtype)
                    break
        return out


class DataAugmentationDEIT:
    """Supervised-style augmentation (ref: datasets/build.py:265-310, the
    AUG.TIMM_AUG path): RandomResizedCrop + flip + colour jitter +
    normalise + random erasing, one view (a list of one, the loader's
    contract). timm's auto-augment policy is not reproduced, as in
    esvit_tpu: colour jitter covers the photometric family the EsViT
    recipes use."""

    def __init__(self, size: int = 224, scale=(0.08, 1.0),
                 color_jitter: float = 0.4, hflip: float = 0.5,
                 re_prob: float = 0.25, re_count: int = 1):
        self.size = size
        self.scale = scale
        self.color_jitter = color_jitter
        self.hflip = hflip
        self.erase = RandomErasing(prob=re_prob, count=re_count)

    def __call__(self, img, rng: random.Random | None = None
                 ) -> list[np.ndarray]:
        from PIL import Image

        rng = rng or random.Random()
        if img.mode != "RGB":
            img = img.convert("RGB")
        img = random_resized_crop(img, self.size, self.scale, rng)
        if rng.random() < self.hflip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if self.color_jitter > 0:
            img = color_jitter(img, rng, brightness=self.color_jitter,
                               contrast=self.color_jitter,
                               saturation=self.color_jitter, hue=0.0)
        return [self.erase(_normalize(img), rng)]


class DataAugmentationDINO:
    """[g1, g2, l1..lN] as HWC float32 arrays (datasets/build.py:203-261),
    with the asymmetric blur and solarize of the two global views."""

    def __init__(self, global_size=224, global_scale=(0.4, 1.0),
                 local_size=96, local_scale=(0.05, 0.4),
                 local_crops_number=8):
        self.global1 = ViewTransform(global_size, global_scale, blur_p=1.0)
        self.global2 = ViewTransform(global_size, global_scale, blur_p=0.1,
                                     solarize_p=0.2)
        self.local = ViewTransform(local_size, local_scale, blur_p=0.5)
        self.local_crops_number = local_crops_number

    def __call__(self, img, rng: random.Random | None = None
                 ) -> list[np.ndarray]:
        rng = rng or random.Random()
        if img.mode != "RGB":
            img = img.convert("RGB")
        views = [self.global1(img, rng), self.global2(img, rng)]
        views += [self.local(img, rng) for _ in range(self.local_crops_number)]
        return views
