"""The port's host augmentation (esvit_tpu_torch/data/augment_host.py:
the full-PIL DINO pipeline, DEIT's single view, random erasing) against
esvit_tpu's, on the CPU.

Both sides run the same PIL and numpy calls on the same ``random.Random``
stream, so every array is esvit_tpu's exactly (no tolerance), and the
stream is left in the same state. The loader's ``host_aug`` path hands
out esvit_tpu's host_aug batches, byte for byte.
"""

import random

import numpy as np
import pytest
import torch
from PIL import Image

from esvit_tpu import config as jcfg
from esvit_tpu.data import augment_host as jaug
from esvit_tpu.data import loader as jloader
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.data import augment_host as taug
from esvit_tpu_torch.data import datasets as tdata
from esvit_tpu_torch.data import loader as tloader
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def _image(seed, h=72, w=90, mode="RGB"):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img = Image.fromarray(arr).resize((w, h), Image.BILINEAR)
    return img.convert(mode)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_dino_augmentation_equals_esvit_tpu(seed):
    kw = dict(global_size=48, local_size=24, local_crops_number=3)
    img = _image(seed, mode="L" if seed == 5 else "RGB")
    a, b = random.Random(seed), random.Random(seed)
    _same(taug.DataAugmentationDINO(**kw)(img, a),
          jaug.DataAugmentationDINO(**kw)(img, b))
    assert a.random() == b.random()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_deit_augmentation_equals_esvit_tpu(seed):
    kw = dict(size=40, re_prob=0.5 if seed % 2 else 1.0, re_count=seed % 3)
    img = _image(10 + seed)
    a, b = random.Random(seed), random.Random(seed)
    _same(taug.DataAugmentationDEIT(**kw)(img, a),
          jaug.DataAugmentationDEIT(**kw)(img, b))
    assert a.random() == b.random()


@pytest.mark.parametrize("prob,count", [(1.0, 1), (1.0, 3), (0.25, 2)])
def test_random_erasing_equals_esvit_tpu(prob, count):
    x = np.random.default_rng(0).normal(size=(32, 40, 3)).astype(np.float32)
    for seed in range(8):
        a, b = random.Random(seed), random.Random(seed)
        got = taug.RandomErasing(prob=prob, count=count)(x, a)
        want = jaug.RandomErasing(prob=prob, count=count)(x, b)
        np.testing.assert_array_equal(got, want)
        assert a.random() == b.random()
    # The input is never written.
    assert not np.array_equal(taug.RandomErasing(prob=1.0)(
        x, random.Random(1)), x)


@pytest.mark.parametrize("hue", [0.0, 0.1, 0.5])
def test_color_jitter_and_view_transform_equal_esvit_tpu(hue):
    img = _image(20)
    for seed in range(6):
        a, b = random.Random(seed), random.Random(seed)
        got = taug.color_jitter(img, a, hue=hue)
        want = jaug.color_jitter(img, b, hue=hue)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        view = dict(size=32, scale=(0.2, 1.0), blur_p=0.5, solarize_p=0.5)
        np.testing.assert_array_equal(taug.ViewTransform(**view)(img, a),
                                      jaug.ViewTransform(**view)(img, b))


@pytest.mark.parametrize("sampler_kind", ["sharded", "repeated_aug"])
def test_host_aug_batches_equal_esvit_tpu_iterator(sampler_kind):
    """MultiCropIterator(host_aug=True): the float32 batches esvit_tpu's
    iterator yields, view-major, bit for bit; no device augmentation."""
    B = 3
    ds = tdata.ProceduralShapesHard(n=2 * B, size=72, seed=1)
    tcrops = tcfg.CropConfig(global_size=40, local_size=24,
                             local_crops_number=2)
    jcrops = jcfg.CropConfig(global_size=40, local_size=24,
                             local_crops_number=2)
    kw = dict(epoch=1, seed=4, host_aug=True, num_threads=2,
              sampler_kind=sampler_kind)
    want = list(jloader.MultiCropIterator(ds, jcrops, B, **kw))
    it = tloader.MultiCropIterator(ds, tcrops, B, device="cpu", **kw)
    got = list(it)
    assert len(got) == len(want) == (2 if sampler_kind == "sharded" else 6)
    for (tg, tl), (jg, jl) in zip(got, want):
        assert tg.dtype == tl.dtype == torch.float32
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (it.native_images, it.pil_images) == (0, len(it.indices))
