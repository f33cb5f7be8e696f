"""Dataset readers: the part of esvit_tpu/data/datasets.py the evals use.

Each reader is a ``__len__``/``__getitem__`` returning ``(PIL.Image,
label)``. ``ImageFolder`` is the class-per-directory layout the evals
read; ``SyntheticImages`` is deterministic random images for tests and
smoke runs; ``ProceduralShapes`` / ``ProceduralShapesHard`` are the
learnable procedural tasks of the learning gate, drawn with numpy
``default_rng`` and PIL exactly as esvit_tpu draws them, so the images
are the same bytes. The zip and TSV readers, the file list and the native
decode fast path (``raw_bytes``) are ROADMAP queue 1 item 6b. PIL is
imported where an image is made, so importing this module needs no PIL.
"""

from __future__ import annotations

import os

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class ImageFolder:
    """Standard class-per-directory layout (torchvision semantics: classes
    sorted alphabetically -> contiguous ids)."""

    def __init__(self, root: str):
        self.root = root
        classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: list[tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for f in sorted(files):
                    if f.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append(
                            (os.path.join(dirpath, f), self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int):
        from PIL import Image

        path, label = self.samples[i]
        with Image.open(path) as img:
            return img.convert("RGB"), label


class SyntheticImages:
    """Deterministic random images for tests and smoke runs (no disk)."""

    def __init__(self, n: int = 256, size: int = 256, num_classes: int = 10,
                 seed: int = 0):
        self.n, self.size, self.num_classes, self.seed = n, size, num_classes, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        from PIL import Image

        rng = np.random.default_rng(self.seed * 100003 + i)
        arr = rng.integers(0, 256, (self.size, self.size, 3), dtype=np.uint8)
        return Image.fromarray(arr), i % self.num_classes


class ProceduralShapes:
    """Structured synthetic dataset: colored shapes on noisy backgrounds,
    class = shape type. Gives SSL something learnable without real data —
    used by the learning-validation harness
    (esvit_tpu_torch/validate_learning.py)."""

    SHAPES = ("circle", "square", "triangle", "bar")

    def __init__(self, n: int = 512, size: int = 64, seed: int = 0):
        self.n, self.size, self.seed = n, size, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        from PIL import Image, ImageDraw

        rng = np.random.default_rng(self.seed * 1000003 + i)
        label = i % len(self.SHAPES)
        s = self.size
        bg = rng.integers(0, 80, (s, s, 3), dtype=np.uint8)
        img = Image.fromarray(bg)
        draw = ImageDraw.Draw(img)
        color = tuple(int(c) for c in rng.integers(120, 256, 3))
        r = int(rng.integers(s // 6, s // 3))
        cx = int(rng.integers(r + 2, s - r - 2))
        cy = int(rng.integers(r + 2, s - r - 2))
        if label == 0:
            draw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=color)
        elif label == 1:
            draw.rectangle([cx - r, cy - r, cx + r, cy + r], fill=color)
        elif label == 2:
            draw.polygon([(cx, cy - r), (cx - r, cy + r), (cx + r, cy + r)],
                         fill=color)
        else:
            draw.rectangle([cx - r, cy - r // 3, cx + r, cy + r // 3],
                           fill=color)
        return img, label


class ProceduralShapesHard:
    """16-class procedural task: class = shape(4) x fill-pattern(4), drawn on
    textured (grating + noise) backgrounds with small distractor shapes.
    Color, position, scale, background, and distractors are nuisance
    variables, so features must bind shape geometry AND fill texture —
    enough headroom for the learning-validation harness to detect recipe
    regressions that the 4-class task saturates past
    (esvit_tpu_torch/validate_learning.py)."""

    SHAPES = ("circle", "square", "triangle", "bar")
    FILLS = ("solid", "stripes", "checker", "hollow")

    def __init__(self, n: int = 512, size: int = 64, seed: int = 0,
                 num_classes: int = 16):
        assert num_classes == 16, "class = 4 shapes x 4 fills"
        self.n, self.size, self.seed = n, size, seed
        self.num_classes = num_classes

    def __len__(self):
        return self.n

    def _draw_shape(self, draw, shape: int, cx: int, cy: int, r: int, color):
        if shape == 0:
            draw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=color)
        elif shape == 1:
            draw.rectangle([cx - r, cy - r, cx + r, cy + r], fill=color)
        elif shape == 2:
            draw.polygon([(cx, cy - r), (cx - r, cy + r), (cx + r, cy + r)],
                         fill=color)
        else:
            draw.rectangle([cx - r, cy - max(r // 3, 2), cx + r,
                            cy + max(r // 3, 2)], fill=color)

    def __getitem__(self, i: int):
        from PIL import Image, ImageDraw

        rng = np.random.default_rng(self.seed * 1000003 + i)
        label = i % self.num_classes
        shape, fill = label % 4, label // 4
        s = self.size

        # Textured background: oriented grating + noise, kept dark so the
        # bright figure (>=120) stays separable.
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        fx, fy = rng.uniform(0.05, 0.3, 2)
        phase = rng.uniform(0, 2 * np.pi)
        grating = 35 + 25 * np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)
        noise = rng.integers(0, 25, (s, s, 3)).astype(np.float32)
        bg = np.clip(grating[..., None] + noise, 0, 90).astype(np.uint8)

        # Figure drawn on a mask so fill patterns can be applied in numpy.
        mask_img = Image.new("L", (s, s), 0)
        mdraw = ImageDraw.Draw(mask_img)
        r = int(rng.integers(s // 5, s // 3))
        cx = int(rng.integers(r + 2, s - r - 2))
        cy = int(rng.integers(r + 2, s - r - 2))
        self._draw_shape(mdraw, shape, cx, cy, r, 255)
        if fill == 3:  # hollow: punch out a concentric 55%-size copy
            self._draw_shape(mdraw, shape, cx, cy, max(int(r * 0.55), 2), 0)
        mask = np.asarray(mask_img, np.float32)[..., None] / 255.0
        if fill == 1:  # stripes along a random axis, period ~r/2
            p = max(r // 3, 2)
            stripes = (((xx if rng.random() < 0.5 else yy) // p) % 2)
            mask = mask * stripes[..., None]
        elif fill == 2:  # checker dots
            p = max(r // 3, 2)
            checker = ((xx // p + yy // p) % 2)
            mask = mask * checker[..., None]

        color = rng.integers(120, 256, 3).astype(np.float32)
        out = bg.astype(np.float32) * (1 - mask) + color * mask

        # 1-2 small distractor shapes (any type, smaller, dimmer).
        img = Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))
        draw = ImageDraw.Draw(img)
        for _ in range(int(rng.integers(1, 3))):
            dr = max(int(rng.integers(s // 16, s // 9)), 2)
            dcx = int(rng.integers(dr + 1, s - dr - 1))
            dcy = int(rng.integers(dr + 1, s - dr - 1))
            dcol = tuple(int(c) for c in rng.integers(90, 180, 3))
            self._draw_shape(draw, int(rng.integers(0, 4)), dcx, dcy, dr, dcol)
        return img, label


class Memoized:
    """A dataset whose images are drawn once: the first read of index i
    keeps its RGB pixels, later reads rebuild the same image from them.
    For small generated datasets read for many epochs (the learning
    gate's 4096 procedural images, about 94 passes in 6000 steps), whose
    drawing would otherwise take the feed's threads and the GIL every
    pass. The images are the wrapped dataset's, byte for byte."""

    def __init__(self, dataset):
        self.dataset = dataset
        self._kept: dict[int, tuple[np.ndarray, object]] = {}

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i: int):
        from PIL import Image

        kept = self._kept.get(int(i))
        if kept is None:
            img, label = self.dataset[i]
            kept = (np.asarray(img.convert("RGB")), label)
            self._kept[int(i)] = kept
        return Image.fromarray(kept[0]), kept[1]


_NOT_PORTED = ("zip", "tsv", "composite_tsv", "openimages_tsv", "filelist")
KINDS = {"folder": ImageFolder, "synthetic": SyntheticImages,
         "shapes": ProceduralShapes, "shapes_hard": ProceduralShapesHard}


def build_dataset(kind: str, **kw):
    """Factory mirroring esvit_tpu's dispatch (datasets/build.py:32-61)."""
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"dataset kind {kind!r} is not ported yet "
                                  "(ROADMAP queue 1 item 6b)")
    if kind not in KINDS:
        raise ValueError(f"unknown dataset kind {kind!r}; have "
                         f"{sorted(KINDS)}")
    return KINDS[kind](**kw)
