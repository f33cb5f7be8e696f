"""Dataset readers: the part of esvit_tpu/data/datasets.py the evals use.

Each reader is a ``__len__``/``__getitem__`` returning ``(PIL.Image,
label)``. ``ImageFolder`` is the class-per-directory layout the evals
read; ``SyntheticImages`` is deterministic random images for tests and
smoke runs. The zip and TSV readers, the file list, the procedural shapes
and the native decode fast path (``raw_bytes``) come with the data feed
(ROADMAP queue 1 item 6). PIL is imported where an image is made, so
importing this module needs no PIL.
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


_NOT_PORTED = ("zip", "tsv", "composite_tsv", "openimages_tsv", "filelist",
               "shapes", "shapes_hard")


def build_dataset(kind: str, **kw):
    """Factory mirroring esvit_tpu's dispatch (datasets/build.py:32-61)."""
    kinds = {"folder": ImageFolder, "synthetic": SyntheticImages}
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"dataset kind {kind!r} is not ported yet "
                                  "(ROADMAP queue 1 item 6)")
    if kind not in kinds:
        raise ValueError(f"unknown dataset kind {kind!r}; have "
                         f"{sorted(kinds)}")
    return kinds[kind](**kw)
