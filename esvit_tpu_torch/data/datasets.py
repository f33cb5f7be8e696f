"""Dataset readers (port of esvit_tpu/data/datasets.py).

Each reader is a ``__len__``/``__getitem__`` returning ``(PIL.Image,
label)``; the stores of encoded images also have ``raw_bytes(i)``, the
image's encoded bytes and its label (None for a sample the native decode
should not try), which the loader's native path decodes outside the GIL.

- ``ImageFolder``: the class-per-directory layout; ``FileListDataset``:
  ``<relative path> <label>`` lines under a root.
- ``ZipData``: images in a zip with a ``<member>\t<class>`` map file;
  one ``ZipFile`` handle per thread (and per process).
- ``TSVFile`` (random access through a ``.lineidx`` sidecar, written by
  ``generate_lineidx`` when missing and parsed by the native library),
  ``TSVDataset`` (key, label JSON, base64 image), ``CompositeTSVDataset``
  (shards as one dataset, with the ``chunk_sizes`` the chunk-aware
  sampler reads), ``TSVOpenImageDataset`` (a separate label TSV),
  ``TSVImageTextDataset`` (image, caption pairs).
- ``SyntheticImages``, ``ProceduralShapes`` / ``ProceduralShapesHard``:
  generated images, drawn with numpy ``default_rng`` and PIL exactly as
  esvit_tpu draws them, so the images are the same bytes.

The same storage formats, items and labels as esvit_tpu's readers. PIL
is imported where an image is made, so importing this module needs no
PIL.
"""

from __future__ import annotations

import base64
import bisect
import io
import json
import os
import random
import threading
import zipfile
from typing import Sequence

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

    def raw_bytes(self, i: int):
        """(encoded bytes, label) for the native decode path; None for a
        file that is not a JPEG."""
        path, label = self.samples[i]
        if not path.lower().endswith((".jpg", ".jpeg")):
            return None
        with open(path, "rb") as f:
            return f.read(), label


def _open_rgb(data: bytes):
    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        return img.convert("RGB")


class ZipData:
    """Images in a zip with a ``map_file`` of ``<member>\\t<class>`` lines
    (ref: datasets/zipdata.py:10-93). One ``ZipFile`` per thread and
    process, as esvit_tpu keeps one per process."""

    def __init__(self, zip_path: str, map_file: str):
        self.zip_path = zip_path
        self.samples: list[tuple[str, int]] = []
        with open(map_file) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) == 2:
                    self.samples.append((parts[0], int(parts[1])))
        self._local = threading.local()

    def _zf(self) -> zipfile.ZipFile:
        key = os.getpid()
        if getattr(self._local, "pid", None) != key:
            self._local.zf = zipfile.ZipFile(self.zip_path, "r")
            self._local.pid = key
        return self._local.zf

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int):
        member, label = self.samples[i]
        return _open_rgb(self._zf().read(member)), label

    def raw_bytes(self, i: int):
        member, label = self.samples[i]
        if not member.lower().endswith((".jpg", ".jpeg")):
            return None
        return self._zf().read(member), label


def generate_lineidx(tsv_path: str, lineidx_path: str) -> None:
    """Byte offsets of each row (ref: datasets/tsv_file.py:9-18)."""
    offsets = []
    with open(tsv_path, "rb") as f:
        pos = 0
        for line in f:
            offsets.append(pos)
            pos += len(line)
    with open(lineidx_path, "w") as f:
        f.writelines(f"{o}\n" for o in offsets)


class TSVFile:
    """Random-access TSV through a ``.lineidx`` sidecar, written when
    missing (ref: tsv_file.py:20-164). The sidecar is parsed by the
    native library where it builds (one pass in C), else in Python; one
    file handle per thread and process."""

    def __init__(self, tsv_path: str):
        from esvit_tpu_torch import native

        self.tsv_path = tsv_path
        self.lineidx_path = os.path.splitext(tsv_path)[0] + ".lineidx"
        if not os.path.isfile(self.lineidx_path):
            generate_lineidx(tsv_path, self.lineidx_path)
        with open(self.lineidx_path, "rb") as f:
            blob = f.read()
        if native.available():
            self.offsets = native.lineidx_parse(blob)
        else:
            self.offsets = [int(l) for l in blob.decode().splitlines()
                            if l.strip()]
        self._local = threading.local()

    def _fp(self):
        key = os.getpid()
        if getattr(self._local, "pid", None) != key:
            self._local.fp = open(self.tsv_path, "rb")
            self._local.pid = key
        return self._local.fp

    def __len__(self):
        return len(self.offsets)

    def seek(self, i: int) -> list[str]:
        """Row i's cells."""
        fp = self._fp()
        fp.seek(self.offsets[i])
        return fp.readline().decode("utf-8").rstrip("\n").split("\t")


def _decode_b64_image(b64: str):
    return _open_rgb(base64.b64decode(b64))


def _label_from_json(cell: str) -> int:
    """Rows carry either a bare int or a JSON list of dicts with 'class'
    (ref: datasets/tsv.py:60-92); -1 when there is no class."""
    try:
        return int(cell)
    except ValueError:
        pass
    obj = json.loads(cell)
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        v = obj[0].get("class", -1)
        try:
            return int(v)
        except (TypeError, ValueError):
            return -1
    return -1


class TSVDataset:
    """(key, label JSON, base64 image) rows (ref: datasets/tsv.py:20-113)."""

    def __init__(self, tsv_path: str):
        self.tsv = TSVFile(tsv_path)

    def __len__(self):
        return len(self.tsv)

    def __getitem__(self, i: int):
        row = self.tsv.seek(i)
        return _decode_b64_image(row[-1]), _label_from_json(row[1])

    def raw_bytes(self, i: int):
        row = self.tsv.seek(i)
        return base64.b64decode(row[-1]), _label_from_json(row[1])


class CompositeTSVDataset:
    """Many TSV shards as one dataset, with the chunk bookkeeping of the
    chunk-aware sampler (ref: tsv_file.py:167-257 CompositeTSVFile)."""

    def __init__(self, tsv_paths: Sequence[str]):
        self.shards = [TSVFile(p) for p in tsv_paths]
        self.chunk_sizes = [len(s) for s in self.shards]
        self.cum = [0]
        for n in self.chunk_sizes:
            self.cum.append(self.cum[-1] + n)

    def __len__(self):
        return self.cum[-1]

    def shard_of(self, i: int) -> tuple[int, int]:
        """(shard, row in it) of global index i."""
        s = bisect.bisect_right(self.cum, i) - 1
        return s, i - self.cum[s]

    def __getitem__(self, i: int):
        s, j = self.shard_of(i)
        row = self.shards[s].seek(j)
        return _decode_b64_image(row[-1]), _label_from_json(row[1])

    def raw_bytes(self, i: int):
        s, j = self.shard_of(i)
        row = self.shards[s].seek(j)
        return base64.b64decode(row[-1]), _label_from_json(row[1])


class TSVOpenImageDataset:
    """Multi-label OpenImages TSV: a separate label TSV maps image rows to
    class-id lists (ref: datasets/tsv_openimage.py:25-130). For SSL
    pre-training the label collapses to the first class id (-1 when
    there is none)."""

    def __init__(self, image_tsv: str, label_tsv: str):
        self.images = TSVFile(image_tsv)
        self.labels = TSVFile(label_tsv)

    def __len__(self):
        return len(self.images)

    def _label(self, i: int) -> int:
        try:
            labels = json.loads(self.labels.seek(i)[1])
            return int(labels[0]["class"]) if labels else -1
        except (ValueError, KeyError, IndexError, TypeError):
            return -1

    def __getitem__(self, i: int):
        return _decode_b64_image(self.images.seek(i)[-1]), self._label(i)

    def raw_bytes(self, i: int):
        return base64.b64decode(self.images.seek(i)[-1]), self._label(i)


class TSVImageTextDataset:
    """CLIP-style (image, caption) pairs from parallel image/text TSVs
    (ref: datasets/tsv.py:116-243); not on EsViT's pre-training path.

    image_tsv / text_tsv: a single path each, or parallel lists of shard
    paths. Text rows are ``(key, caption)``, the caption raw text
    (``text_format='txt'``) or a JSON object with a ``captions``/``tags``
    list (``'json'``); with ``num_captions == 1`` one caption is drawn at
    random per access (``random.Random(seed)``), else the first
    ``num_captions``. ``tokenize`` (e.g. a CLIP tokenizer) is applied when
    given, with ``context_length``; a leading singleton dimension of its
    output is squeezed."""

    def __init__(self, image_tsv, text_tsv, transform=None, tokenize=None,
                 context_length: int = 77, num_captions: int = 1,
                 text_format: str = "txt", seed: int = 0):
        if isinstance(image_tsv, str) != isinstance(text_tsv, str):
            raise ValueError("image_tsv and text_tsv must both be single "
                             "paths or both be shard lists")
        if isinstance(image_tsv, str):
            image_tsv, text_tsv = [image_tsv], [text_tsv]
        if len(image_tsv) != len(text_tsv):
            raise ValueError("inconsistent number of image/text TSV shards")
        self.images = CompositeTSVDataset(image_tsv)
        self.texts = CompositeTSVDataset(text_tsv)
        if len(self.images) != len(self.texts):
            raise ValueError(
                f"inconsistent image/text sizes "
                f"({len(self.images)}/{len(self.texts)})")
        self.chunk_sizes = self.images.chunk_sizes
        self.transform = transform
        self.tokenize = tokenize
        self.context_length = context_length
        self.num_captions = num_captions
        self.text_format = text_format
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.images)

    def _caption(self, cell: str):
        if self.text_format != "json":
            return cell
        js = json.loads(cell)
        caps = js.get("captions", js.get("tags"))
        if caps is None:
            raise ValueError(f"no 'captions'/'tags' in text row: {js}")
        if isinstance(caps, str):
            return caps
        if not isinstance(caps, list):
            raise ValueError("captions should be str or list")
        if self.num_captions == 1:
            return self._rng.choice(caps)
        return caps[:self.num_captions]

    def __getitem__(self, i: int):
        s, j = self.images.shard_of(i)
        img_row = self.images.shards[s].seek(j)
        txt_row = self.texts.shards[s].seek(j)
        if img_row[0] != txt_row[0]:
            raise ValueError(
                f"keys do not match for image and text at row {i}: "
                f"{img_row[0]!r} vs {txt_row[0]!r}")
        img = _decode_b64_image(img_row[-1])
        if self.transform is not None:
            img = self.transform(img)
        text = self._caption(txt_row[1])
        if self.tokenize is not None:
            tokens = np.asarray(self.tokenize(
                text, context_length=self.context_length))
            if tokens.ndim > 1 and tokens.shape[0] == 1:
                tokens = tokens[0]
            return img, tokens
        return img, text


class FileListDataset:
    """A file list: each line ``<relative/path> <label>`` under ``root``
    (ref: datasets/build.py, the webvision branch)."""

    def __init__(self, root: str, list_file: str):
        self.root = root
        self.samples: list[tuple[str, int]] = []
        with open(list_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    self.samples.append((parts[0], int(parts[1])))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int):
        from PIL import Image

        rel, label = self.samples[i]
        with Image.open(os.path.join(self.root, rel)) as img:
            return img.convert("RGB"), label

    def raw_bytes(self, i: int):
        rel, label = self.samples[i]
        if not rel.lower().endswith((".jpg", ".jpeg")):
            return None
        with open(os.path.join(self.root, rel), "rb") as f:
            return f.read(), label


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


KINDS = {"folder": ImageFolder, "zip": ZipData, "tsv": TSVDataset,
         "composite_tsv": CompositeTSVDataset,
         "openimages_tsv": TSVOpenImageDataset, "filelist": FileListDataset,
         "synthetic": SyntheticImages, "shapes": ProceduralShapes,
         "shapes_hard": ProceduralShapesHard}


def build_dataset(kind: str, **kw):
    """Factory mirroring esvit_tpu's dispatch (datasets/build.py:32-61)."""
    if kind not in KINDS:
        raise ValueError(f"unknown dataset kind {kind!r}; have "
                         f"{sorted(KINDS)}")
    return KINDS[kind](**kw)
