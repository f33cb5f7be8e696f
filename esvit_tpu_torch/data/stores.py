"""Pack encoded images into the stores that data/datasets.py reads.

Each writer takes ``(name, encoded bytes, label)`` items: ``write_zip``
a zip with its ``<member>\\t<label>`` map file (``ZipData``),
``write_tsv`` a TSV of ``(key, label JSON, base64 image)`` rows with its
``.lineidx`` (``TSVDataset``, ``CompositeTSVDataset``), ``write_filelist``
the files under a root with a ``<relative path> <label>`` list
(``FileListDataset``). For converting a folder of images, and for the
tests and smoke runs, which write their stores from a seed.
"""

from __future__ import annotations

import base64
import json
import os
import zipfile
from typing import Iterable

from esvit_tpu_torch.data.datasets import generate_lineidx

Item = tuple[str, bytes, int]


def write_zip(items: Iterable[Item], zip_path: str, map_file: str) -> None:
    """The images as stored members of a zip (already compressed), and
    the map file."""
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_STORED) as zf, \
            open(map_file, "w") as mf:
        for name, data, label in items:
            zf.writestr(name, data)
            mf.write(f"{name}\t{label}\n")


def write_tsv(items: Iterable[Item], tsv_path: str) -> None:
    """One row per image: its name, ``[{"class": label}]``, its bytes in
    base64; then the ``.lineidx`` beside it."""
    with open(tsv_path, "w") as f:
        for name, data, label in items:
            f.write(f"{name}\t{json.dumps([{'class': label}])}\t"
                    f"{base64.b64encode(data).decode()}\n")
    generate_lineidx(tsv_path, os.path.splitext(tsv_path)[0] + ".lineidx")


def write_filelist(items: Iterable[Item], root: str, list_file: str) -> None:
    """Each image as the file ``root/<name>``, listed with its label."""
    with open(list_file, "w") as lf:
        for name, data, label in items:
            path = os.path.join(root, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(data)
            lf.write(f"{name} {label}\n")
