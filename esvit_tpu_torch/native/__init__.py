"""ctypes bindings for the host data-path library, csrc/datapath.cpp.

The library is compiled at first use with g++ (esvit_tpu.native's flags,
``g++ -O3 -std=c++17 -fPIC -shared -pthread``, so its crops are that
library's bytes) into ``esvit_tpu_torch/_build/``, under a name that
carries a hash of the source and the variant. A build writes a per-process
temporary name under a file lock, then renames it into place, so workers
and processes that build at once neither race nor load half a file.
Nothing here runs at import time.

Two variants: with libjpeg's headers (``#include <jpeglib.h>``) the whole
library, which decodes JPEGs itself; without them the library is built
with ``-DDP_NO_JPEG``: its JPEG half is left out (``Datapath.jpeg`` is
False), PIL decodes and the library crops (``Datapath.source`` and
``crops`` hide which). ``jpeg_note()`` says why the JPEG half is
missing.

No silent degrade: ``library()`` raises with the compiler's output when
the build fails. ``available()`` and ``build_error()`` are for callers
that choose the path themselves (the loader's ``native_decode=None``).
ctypes releases the GIL for the length of each call, so decode and crops
run beside the launch thread.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import io
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

PACKAGE = Path(__file__).resolve().parents[1]
SRC = PACKAGE / "csrc" / "datapath.cpp"
BUILD = PACKAGE / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

DP_OK = 0
DP_ERR_JPEG = 1
DP_ERR_COLORSPACE = 2
DP_ERR_BOUNDS = 3
DP_ERR_ARG = 4

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)


class BuildError(RuntimeError):
    """g++ could not build or load csrc/datapath.cpp."""


def _jpeg_missing() -> Optional[str]:
    """None when ``#include <jpeglib.h>`` compiles here, else the
    compiler's message."""
    try:
        p = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                           input="#include <jpeglib.h>\n", capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise BuildError(f"g++ could not run: {e}") from e
    return None if p.returncode == 0 else p.stderr.strip()


def build(jpeg: bool) -> Path:
    """Compile csrc/datapath.cpp (with its JPEG half or without) if it is
    not built yet; the library's path. Raises BuildError with g++'s
    output."""
    variant = () if jpeg else ("-DDP_NO_JPEG",)
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS + variant).encode())
    lib = BUILD / (f"libdatapath{'' if jpeg else '_nojpeg'}_"
                   f"{digest.hexdigest()[:16]}.so")
    if lib.exists():
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / "datapath.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)       # released when closed
        if lib.exists():                       # built while we waited
            return lib
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, *variant, str(SRC),
               *(("-ljpeg",) if jpeg else ()), "-o", str(tmp)]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise BuildError(f"g++ could not run: {e}") from e
        if p.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(f"g++ failed ({p.returncode}) on {SRC}:\n"
                             f"{p.stderr}")
        os.replace(tmp, lib)
    return lib


def _contiguous_u8(arr: np.ndarray, what: str) -> np.ndarray:
    if arr.dtype != np.uint8 or not arr.flags.c_contiguous:
        raise ValueError(f"{what} must be C-contiguous uint8, got "
                         f"{arr.dtype} contiguous={arr.flags.c_contiguous}")
    return arr


def _ptr(arr: np.ndarray, ctype=_u8p):
    return arr.ctypes.data_as(ctype)


class Datapath:
    """One loaded variant of the library. ``jpeg``: whether it decodes
    JPEGs (``jpeg_dims``, ``jpeg_decode``, ``decode_multicrop``,
    ``multicrop_batch``); both variants parse, decode base64 and crop."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        lib.dp_version.restype = ctypes.c_int
        lib.dp_has_jpeg.restype = ctypes.c_int
        lib.dp_lineidx_parse.restype = ctypes.c_int64
        lib.dp_lineidx_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                         _i64p, ctypes.c_int64]
        lib.dp_b64_decode.restype = ctypes.c_int64
        lib.dp_b64_decode.argtypes = [_u8p, ctypes.c_int64, _u8p]
        lib.dp_crop_resize.restype = ctypes.c_int
        lib.dp_crop_resize.argtypes = [_u8p, ctypes.c_int32, ctypes.c_int32,
                                       ctypes.c_double, ctypes.c_double,
                                       ctypes.c_double, ctypes.c_double,
                                       _u8p, ctypes.c_int32, ctypes.c_int32]
        lib.dp_crop_batch.restype = ctypes.c_int
        lib.dp_crop_batch.argtypes = [
            ctypes.POINTER(_u8p), _i32p, _i32p, ctypes.c_int32, _f64p, _i32p,
            ctypes.POINTER(_u8p), _i64p, ctypes.c_int32, ctypes.c_int32,
            _i32p]
        self.jpeg = bool(lib.dp_has_jpeg())
        if self.jpeg:
            lib.dp_jpeg_dims.restype = ctypes.c_int
            lib.dp_jpeg_dims.argtypes = [_u8p, ctypes.c_int64, _i32p, _i32p]
            lib.dp_jpeg_decode.restype = ctypes.c_int
            lib.dp_jpeg_decode.argtypes = [_u8p, ctypes.c_int64,
                                           ctypes.c_int32, _u8p,
                                           ctypes.c_int64, _i32p, _i32p]
            lib.dp_multicrop_batch.restype = ctypes.c_int
            lib.dp_multicrop_batch.argtypes = [
                ctypes.POINTER(_u8p), _i64p, ctypes.c_int32, _f64p, _i32p,
                ctypes.POINTER(_u8p), _i64p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, _i32p]
        self.lib = lib
        self.path = path

    def _need_jpeg(self):
        if not self.jpeg:
            raise RuntimeError(f"{self.path.name} was built without its JPEG "
                               "half (no libjpeg headers): decode with PIL "
                               "and crop with crop_batch")

    # ------------------------------------------------------ lineidx / base64
    def lineidx_parse(self, data: bytes) -> np.ndarray:
        """A .lineidx blob -> int64 offsets."""
        cap = data.count(b"\n") + 2
        out = np.empty(cap, np.int64)
        n = self.lib.dp_lineidx_parse(data, len(data), _ptr(out, _i64p), cap)
        if n < 0:
            raise ValueError(f"lineidx parse failed (code {n})")
        return out[:n].copy()

    def b64_decode(self, data: bytes) -> bytes:
        src = np.frombuffer(data, np.uint8)
        out = np.empty(len(data) * 3 // 4 + 4, np.uint8)
        n = self.lib.dp_b64_decode(_ptr(src), len(data), _ptr(out))
        if n < 0:
            raise ValueError("invalid base64")
        return out[:n].tobytes()

    # ------------------------------------------------------------------ JPEG
    def jpeg_dims(self, data: bytes) -> Optional[tuple[int, int]]:
        """(width, height) from the header, or None if not a JPEG libjpeg
        reads."""
        self._need_jpeg()
        src = np.frombuffer(data, np.uint8)
        w, h = ctypes.c_int32(), ctypes.c_int32()
        rc = self.lib.dp_jpeg_dims(_ptr(src), len(data), ctypes.byref(w),
                                   ctypes.byref(h))
        return (w.value, h.value) if rc == DP_OK else None

    def jpeg_decode(self, data: bytes, scale_denom: int = 1
                    ) -> Optional[np.ndarray]:
        """(H, W, 3) RGB uint8, or None on failure (the caller falls back
        to PIL). scale_denom in {1, 2, 4, 8}: libjpeg's DCT-domain
        downscale."""
        dims = self.jpeg_dims(data)
        if dims is None:
            return None
        w = -(-dims[0] // scale_denom)
        h = -(-dims[1] // scale_denom)
        out = np.empty((h, w, 3), np.uint8)
        src = np.frombuffer(data, np.uint8)
        ww, hh = ctypes.c_int32(), ctypes.c_int32()
        rc = self.lib.dp_jpeg_decode(_ptr(src), len(data), scale_denom,
                                     _ptr(out), out.nbytes, ctypes.byref(ww),
                                     ctypes.byref(hh))
        if rc != DP_OK:
            return None
        if (ww.value, hh.value) != (w, h):
            raise RuntimeError(f"decoded {ww.value}x{hh.value}, expected "
                               f"{w}x{h}")
        return out

    # ----------------------------------------------------------------- crops
    def crop_resize(self, img: np.ndarray,
                    box: tuple[float, float, float, float],
                    size: tuple[int, int]) -> np.ndarray:
        """PIL's bicubic crop + resize. box = (y0, x0, y1, x1) in float
        pixels; size = (oh, ow); img (H, W, 3) uint8."""
        img = np.ascontiguousarray(img, np.uint8)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"img must be (H, W, 3), got {img.shape}")
        oh, ow = size
        out = np.empty((oh, ow, 3), np.uint8)
        rc = self.lib.dp_crop_resize(_ptr(img), img.shape[0], img.shape[1],
                                     float(box[0]), float(box[1]),
                                     float(box[2]), float(box[3]), _ptr(out),
                                     oh, ow)
        if rc != DP_OK:
            raise ValueError(f"crop_resize failed (code {rc})")
        return out

    @staticmethod
    def _batch_args(n: int, boxes, view_sizes, view_outs, img_rows):
        v = len(view_sizes)
        boxes = np.ascontiguousarray(boxes, np.float64)
        if boxes.shape != (n, v, 4):
            raise ValueError(f"boxes {boxes.shape}, want {(n, v, 4)}")
        rows = np.asarray(img_rows, np.int64)
        if len(view_outs) != v or rows.shape != (n,):
            raise ValueError("one output per view and one row per image")
        for k, o in enumerate(view_outs):
            _contiguous_u8(o, f"view_outs[{k}]")
            s = view_sizes[k]
            if o.ndim != 4 or o.shape[1:] != (s, s, 3):
                raise ValueError(f"view_outs[{k}] {o.shape}, want (rows, {s},"
                                 f" {s}, 3)")
            if n and not 0 <= rows.min() <= rows.max() < o.shape[0]:
                raise ValueError(f"img_rows outside view_outs[{k}]'s "
                                 f"{o.shape[0]} rows")
        outs = (_u8p * v)(*[_ptr(o) for o in view_outs])
        return (boxes, np.asarray(view_sizes, np.int32), outs, rows,
                np.empty(n, np.int32))

    def multicrop_batch(self, jpegs: Sequence[bytes], boxes: np.ndarray,
                        view_sizes: Sequence[int],
                        view_outs: Sequence[np.ndarray],
                        img_rows: Sequence[int], *,
                        allow_scaled: bool = True,
                        nthreads: int = 1) -> np.ndarray:
        """Decode each JPEG once and write every crop + resize view straight
        into the view-major batch arrays.

        boxes: (n_imgs, n_views, 4) float64 (top, left, h, w) at full
        resolution. view_outs[v]: (rows, S_v, S_v, 3) uint8 C-contiguous;
        image i's view v lands at row img_rows[i]. Returns each image's
        status (0 = ok); a failed image's rows are untouched, for the
        caller to fill through PIL."""
        self._need_jpeg()
        n = len(jpegs)
        boxes, vs, outs, rows, status = self._batch_args(
            n, boxes, view_sizes, view_outs, img_rows)
        srcs = [np.frombuffer(j, np.uint8) for j in jpegs]
        jp = (_u8p * n)(*[_ptr(s) for s in srcs])
        jl = np.array([len(j) for j in jpegs], np.int64)
        rc = self.lib.dp_multicrop_batch(
            jp, _ptr(jl, _i64p), n, _ptr(boxes, _f64p), _ptr(vs, _i32p), outs,
            _ptr(rows, _i64p), len(vs), 1 if allow_scaled else 0,
            max(1, nthreads), _ptr(status, _i32p))
        if rc != DP_OK:
            raise ValueError(f"multicrop_batch failed (code {rc})")
        return status

    def crop_batch(self, images: Sequence[np.ndarray], boxes: np.ndarray,
                   view_sizes: Sequence[int], view_outs: Sequence[np.ndarray],
                   img_rows: Sequence[int], *, nthreads: int = 1
                   ) -> np.ndarray:
        """``multicrop_batch`` for images already decoded: images[i] is
        (H_i, W_i, 3) uint8 C-contiguous at full resolution."""
        n = len(images)
        boxes, vs, outs, rows, status = self._batch_args(
            n, boxes, view_sizes, view_outs, img_rows)
        for k, im in enumerate(images):
            _contiguous_u8(im, f"images[{k}]")
            if im.ndim != 3 or im.shape[2] != 3:
                raise ValueError(f"images[{k}] {im.shape}, want (H, W, 3)")
        ip = (_u8p * n)(*[_ptr(im) for im in images])
        hs = np.array([im.shape[0] for im in images], np.int32)
        ws = np.array([im.shape[1] for im in images], np.int32)
        rc = self.lib.dp_crop_batch(
            ip, _ptr(hs, _i32p), _ptr(ws, _i32p), n, _ptr(boxes, _f64p),
            _ptr(vs, _i32p), outs, _ptr(rows, _i64p), len(vs),
            max(1, nthreads), _ptr(status, _i32p))
        if rc != DP_OK:
            raise ValueError(f"crop_batch failed (code {rc})")
        return status

    def source(self, data: bytes):
        """(what ``crops`` takes, (width, height)) of a JPEG's bytes, or
        None for bytes that are not a JPEG this library takes: the bytes
        themselves where it decodes (their size read from the header
        alone), else PIL's decode to RGB pixels."""
        if self.jpeg:
            dims = self.jpeg_dims(data)
            return None if dims is None else (data, dims)
        from PIL import Image

        with Image.open(io.BytesIO(data)) as img:
            if img.format != "JPEG":
                return None
            pixels = np.asarray(img.convert("RGB"))
        return pixels, (pixels.shape[1], pixels.shape[0])

    def crops(self, sources: Sequence, boxes: np.ndarray,
              view_sizes: Sequence[int], view_outs: Sequence[np.ndarray],
              img_rows: Sequence[int], *, allow_scaled: bool = True,
              nthreads: int = 1) -> np.ndarray:
        """The views of ``source``'s results: ``multicrop_batch`` of the
        bytes where this library decodes, ``crop_batch`` of the pixels
        where it does not."""
        if self.jpeg:
            return self.multicrop_batch(sources, boxes, view_sizes, view_outs,
                                        img_rows, allow_scaled=allow_scaled,
                                        nthreads=nthreads)
        return self.crop_batch(sources, boxes, view_sizes, view_outs,
                               img_rows, nthreads=nthreads)

    def decode_multicrop(self, data: bytes, boxes: np.ndarray,
                         sizes: Sequence[int], *, allow_scaled: bool = True
                         ) -> Optional[list]:
        """One JPEG -> its (S, S, 3) uint8 views, or None on failure.
        boxes: (n_views, 4) float64 (top, left, h, w) at full resolution."""
        outs = [np.empty((1, s, s, 3), np.uint8) for s in sizes]
        status = self.multicrop_batch(
            [data], np.asarray(boxes, np.float64)[None], list(sizes), outs,
            [0], allow_scaled=allow_scaled, nthreads=1)
        if status[0] != DP_OK:
            return None
        return [o[0] for o in outs]


@functools.cache
def load(jpeg: bool) -> Datapath:
    """The variant's library, built if needed and loaded once per
    process."""
    path = build(jpeg)
    try:
        return Datapath(path)
    except OSError as e:
        raise BuildError(f"could not load {path}: {e}") from e


@functools.cache
def _default() -> tuple[Optional[Datapath], Optional[str], Optional[str]]:
    """(library, build error, why the JPEG half is missing)."""
    try:
        missing = _jpeg_missing()
        return load(jpeg=missing is None), None, missing
    except BuildError as e:
        return None, str(e), None


def library() -> Datapath:
    """This machine's library: with its JPEG half where libjpeg's headers
    are, else without. Raises BuildError with g++'s output."""
    lib, err, _ = _default()
    if lib is None:
        raise BuildError(err)
    return lib


def available() -> bool:
    return _default()[0] is not None


def build_error() -> Optional[str]:
    return _default()[1]


def jpeg_note() -> Optional[str]:
    """Why this machine's library has no JPEG half (g++'s message for
    ``#include <jpeglib.h>``), or None when it has one."""
    return _default()[2]


# esvit_tpu.native's functions, on this machine's library.
def lineidx_parse(data: bytes) -> np.ndarray:
    return library().lineidx_parse(data)


def b64_decode(data: bytes) -> bytes:
    return library().b64_decode(data)


def jpeg_dims(data: bytes) -> Optional[tuple[int, int]]:
    return library().jpeg_dims(data)


def jpeg_decode(data: bytes, scale_denom: int = 1) -> Optional[np.ndarray]:
    return library().jpeg_decode(data, scale_denom)


def crop_resize(img, box, size) -> np.ndarray:
    return library().crop_resize(img, box, size)


def decode_multicrop(data: bytes, boxes, sizes, *, allow_scaled: bool = True):
    return library().decode_multicrop(data, boxes, sizes,
                                      allow_scaled=allow_scaled)


def multicrop_batch(jpegs, boxes, view_sizes, view_outs, img_rows, *,
                    allow_scaled: bool = True, nthreads: int = 1):
    return library().multicrop_batch(jpegs, boxes, view_sizes, view_outs,
                                     img_rows, allow_scaled=allow_scaled,
                                     nthreads=nthreads)
