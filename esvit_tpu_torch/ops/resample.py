"""Bicubic and bilinear resampling with torch's scale-factor semantics
(port of esvit_tpu/ops/resample.py ``torch_interpolate_scale`` and
``torch_bilinear_resize``).

The semantics are ``F.interpolate(mode='bicubic', align_corners=False,
scale_factor=s)``: cubic convolution with A = -0.75, taps clamped at the
edges, and the *given* scale maps the coordinates, src = (dst + 0.5) / s
- 0.5, even where it disagrees with the size ratio; the output size is
floor(size * s). The ViL patch embedding relies on that: its scale
counts the global tokens, so its position table is resampled on every
forward, even at the native grid (esvit_tpu/models/vil.py:105-122).

``F.interpolate`` itself is not used: where the output size equals the
input size, PyTorch's bicubic backward (and its CUDA forward) treat the
call as a copy, which is not the resample the reference computes. As in
the JAX module, the taps and weights are static numpy; here each axis
becomes one (out, in) interpolation matrix, and the resample is two
products in fp32, so the table stays differentiable and its gradient
deterministic.

The bilinear resize (``F.interpolate(mode='bilinear',
align_corners=False)``, the ``DownAttention`` 2x upsample) follows the
same rule, src = (dst + 0.5) / s - 0.5, with the source coordinate
clamped at 0 (ATen clamps the coordinate for linear modes, where cubic
clamps the taps) and two taps per output.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from esvit_tpu_torch.ops.window import device_table

_A = -0.75  # torch's cubic convolution alpha


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1,
        (_A + 2) * ax ** 3 - (_A + 3) * ax ** 2 + 1,
        np.where(ax < 2, _A * ax ** 3 - 5 * _A * ax ** 2 + 8 * _A * ax - 4 * _A,
                 0.0))


@functools.lru_cache(maxsize=None)
def _axis_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """(out_size, in_size) fp32: row o holds the 4 cubic weights of output
    o at its (clamped) source taps."""
    src = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    base = np.floor(src).astype(np.int64)
    offs = np.arange(-1, 3)
    idx = np.clip(base[:, None] + offs[None, :], 0, in_size - 1)
    w = _cubic_kernel(offs[None, :] - (src - base)[:, None])
    mat = np.zeros((out_size, in_size))
    np.add.at(mat, (np.arange(out_size)[:, None].repeat(4, 1), idx), w)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _axis_matrix_linear(in_size: int, out_size: int, scale: float
                        ) -> np.ndarray:
    """(out_size, in_size) fp32: row o holds the 2 linear weights of
    output o (esvit_tpu ``_axis_taps_linear``)."""
    src = np.maximum((np.arange(out_size, dtype=np.float64) + 0.5) / scale
                     - 0.5, 0.0)
    base = np.floor(src).astype(np.int64)
    t = src - base
    idx = np.stack([base, np.minimum(base + 1, in_size - 1)], axis=-1)
    w = np.stack([1.0 - t, t], axis=-1)
    mat = np.zeros((out_size, in_size))
    np.add.at(mat, (np.arange(out_size)[:, None].repeat(2, 1), idx), w)
    return mat.astype(np.float32)


def _resize(matrix, grid, out_h, out_w, scale_h, scale_w):
    H, W = grid.shape[-3], grid.shape[-2]
    sh = scale_h if scale_h is not None else out_h / H
    sw = scale_w if scale_w is not None else out_w / W
    mh = device_table(matrix, (H, out_h, sh), grid.device)
    mw = device_table(matrix, (W, out_w, sw), grid.device)
    out = torch.einsum("hi,...ijc,wj->...hwc", mh, grid.float(), mw)
    return out.to(grid.dtype)


def bilinear_resize(grid: torch.Tensor, out_h: int, out_w: int,
                    scale_h: float | None = None,
                    scale_w: float | None = None) -> torch.Tensor:
    """grid (..., H, W, C) -> (..., out_h, out_w, C) in fp32, cast back to
    the input dtype (esvit_tpu ``torch_bilinear_resize``); the scales as
    ``bicubic_resize``'s."""
    return _resize(_axis_matrix_linear, grid, out_h, out_w, scale_h,
                   scale_w)


def bicubic_resize(grid: torch.Tensor, out_h: int, out_w: int,
                   scale_h: float | None = None,
                   scale_w: float | None = None) -> torch.Tensor:
    """grid (..., H, W, C) -> (..., out_h, out_w, C) in fp32, cast back to
    the input dtype (esvit_tpu ``torch_bicubic_resize``). A given scale
    maps the coordinates (torch's scale_factor semantics); otherwise the
    size ratio does."""
    return _resize(_axis_matrix, grid, out_h, out_w, scale_h, scale_w)


def torch_interpolate_scale(grid: torch.Tensor, scale: float) -> torch.Tensor:
    """grid (..., H, W, C) -> (..., floor(H*scale), floor(W*scale), C)."""
    H, W = grid.shape[-3], grid.shape[-2]
    return bicubic_resize(grid, int(math.floor(H * scale)),
                          int(math.floor(W * scale)), scale, scale)
