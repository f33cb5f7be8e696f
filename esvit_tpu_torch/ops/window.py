"""Window partitioning, shifted-window tables and window-major layouts.

Port of esvit_tpu/ops/window.py. The table functions are the same numpy
functions (static per shape, cached); :func:`device_table` keeps one copy
of each on every device the model runs on, so a forward moves no table
from the host. The window-major token movements are index gathers with
the numpy permutations: a permutation's backward scatters exactly one
value into each slot, so it is exact and deterministic.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, window_size*window_size, C). H, W divisible."""
    B, H, W, C = x.shape
    ws = window_size
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, window_size: int, H: int, W: int
                   ) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    ws = window_size
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


@functools.lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(wh*ww, wh*ww) int32 index into the (2wh-1)*(2ww-1) bias table
    (swin_transformer.py:100-109)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)                                   # 2, N
    rel = flat[:, :, None] - flat[:, None, :]                      # 2, N, N
    rel = rel.transpose(1, 2, 0).astype(np.int64)                  # N, N, 2
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(H: int, W: int, window_size: int, shift_size: int
                        ) -> np.ndarray:
    """(nW, N, N) float32 additive mask (0 / -100) for SW-MSA
    (swin_transformer.py:249-272), on the padded (Hp, Wp) grid."""
    ws, ss = window_size, shift_size
    Hp = int(np.ceil(H / ws)) * ws
    Wp = int(np.ceil(W / ws)) * ws
    img = np.zeros((Hp, Wp), dtype=np.int32)
    slices = (slice(0, -ws), slice(-ws, -ss), slice(-ss, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]                         # nW, N, N
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def window_region_ids(H: int, W: int, window_size: int, shift_size: int
                      ) -> np.ndarray:
    """(nW, N) int32 shift-region label per window token. Tokens in
    different regions must not attend: mask = -100 * (id_i != id_j)."""
    ws, ss = window_size, shift_size
    Hp = int(np.ceil(H / ws)) * ws
    Wp = int(np.ceil(W / ws)) * ws
    img = np.zeros((Hp, Wp), dtype=np.int32)
    slices = (slice(0, -ws), slice(-ws, -ss), slice(-ss, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img[hs, wsl] = cnt
            cnt += 1
    return (img.reshape(Hp // ws, ws, Wp // ws, ws)
            .transpose(0, 2, 1, 3).reshape(-1, ws * ws).astype(np.int32))


@functools.lru_cache(maxsize=None)
def pad_to_window_multiple(H: int, W: int, window_size: int) -> tuple[int, int]:
    ws = window_size
    Hp = int(np.ceil(H / ws)) * ws
    Wp = int(np.ceil(W / ws)) * ws
    return Hp, Wp


@functools.lru_cache(maxsize=None)
def window_major_perm(Hp: int, Wp: int, window_size: int, shift: int
                      ) -> np.ndarray:
    """Permutation p with x_window_major = x_spatial_flat[:, p, :]: the
    token order of roll(-shift) then window_partition on the (Hp, Wp) grid."""
    grid = np.arange(Hp * Wp).reshape(Hp, Wp)
    if shift:
        grid = np.roll(grid, (-shift, -shift), axis=(0, 1))
    ws = window_size
    return grid.reshape(Hp // ws, ws, Wp // ws, ws).transpose(
        0, 2, 1, 3).reshape(-1)


@functools.lru_cache(maxsize=None)
def window_major_inverse(Hp: int, Wp: int, window_size: int, shift: int
                         ) -> np.ndarray:
    return np.argsort(window_major_perm(Hp, Wp, window_size, shift))


@functools.lru_cache(maxsize=None)
def layout_transition(Hp: int, Wp: int, window_size: int, src_shift: int,
                      dst_shift: int) -> np.ndarray:
    """Permutation t with x_dst = x_src[:, t, :] between two window-major
    layouts (src/dst shift amounts)."""
    inv_src = window_major_inverse(Hp, Wp, window_size, src_shift)
    perm_dst = window_major_perm(Hp, Wp, window_size, dst_shift)
    return inv_src[perm_dst]


@functools.lru_cache(maxsize=None)
def pad_token_mask(H: int, W: int, Hp: int, Wp: int, window_size: int,
                   shift: int) -> np.ndarray:
    """(Hp*Wp,) float32: 1 for real tokens, 0 for padding, in the
    window-major layout of (Hp, Wp, shift). Multiplied in after norm1 so
    padded keys/values are zero like the reference's post-norm zero-pad
    (swin_transformer.py:286-291)."""
    real = np.zeros((Hp, Wp), np.float32)
    real[:H, :W] = 1.0
    return real.reshape(-1)[window_major_perm(Hp, Wp, window_size, shift)]


@functools.lru_cache(maxsize=None)
def device_table(table_fn, args: tuple, device: torch.device) -> torch.Tensor:
    """``table_fn(*args)`` as a tensor on ``device``, made once per device.
    Callers only read it. It is made outside inference mode even when the
    first caller runs in it (the evals), so that a later training forward
    may save it for backward."""
    with torch.inference_mode(False):
        return torch.as_tensor(np.ascontiguousarray(table_fn(*args)),
                               device=device)


def _gather(x: torch.Tensor, table_fn, args: tuple) -> torch.Tensor:
    idx = device_table(table_fn, args, x.device).long()
    return torch.index_select(x, 1, idx)


def to_window_major(x: torch.Tensor, Hp: int, Wp: int, window_size: int,
                    shift: int) -> torch.Tensor:
    """(B, Hp*Wp, C) -> (B, nW*ws^2, C) window-major (window_major_perm)."""
    return _gather(x, window_major_perm, (Hp, Wp, window_size, shift))


def from_window_major(x: torch.Tensor, Hp: int, Wp: int, window_size: int,
                      shift: int) -> torch.Tensor:
    """Inverse of to_window_major."""
    return _gather(x, window_major_inverse, (Hp, Wp, window_size, shift))


def transition_window_major(x: torch.Tensor, Hp: int, Wp: int,
                            window_size: int, src_shift: int,
                            dst_shift: int) -> torch.Tensor:
    """Between two window-major layouts (layout_transition order)."""
    return _gather(x, layout_transition,
                   (Hp, Wp, window_size, src_shift, dst_shift))
