"""Windowed multi-head attention: the CUDA kernel pair and its plain twin.

Replaces esvit_tpu/ops/packed_window_attention.py ``_fwd_kernel`` and
``_bwd_kernel`` (via ``packed_window_attention``) with
``csrc/window_attention.cu``. Both run on the tile kernels of
``csrc/window_attention_tile.cuh``: in bf16 on the tensor cores, one warp
(forward) or a group of four (backward) per (window, head) at a time,
several per block on windows of one (head, window type); :func:`tile_plan`
picks the block's warps and the windows per warp. The fp32 products are
register-tiled FMAs on the CUDA cores (no TF32). Each backward
block writes one dbias partial, which a second kernel sums in a fixed
order, so dbias is deterministic. The sources note what bounds the
kernels on Hopper. Windows of 64 < N <= 256 tokens (Swin at W=14) run on
the same header's large-window tile, which also serves the block-fused
kernels' attention halves and the qkv-layout forward: a block of warps
per run of windows, one dbias partial per block (:func:`bwd_partials`).
A caller takes :func:`window_attention_plain` for a shape
:func:`supports` refuses.

Layouts are the JAX ones: q2/k2/v2 ``(B_*N, C)`` window-major rows
(windows batch-major, window type minor), bias ``(nH, N, N)`` fp32,
region ``(nW, N)`` int32 shift-region ids or None (unshifted).

:func:`window_attention` launches the kernels for CUDA tensors and uses
:func:`window_attention_plain` only for tensors on the CPU. ``launches``
counts kernel launches: one per forward call, one per backward call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from esvit_tpu_torch.ops import cuda_build

launches = {"fwd": 0, "bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The tile kernels' launch plans (csrc/window_attention_tile.cuh), from an
# H100 SM's limits: 228 KB of shared memory, 1 KB of it reserved per
# block, at most 227 KB for one block; at most 32 blocks; 65536 registers.
# By itemsize: the warps an SM holds at a kernel's registers (nvcc -Xptxas
# -v; chip_smoke.py fails if a build needs more registers than these
# allow), and the longest run of windows per warp (forward: the run that
# timed best on an H100 at Swin-T's 224 px shapes, among runs of 1, 2 and
# 4).
_SM_SMEM = 233472
_BLOCK_RESERVED = 1024
_BLOCK_SMEM_MAX = 232448
_SM_BLOCKS_MAX = 32
_SM_REGS = 65536
_SM_WARPS_MAX = {2: 16, 4: 8}
_SM_WARPS_MAX_BWD = {2: 16, 4: 16}
_MAX_RUN = {2: 2, 4: 4}
_MAX_RUN_BWD = {2: 2, 4: 2}
_TILE_WARPS = (8, 7, 6, 5, 4, 3, 2, 1)
_BWD_GROUP = 4          # warps per (window, head) in the backward
_BWD_WARPS = (8, 4)
# The large-window tile (wtile::window_attention_large_kernel and its
# backward): windows above _SMALL_MAX_N tokens, up to _LARGE_MAX_N; a
# block of up to _LARGE_MAX_WARPS warps (at most a window's m16 tiles)
# shares each window's staged tiles and, where the block still fits with
# it, the (type, head)'s staged bias slice; its warps take the m16 tiles
# in turn, each sweeping 64 keys at a time; at most _LARGE_MAX_RUN windows
# per block. The kernels build under 128 registers (__launch_bounds__(512,
# 1)): the SM holds _SM_WARPS_MAX_LARGE warps by registers (chip_smoke.py
# holds the build to it).
_SMALL_MAX_N = 64
_LARGE_MAX_N = 256
_LARGE_MAX_WARPS = 16
_LARGE_KEYS = 64
_LARGE_MAX_RUN = 8
_SM_WARPS_MAX_LARGE = {2: 16, 4: 16}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _bias_bytes(N: int) -> int:
    """The (N, N) fp32 bias slice at an odd number of 16-byte units per row,
    rounded up to 128 bytes (wtile::bias_bytes)."""
    r4 = _round_up(N, 4)
    bias_ld = r4 if (r4 // 4) % 2 else r4 + 4
    return _round_up(N * bias_ld * 4, 128)


def _large_base_bytes(N: int, hd: int, itemsize: int, warps: int,
                      backward: bool) -> int:
    """The large tile's block without the bias slice (wtile::
    large_base_bytes): the q, k, v (and do) tiles, N rows each at
    head_pad(hd) + 8 bf16 / + 4 fp32; the backward's row constants (3 N
    floats); the region ids (N ints); fp32 only, a 16 x 64 scratch per
    warp at the stride 68; each part but the scratch rounded up to 128
    bytes."""
    ld = _round_up(hd, 16) + (8 if itemsize == 2 else 4)
    tiles = _round_up((4 if backward else 3) * N * ld * itemsize, 128)
    stats = _round_up(3 * N * 4, 128) if backward else 0
    ids = _round_up(N * 4, 128)
    scratch = 0 if itemsize == 2 else warps * 16 * (_LARGE_KEYS + 4) * 4
    return tiles + stats + ids + scratch


def large_bias_staged(N: int, hd: int, itemsize: int, warps: int,
                      backward: bool) -> bool:
    """Whether a large-tile block stages the composite (N, N) fp32 bias
    slice in shared memory (wtile::large_bias_staged): wherever the block
    still fits with it. Elsewhere each score reads the slice from device
    memory."""
    return (_large_base_bytes(N, hd, itemsize, warps, backward)
            + _bias_bytes(N) <= _BLOCK_SMEM_MAX)


def _large_smem_bytes(N: int, hd: int, itemsize: int, warps: int,
                      backward: bool) -> int:
    """The large tile's block (wtile::large_smem_bytes,
    large_bwd_smem_bytes): :func:`_large_base_bytes` and, where it fits,
    the staged bias slice (:func:`_bias_bytes`)."""
    base = _large_base_bytes(N, hd, itemsize, warps, backward)
    if large_bias_staged(N, hd, itemsize, warps, backward):
        return base + _bias_bytes(N)
    return base


def tile_smem_bytes(N: int, hd: int, itemsize: int, warps: int,
                    backward: bool = False) -> int:
    """Dynamic shared memory of a tile block (wtile::fwd_smem,
    bwd_smem): above N = 64 the large tile's (:func:`_large_smem_bytes`).

    Forward: the bias slice, then per warp its q, k, v tiles (bf16: N rows
    each at head_pad(hd) + 8; fp32: N, N and round_up(N, 4) rows at
    head_pad(hd) + 4, q and k sharing their room with the
    (N, 8 ceil(N / 8) + 4) p tile), each part rounded up to 128 bytes.
    Backward: the bias slice, then per group of four warps its q, k, v, do
    tiles (N rows each at head_pad(hd) + 8 bf16 / + 4 fp32, rounded up to
    128 bytes), its row constants (3 x 64 floats), its (N, N) fp32 dbias
    accumulator (the bias slice's layout) and, fp32 only, a 16-row scratch
    per warp at the fp32 p tile's stride 8 ceil(N / 8) + 4."""
    if N > _SMALL_MAX_N:
        return _large_smem_bytes(N, hd, itemsize, warps, backward)
    hdp = _round_up(hd, 16)
    if backward:
        ld = hdp + (8 if itemsize == 2 else 4)
        tiles = _round_up(4 * N * ld * itemsize, 128)
        scratch = (0 if itemsize == 2 else
                   _BWD_GROUP * 16 * (8 * -(-N // 8) + 4) * 4)
        return _bias_bytes(N) + warps // _BWD_GROUP * (
            tiles + 3 * 64 * 4 + _bias_bytes(N) + scratch)
    if itemsize == 2:
        tiles = 3 * N * (hdp + 8) * 2
    else:
        ld = hdp + 4
        tiles = (max(2 * N * ld, N * _round_up(N, 8) + 4 * N)
                 + _round_up(N, 4) * ld) * 4
    return _bias_bytes(N) + warps * _round_up(tiles, 128)


class TilePlan(NamedTuple):
    warps: int    # warps per block
    run: int      # windows per warp (backward: per group of four warps;
                  # the large tile: per block)
    chunks: int   # blocks per (head, window type): the grid is (chunks, nH * types)
    smem: int     # dynamic shared memory per block, bytes


@functools.lru_cache(maxsize=None)
def tile_plan(B_: int, N: int, hd: int, nH: int, types: int, itemsize: int,
              sms: int = 132, backward: bool = False) -> TilePlan:
    """A tile kernel's launch geometry. Warps per block: the count that
    keeps the most warps resident on an SM (ties: more warps, so a bias
    slice serves more windows); the backward takes 8 or 4 (groups of four
    warps per window). Windows per warp (per group): the longest run up to
    the kernel's maximum that still gives half a wave of blocks or more
    (the backward: a whole wave), else 1. Short runs let the block
    scheduler even out the SMs' loads. Above N = 64: the large tile's
    plan (:func:`_large_plan`)."""
    if N > _SMALL_MAX_N:
        return _large_plan(B_, N, hd, nH, types, itemsize, sms, backward)
    per_type = B_ // types
    cap = (_SM_WARPS_MAX_BWD if backward else _SM_WARPS_MAX)[itemsize]

    def resident(w):
        smem = tile_smem_bytes(N, hd, itemsize, w, backward)
        if smem > _BLOCK_SMEM_MAX:
            return 0
        return min(_SM_SMEM // (smem + _BLOCK_RESERVED), cap // w,
                   _SM_BLOCKS_MAX)

    warps = max(_BWD_WARPS if backward else _TILE_WARPS,
                key=lambda w: (resident(w) * w, w))
    per_run = warps // _BWD_GROUP if backward else warps

    def chunks(run):
        return -(-per_type // (per_run * run))

    # blocks wanted: half a wave (forward), a whole one (the backward's
    # windows take longer, so a short last wave costs more)
    slots = resident(warps) * sms // (1 if backward else 2)
    run = (_MAX_RUN_BWD if backward else _MAX_RUN)[itemsize]
    while run > 1 and chunks(run) * nH * types < slots:
        run //= 2
    return TilePlan(warps, run, chunks(run),
                    tile_smem_bytes(N, hd, itemsize, warps, backward))


def _large_plan(B_, N, hd, nH, types, itemsize, sms, backward):
    """The large tile's plan: warps per block the count that keeps the
    most warps resident (ties: more), up to one warp per m16 tile of a
    window (13 at N = 196) and among those whose block fits; a block that
    stages the bias slice (bf16 at N = 196) is alone on its SM, so it
    takes a warp per tile. Windows per block: the longest run up to
    _LARGE_MAX_RUN that still gives a whole wave of blocks, else 1. The
    backward's dbias partials, one (N, N) fp32 slice per block, scale with
    the blocks: a whole wave and no more keeps them at ~60 MB on Swin-T's
    W=14 shapes."""
    per_type = B_ // types
    cap = _SM_WARPS_MAX_LARGE[itemsize]

    def resident(w):
        smem = _large_smem_bytes(N, hd, itemsize, w, backward)
        if smem > _BLOCK_SMEM_MAX:
            return 0
        return min(_SM_SMEM // (smem + _BLOCK_RESERVED), cap // w,
                   _SM_BLOCKS_MAX)

    tiles = -(-N // 16)
    warps = max(range(1, min(_LARGE_MAX_WARPS, tiles) + 1),
                key=lambda w: (resident(w) * w, w))

    def chunks(run):
        return -(-per_type // run)

    slots = resident(warps) * sms
    run = _LARGE_MAX_RUN
    while run > 1 and chunks(run) * nH * types < slots:
        run //= 2
    return TilePlan(warps, run, chunks(run),
                    _large_smem_bytes(N, hd, itemsize, warps, backward))


def large_tile_fits(N: int, hd: int, backward: bool) -> bool:
    """The large tile's shape rule, by shape alone: whether a one-warp
    block fits the card in both dtypes with a 16-row fp32 scratch of a
    whole score row (16 x (8 ceil(N / 8) + 4) floats), the rule its callers
    have been held to since the tile was written. The blocks it launches
    (:func:`_large_base_bytes`, a scratch of one 64-key block) need no
    more than that."""
    row_scratch = 16 * (8 * -(-N // 8) + 4) * 4
    return all(_large_base_bytes(N, hd, itemsize, 0, backward)
               + (row_scratch if itemsize == 4 else 0) <= _BLOCK_SMEM_MAX
               for itemsize in (2, 4))


def supports(N: int, C: int, nH: int) -> bool:
    """Whether this pair's kernels take windows of N tokens at width C
    with nH heads, by shape alone: a head dim of 1..64 and N <= 64 (the
    small tiles), or 64 < N <= 256 where the large tile's backward block
    fits the card in both dtypes (every head dim up to 64 at Swin's
    N = 196), the rule of the block-fused pair's attention halves."""
    if not (nH > 0 and C % nH == 0 and 0 < C // nH <= 64 and N > 0):
        return False
    if N <= _SMALL_MAX_N:
        return True
    return N <= _LARGE_MAX_N and large_tile_fits(N, C // nH, backward=True)


def bwd_partials(plan: TilePlan, types: int) -> int:
    """dbias partials per head of a backward launch (wtile::bwd_parts):
    one per block, on the small tiles (a run of windows per group of four
    warps) and on the large one (a run per block) alike."""
    return types * plan.chunks


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def window_attention_plain(q2, k2, v2, bias, region, N: int, nH: int,
                           scale: float, return_probs: bool = False,
                           drop=None):
    """The kernels' function in plain PyTorch (einsum, fp32 softmax,
    autograd), with the same roundings: q*scale and the probabilities are
    rounded to the input dtype, products accumulate in fp32 (in fp64 for
    fp64 inputs, so that autograd through it is a float64 reference).

    bias is the (nH, N, N) table, shifted by ``region``'s -100 mask when
    that is given, or a dense (nWm, nH, N, N) bias that already holds the
    mask (``region`` None). With ``return_probs`` also returns the fp32
    probabilities (B_, nH, N, N)."""
    dtype = q2.dtype
    acc = torch.promote_types(dtype, torch.float32)
    C = q2.shape[-1]
    B_ = q2.shape[0] // N
    hd = C // nH
    q = q2.reshape(B_, N, nH, hd)
    k = k2.reshape(B_, N, nH, hd)
    v = v2.reshape(B_, N, nH, hd)
    qs = q * torch.tensor(scale, dtype=dtype)
    attn = torch.einsum("bnhd,bmhd->bhnm", qs.to(acc), k.to(acc))
    full = bias.to(acc) if bias.dim() == 4 else bias.to(acc)[None]
    if region is not None:
        differ = region[:, :, None] != region[:, None, :]       # (nW, N, N)
        full = full + torch.where(differ, -100.0, 0.0)[:, None]
    nWm = full.shape[0]
    attn = (attn.reshape(B_ // nWm, nWm, nH, N, N) + full).reshape(B_, nH, N, N)
    probs = torch.softmax(attn, dim=-1)
    kept = probs if drop is None else drop(probs)
    out = torch.einsum("bhnm,bmhd->bnhd", kept.to(dtype).to(acc), v.to(acc))
    out = out.to(dtype).reshape(B_ * N, C)
    return (out, probs) if return_probs else out


def window_attention_bwd_plain(q2, k2, v2, do, bias, region, N: int, nH: int,
                               scale: float):
    """The backward kernels' function in plain PyTorch, with their
    roundings (not autograd's): p recomputed in fp32; dv =
    round(round(p)^T do); dp = do v^T in fp32; ds = p (dp - rowsum(p dp));
    dq = round(round(ds) k * scale); dk = round(round(ds)^T qs), qs =
    round(q * round(scale)); dbias = the fp32 sum of ds over windows.
    Layouts as :func:`window_attention_plain` (bias the (nH, N, N) table);
    returns dq, dk, dv (the inputs' layout and dtype) and dbias."""
    dtype = q2.dtype
    C = q2.shape[-1]
    B_ = q2.shape[0] // N
    hd = C // nH
    q, k, v, g = (t.reshape(B_, N, nH, hd) for t in (q2, k2, v2, do))
    qs = q * torch.tensor(scale, dtype=dtype)
    s = torch.einsum("bnhd,bmhd->bhnm", qs.float(), k.float())
    full = bias.float()[None]
    if region is not None:
        differ = region[:, :, None] != region[:, None, :]
        full = full + torch.where(differ, -100.0, 0.0)[:, None]
    nWm = full.shape[0]
    s = (s.reshape(B_ // nWm, nWm, nH, N, N) + full).reshape(B_, nH, N, N)
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhnm,bnhd->bmhd", p.to(dtype).float(), g.float())
    dp = torch.einsum("bnhd,bmhd->bhnm", g.float(), v.float())
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dsr = ds.to(dtype).float()
    dq = torch.einsum("bhnm,bmhd->bnhd", dsr, k.float()) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", dsr, qs.float())
    return (dq.to(dtype).reshape(B_ * N, C), dk.to(dtype).reshape(B_ * N, C),
            dv.to(dtype).reshape(B_ * N, C), ds.sum(0))


GRAD_NAMES = ("dq", "dk", "dv", "dbias")


def plain_grads(q2, k2, v2, do, bias, region, N: int, nH: int,
                scale: float):
    """dq, dk, dv, dbias by autograd through :func:`window_attention_plain`
    in the inputs' dtype (bias the (nH, N, N) fp32 table, or fp64 with
    fp64 inputs)."""
    ts = [t.detach().clone().requires_grad_() for t in (q2, k2, v2, bias)]
    out = window_attention_plain(*ts, region, N, nH, scale)
    return torch.autograd.grad(out, ts, do.to(q2.dtype))


def fp64_grad_errors(grads, q2, k2, v2, do, bias, region, N: int, nH: int,
                     scale: float) -> dict:
    """dq, dk, dv, dbias (``grads``) against :func:`plain_grads` in float64
    on the same inputs: each one's max-abs difference over the float64
    gradient's max-abs, by name (:data:`GRAD_NAMES`)."""
    want = plain_grads(*(t.double() for t in (q2, k2, v2, do, bias)),
                       region, N, nH, scale)
    return {name: ((g.double() - w).abs().max() / w.abs().max()).item()
            for name, g, w in zip(GRAD_NAMES, grads, want)}


def window_attention(q2, k2, v2, bias, region, N: int, nH: int,
                     scale: float) -> torch.Tensor:
    """Windowed attention, differentiable in q2, k2, v2 and bias."""
    if q2.device.type == "cpu":
        return window_attention_plain(q2, k2, v2, bias, region, N, nH, scale)
    return _WindowAttention.apply(q2, k2, v2, bias, region, N, nH, scale)


def _check(q2, k2, v2, bias, region, N, nH):
    dev = q2.device
    if dev.type != "cuda":
        raise ValueError(f"window_attention kernel needs CUDA tensors, got {dev}")
    if q2.dtype not in _DTYPES:
        raise TypeError(f"q2 dtype {q2.dtype} not in {list(_DTYPES)}")
    rows, C = q2.shape
    for name, t in (("k2", k2), ("v2", v2)):
        if t.shape != q2.shape or t.dtype != q2.dtype or t.device != dev:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} {t.device} does "
                             f"not match q2 {tuple(q2.shape)} {q2.dtype} {dev}")
    if not (q2.is_contiguous() and k2.is_contiguous() and v2.is_contiguous()):
        raise ValueError("q2, k2, v2 must be contiguous")
    if rows % N or not supports(N, C, nH):
        raise ValueError(f"unsupported shape rows={rows} C={C} N={N} nH={nH} "
                         "(head dim <= 64; N <= 64, or N <= 256 where the "
                         "large tile fits)")
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (nH, N, N)
            or not bias.is_contiguous() or bias.device != dev):
        raise ValueError(f"bias must be contiguous fp32 ({nH}, {N}, {N}) on "
                         f"{dev}, got {bias.dtype} {tuple(bias.shape)}")
    if region is not None:
        nW = region.shape[0]
        if (region.dtype != torch.int32 or tuple(region.shape) != (nW, N)
                or not region.is_contiguous() or region.device != dev
                or (rows // N) % nW):
            raise ValueError(f"region must be contiguous int32 (nW, {N}) on "
                             f"{dev} with nW dividing the window count")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"window_attention {what} kernel failed: CUDA error {rc}")


def _fwd(q2, k2, v2, bias, region, N, nH, scale):
    _check(q2, k2, v2, bias, region, N, nH)
    lib = _lib()
    out = torch.empty_like(q2)
    rows, C = q2.shape
    nW = region.shape[0] if region is not None else 1
    plan = tile_plan(rows // N, N, C // nH, nH, nW, q2.element_size(),
                     _sm_count(q2.device.index))
    with torch.cuda.device(q2.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.esvit_window_attention_fwd(
            _ptr(q2), _ptr(k2), _ptr(v2), _ptr(bias), _ptr(region), _ptr(out),
            rows // N, N, C, nH, nW, ctypes.c_float(scale), _DTYPES[q2.dtype],
            plan.warps, plan.run, ctypes.c_void_p(stream))
    _raise_on(rc, "forward")
    launches["fwd"] += 1
    return out


def _bwd(q2, k2, v2, bias, region, do, N, nH, scale):
    _check(q2, k2, v2, bias, region, N, nH)
    if do.shape != q2.shape or do.dtype != q2.dtype or not do.is_contiguous():
        raise ValueError("the output gradient must match q2 and be contiguous")
    lib = _lib()
    rows, C = q2.shape
    B_ = rows // N
    nW = region.shape[0] if region is not None else 1
    plan = tile_plan(B_, N, C // nH, nH, nW, q2.element_size(),
                     _sm_count(q2.device.index), backward=True)
    dq, dk, dv = torch.empty_like(q2), torch.empty_like(k2), torch.empty_like(v2)
    partial = torch.empty((nH, bwd_partials(plan, nW), N, N),
                          dtype=torch.float32, device=q2.device)
    dbias = torch.empty((nH, N, N), dtype=torch.float32, device=q2.device)
    with torch.cuda.device(q2.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.esvit_window_attention_bwd(
            _ptr(q2), _ptr(k2), _ptr(v2), _ptr(bias), _ptr(region), _ptr(do),
            _ptr(dq), _ptr(dk), _ptr(dv), _ptr(partial), _ptr(dbias),
            B_, N, C, nH, nW, ctypes.c_float(scale), _DTYPES[q2.dtype],
            plan.warps, plan.run, ctypes.c_void_p(stream))
    _raise_on(rc, "backward")
    launches["bwd"] += 1
    return dq, dk, dv, dbias


@functools.cache
def _lib():
    """The loaded kernels, with the argtypes/restype of the C entry points
    declared (pointers as void*, so ctypes never truncates them)."""
    lib = cuda_build.load("window_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.esvit_window_attention_fwd.argtypes = [P] * 6 + [I] * 5 + [F] + [I] * 3 + [P]
    lib.esvit_window_attention_fwd.restype = I
    lib.esvit_window_attention_bwd.argtypes = [P] * 11 + [I] * 5 + [F] + [I] * 3 + [P]
    lib.esvit_window_attention_bwd.restype = I
    for fn in (lib.esvit_window_attention_tile_smem_bytes,
               lib.esvit_window_attention_bwd_smem_bytes):
        fn.argtypes = [I] * 4
        fn.restype = ctypes.c_longlong
    return lib


class _WindowAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q2, k2, v2, bias, region, N, nH, scale):
        ctx.save_for_backward(q2, k2, v2, bias, region)
        ctx.geometry = (N, nH, scale)
        return _fwd(q2, k2, v2, bias, region, N, nH, scale)

    @staticmethod
    def backward(ctx, g):
        q2, k2, v2, bias, region = ctx.saved_tensors
        N, nH, scale = ctx.geometry
        do = g.to(q2.dtype).contiguous()
        dq, dk, dv, dbias = _bwd(q2, k2, v2, bias, region, do, N, nH, scale)
        return dq, dk, dv, dbias, None, None, None, None

