"""The window-attention forward tiles (csrc/window_attention_tile.cuh) on
the CPU: a plain-torch model of their arithmetic, their launch geometry,
and the build's rebuild rule for the shared header.

The kernels cannot run here, so this file models what they compute, down
to the tile padding: query rows and keys padded to 64 and read clamped to
row N-1, the head dim zero-filled to a multiple of 16, -inf in the padded
key columns. bf16 models hold exact bf16 values in fp32 tensors: the mma
multiplies bf16 operands exactly and accumulates in fp32.

- Row 7 (ops/pallas_window_attention.py): unscaled q in the product, the
  fp32 score scaled after it, p split into bf16(p) + bf16(p - bf16(p)).
  Held before the output cast to pallas_window_attention_plain and to
  JAX's _reference_attention on the same bf16 values in fp32: within
  2^-16 max|v|, since hi + lo carries each p to 2^-17 relative (so an
  output moves by at most 2^-17 sum_j p_j |v_j| <= 2^-17 max|v|) and the
  fp32 sums add less than that. After the cast: within one bf16 ulp of
  the plain version's bf16 output, beyond that same 2^-16 max|v|.
- Row 3 (ops/window_attention.py): qs = bf16(q * bf16(scale)) and p
  rounded to bf16, which is window_attention_plain's arithmetic. Held to
  it after the output cast: one bf16 ulp (2^-7 of the larger value) for a
  rounding the fp32 sum order flips, plus 2^-8 max|v| for a p whose bf16
  rounding flips.
- fp32 (both rows): q * scale first, p in fp32. Within 1e-5 of both plain
  versions (fp32 sums in another order; the 2e-5 gate of the card runs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu.ops import pallas_window_attention as jpwa
from esvit_tpu_torch.ops import cuda_build
from esvit_tpu_torch.ops import pallas_window_attention as pwa
from esvit_tpu_torch.ops import window_attention as wa
from tests.torch_threads import one_intra_op_thread  # noqa: F401

# (windows B_, N, C, nH, window types): N 16, 36, 64 and Swin's 49; head
# dims 32, 24 and 5 (zero-filled to 32 and 16), 64; one and several types.
SHAPES = [
    (8, 16, 64, 2, 4),
    (6, 36, 48, 2, 2),
    (3, 64, 128, 2, 1),
    (5, 49, 96, 3, 1),
    (6, 9, 15, 3, 3),
]
FP32_TOL = 1e-5


def _bf16(t):
    return t.to(torch.bfloat16).float()


def tile_model(q, k, v, bias, scale, *, bf16, round_q=False, split_p=False):
    """One tile per (window, head): q, k, v (G, N, hd) fp32, bias (G, N, N)
    fp32 -> (G, N, hd) fp32, the kernel's output before its one cast.

    bf16: the product of the (rounded, if round_q) bf16 q and k in fp32,
    scaled after it unless round_q; p rounded to bf16 (split_p: plus its
    rounded residual). fp32: q * scale first, p kept in fp32."""
    G, N, hd = q.shape
    hdp = -(-hd // 16) * 16
    rows = torch.arange(64).clamp(max=N - 1)

    def tile(t):
        return torch.nn.functional.pad(t, (0, hdp - hd))[:, rows]

    Q, K, V = tile(q), tile(k), tile(v)
    if not bf16:
        Q = Q * scale
    elif round_q:
        Q = _bf16(Q * _bf16(torch.tensor(scale)))
    s = Q @ K.transpose(1, 2)
    if bf16 and not round_q:
        s = s * scale
    s = s + bias[:, rows][:, :, rows]
    s[:, :, N:] = -torch.inf
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    if bf16:
        hi = _bf16(p)
        o = hi @ V
        if split_p:
            o = o + _bf16(p - hi) @ V
    else:
        o = p @ V
    return o[:, :N, :hd]


def _inputs(B_, N, C, nH, types, seed=0):
    rng = np.random.default_rng(seed)
    qkv = _bf16(torch.from_numpy(rng.normal(size=(B_, N, 3 * C))
                                 .astype(np.float32)))
    table = torch.from_numpy((0.3 * rng.normal(size=(nH, N, N)))
                             .astype(np.float32))
    region = torch.from_numpy(rng.integers(0, 3, size=(types, N))
                              .astype(np.int32))
    return qkv, table, region


def _dense(table, region):
    """(types, nH, N, N): the table plus -100 where region ids differ, the
    dense bias row 7 takes and the slice row 3's blocks stage."""
    differ = region[:, :, None] != region[:, None, :]
    return table[None] + torch.where(differ, -100.0, 0.0)[:, None]


def _heads(qkv, nH):
    """(B_, N, 3C) -> q, k, v as (B_ * nH, N, hd), window-major."""
    B_, N, C3 = qkv.shape
    hd = C3 // 3 // nH
    q, k, v = qkv.reshape(B_, N, 3, nH, hd).permute(2, 0, 3, 1, 4)
    return (t.reshape(B_ * nH, N, hd) for t in (q, k, v))


def _model(qkv, dense, nH, scale, **kw):
    """tile_model over every (window, head), bias slice w % types, back in
    the (B_, N, C) layout."""
    B_, N, C3 = qkv.shape
    types = dense.shape[0]
    idx = torch.arange(B_) % types
    bias = dense[idx].reshape(B_ * nH, N, N)
    o = tile_model(*_heads(qkv, nH), bias, scale, **kw)
    return o.reshape(B_, nH, N, -1).transpose(1, 2).reshape(B_, N, C3 // 3)


def _within_one_ulp(a, b, atol):
    """One bf16 ulp apart (2^-7 of the larger), once the fp32 values the two
    rounded were allowed to differ by atol."""
    return ((a - b).abs()
            <= 2 ** -7 * torch.maximum(a.abs(), b.abs()) + atol).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_row7_bf16_model_matches_plain(shape):
    B_, N, C, nH, types = shape
    qkv, table, region = _inputs(*shape)
    dense = _dense(table, region)
    scale = (C // nH) ** -0.5
    got = _model(qkv, dense, nH, scale, bf16=True, split_p=True)
    want = pwa.pallas_window_attention_plain(qkv, dense, nH, scale)
    bound = 2 ** -16 * qkv[..., 2 * C:].abs().max()
    assert (got - want).abs().max() <= bound
    # p rounded once (no lo term) is 2^-9 off: the split is what holds it
    one = _model(qkv, dense, nH, scale, bf16=True)
    assert (one - want).abs().max() > bound
    plain_bf16 = pwa.pallas_window_attention_plain(
        qkv.to(torch.bfloat16), dense, nH, scale)
    assert _within_one_ulp(_bf16(got), plain_bf16.float(), bound)


@pytest.mark.parametrize("nWm", [1, 4])
def test_row7_bf16_model_matches_jax_reference(nWm):
    B_, N, C, nH = 8, 49, 64, 2
    qkv, table, region = _inputs(B_, N, C, nH, nWm, seed=nWm)
    dense = _dense(table, region)
    scale = (C // nH) ** -0.5
    got = _model(qkv, dense, nH, scale, bf16=True, split_p=True)
    want = np.asarray(jpwa._reference_attention(
        jnp.asarray(qkv.numpy()), jnp.asarray(dense.numpy()), nH, scale))
    bound = 2 ** -16 * qkv[..., 2 * C:].abs().max().item()
    assert np.abs(got.numpy() - want).max() <= bound


@pytest.mark.parametrize("shape", SHAPES)
def test_row3_bf16_model_is_plain(shape):
    B_, N, C, nH, types = shape
    qkv, table, region = _inputs(*shape, seed=1)
    scale = (C // nH) ** -0.5
    got = _bf16(_model(qkv, _dense(table, region), nH, scale, bf16=True,
                       round_q=True))
    q, k, v = (t.to(torch.bfloat16).reshape(B_ * N, C)
               for t in qkv.split(C, dim=-1))
    want = wa.window_attention_plain(q, k, v, table, region, N, nH,
                                     scale).float().reshape(B_, N, C)
    assert _within_one_ulp(got, want, 2 ** -8 * qkv[..., 2 * C:].abs().max())


@pytest.mark.parametrize("shape", SHAPES)
def test_fp32_model_matches_both_plain_versions(shape):
    B_, N, C, nH, types = shape
    qkv, table, region = _inputs(*shape, seed=2)
    dense = _dense(table, region)
    scale = (C // nH) ** -0.5
    got = _model(qkv, dense, nH, scale, bf16=False)
    want7 = pwa.pallas_window_attention_plain(qkv, dense, nH, scale)
    q, k, v = (t.reshape(B_ * N, C) for t in qkv.split(C, dim=-1))
    want3 = wa.window_attention_plain(q.contiguous(), k.contiguous(),
                                      v.contiguous(), table, region, N, nH,
                                      scale).reshape(B_, N, C)
    for want in (want7, want3):
        s = want.abs().max()
        torch.testing.assert_close(got / s, want / s, rtol=FP32_TOL,
                                   atol=FP32_TOL)


# Launch geometry: (windows B_, N, hd, heads, window types, itemsize, SMs),
# Swin-T's 224 px stages shifted and not, a ragged window count, and a small
# card.
PLANS = [
    (4096, 49, 32, 3, 1, 2, 132),
    (4096, 49, 32, 3, 64, 2, 132),
    (1024, 49, 32, 6, 16, 4, 132),
    (64, 49, 32, 24, 1, 2, 132),
    (64, 49, 32, 24, 1, 4, 132),
    (37, 49, 32, 3, 1, 2, 132),
    (40, 36, 24, 2, 8, 4, 2),
    (12, 64, 64, 2, 4, 2, 1),
]


def tile_windows(plan, B_, nH, types):
    """Yields (block x, block y, warp, window, head, bias slice) as the
    forward kernel (window_attention_tile_kernel) maps them: block
    (x, y = h * types + t) takes the windows w = i * types + t of head h,
    its warp k the run of i from (x * warps + k) * run, and every window of
    the block the bias slice of (t, h)."""
    per_type = B_ // types
    for x in range(plan.chunks):
        for y in range(nH * types):
            t, h = y % types, y // types
            for k in range(plan.warps):
                i0 = (x * plan.warps + k) * plan.run
                for i in range(i0, min(i0 + plan.run, per_type)):
                    yield x, y, k, i * types + t, h, t


@pytest.mark.parametrize("case", PLANS)
def test_tile_windows_cover_each_window_and_head_once(case):
    B_, N, hd, nH, types, itemsize, sms = case
    plan = wa.tile_plan(B_, N, hd, nH, types, itemsize, sms)
    assert 1 <= plan.warps <= 8 and plan.run >= 1
    assert plan.smem == wa.tile_smem_bytes(N, hd, itemsize, plan.warps)
    assert plan.smem <= 232448
    per_type = B_ // types
    # no block without a window, and enough blocks for every window
    assert (plan.chunks - 1) * plan.warps * plan.run < per_type
    assert plan.chunks * plan.warps * plan.run >= per_type
    seen = {}
    for x, y, warp, w, h, t in tile_windows(plan, B_, nH, types):
        assert 0 <= x < plan.chunks and 0 <= y < nH * types
        assert 0 <= warp < plan.warps
        assert t == w % types          # the bias slice of window w
        seen[w, h] = seen.get((w, h), 0) + 1
    assert seen == {(w, h): 1 for w in range(B_) for h in range(nH)}


def test_tile_plan_fills_the_card_at_swin_shapes():
    """At 224 s0 and s3 the plan keeps every SM busy: at least one
    resident block's worth of warps per SM on the card (132 SMs)."""
    for B_, nH in ((4096, 3), (64, 24)):
        plan = wa.tile_plan(B_, 49, 32, nH, 1, 2)
        assert plan.chunks * nH >= 132, plan


def test_library_name_follows_every_header(tmp_path):
    (tmp_path / "k.cu").write_text('#include "t.cuh"\n')
    (tmp_path / "t.cuh").write_text("// one\n")
    _, first = cuda_build._library("k", tmp_path, tmp_path / "_build")
    _, same = cuda_build._library("k", tmp_path, tmp_path / "_build")
    assert first == same
    (tmp_path / "t.cuh").write_text("// two\n")
    _, edited = cuda_build._library("k", tmp_path, tmp_path / "_build")
    assert edited != first and edited.name.startswith("libk_")
    (tmp_path / "u.cuh").write_text("// new\n")
    _, added = cuda_build._library("k", tmp_path, tmp_path / "_build")
    assert added not in (first, edited)
