"""The window-attention backward tile (csrc/window_attention_tile.cuh
window_attention_bwd_tile_kernel, row 4 and the block-fused backward's
attention half) on the CPU: a plain-torch model of its arithmetic, its
launch plan and its shared memory.

The kernel cannot run here, so this file models what it computes, down to
the tile padding: query and key rows padded to 64 and read clamped to row
N - 1, the head dim zero-filled to a multiple of 16, -inf in the padded
key columns, and in pass 2 p = ds = 0 in the padded query columns, so the
clamped rows add nothing to dv and dk. bf16 models hold exact bf16 values
in fp32 tensors (the mma multiplies bf16 operands exactly and accumulates
in fp32).

- bf16: held to ``window_attention_bwd_plain`` (the kernels' roundings) on
  the same bf16 inputs: dq, dk, dv within one bf16 ulp (2^-7 of the larger
  value) plus 2^-7 of the output's max-abs, for a rounding of ds or p that
  the fp32 sum order flips; dbias (fp32 sums) within 1e-5 of its max-abs.
- fp32: the model and ``window_attention_bwd_plain`` within 1e-5 of
  autograd through ``window_attention_plain`` (the fp32 sums run in
  another order), and the plain backward within 2e-5 of JAX's
  ``packed_window_attention`` backward in interpret mode (the tolerance of
  tests/test_torch_window_attention.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu.ops import window as jwops
from esvit_tpu.ops.packed_window_attention import packed_window_attention
from esvit_tpu_torch.ops import window_attention as wa
from tests.torch_threads import one_intra_op_thread  # noqa: F401

# (windows B_, N, C, nH, window types): N 16, 36, 64, Swin's 49 and the
# augmented 37; head dims 32, 24, 64, 5 and 10 (zero-filled to 32, 16, 16).
SHAPES = [
    (8, 16, 64, 2, 4),
    (6, 36, 48, 2, 2),
    (3, 64, 128, 2, 1),
    (5, 49, 96, 3, 1),
    (6, 9, 15, 3, 3),
    (4, 37, 20, 2, 1),
]
FP32_TOL = 1e-5


def _bf16(t):
    return t.to(torch.bfloat16).float()


def bwd_tile_model(q, k, v, do, bias, scale, *, bf16):
    """One tile per (window, head): q, k, v, do (G, N, hd) fp32, bias
    (G, N, N) fp32 -> dq, dk, dv (G, N, hd) and ds (G, N, N), fp32 values
    before the kernel's casts (bf16: already rounded where it rounds)."""
    G, N, hd = q.shape
    hdp = -(-hd // 16) * 16
    rows = torch.arange(64).clamp(max=N - 1)
    real = (torch.arange(64) < N).float()[None, :, None]
    r = _bf16 if bf16 else (lambda t: t)

    def tile(t):
        return torch.nn.functional.pad(t, (0, hdp - hd))[:, rows]

    Q, K, V, D = tile(q), tile(k), tile(v), tile(do)
    QS = _bf16(Q * _bf16(torch.tensor(scale))) if bf16 else Q * scale
    # pass 1, query tiles: p, dp, ds and dq
    s = QS @ K.transpose(1, 2) + bias[:, rows][:, :, rows]
    s[:, :, N:] = -torch.inf
    p = torch.softmax(s, dim=-1)
    dp = D @ V.transpose(1, 2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = r(r(ds) @ K * scale)
    # pass 2, key tiles: the padded query rows are zeroed
    pt, dst = p * real, ds * real
    dv = r(r(pt).transpose(1, 2) @ D)
    dk = r(r(dst).transpose(1, 2) @ QS)
    return (dq[:, :N, :hd], dk[:, :N, :hd], dv[:, :N, :hd], ds[:, :N, :N])


def _inputs(B_, N, C, nH, types, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(torch.from_numpy(
        rng.normal(size=(B_ * N, C)).astype(np.float32))) for _ in range(4))
    table = torch.from_numpy((0.3 * rng.normal(size=(nH, N, N)))
                             .astype(np.float32))
    region = torch.from_numpy(rng.integers(0, 3, size=(types, N))
                              .astype(np.int32))
    return q, k, v, do, table, region


def _heads(t, B_, N, nH):
    """(B_ * N, C) rows -> (B_ * nH, N, hd), window-major."""
    hd = t.shape[-1] // nH
    return t.reshape(B_, N, nH, hd).transpose(1, 2).reshape(B_ * nH, N, hd)


def _rows(t, B_, N, nH):
    """The inverse of _heads."""
    hd = t.shape[-1]
    return t.reshape(B_, nH, N, hd).transpose(1, 2).reshape(B_ * N, nH * hd)


def _model(q, k, v, do, table, region, B_, N, nH, scale, bf16):
    """bwd_tile_model over every (window, head), the bias slice of window
    w's type w % types, back in the rows layout; dbias summed over
    windows."""
    types = region.shape[0]
    differ = region[:, :, None] != region[:, None, :]
    dense = table[None] + torch.where(differ, -100.0, 0.0)[:, None]
    bias = dense[torch.arange(B_) % types].reshape(B_ * nH, N, N)
    dq, dk, dv, ds = bwd_tile_model(*(_heads(t, B_, N, nH) for t in (q, k, v, do)),
                                    bias, scale, bf16=bf16)
    return (*(_rows(t, B_, N, nH) for t in (dq, dk, dv)),
            ds.reshape(B_, nH, N, N).sum(0))


def _close(a, b, ulp, atol_frac):
    """max |a - b| within `ulp` of the larger value plus `atol_frac` of b's
    max-abs, elementwise."""
    atol = atol_frac * b.abs().max()
    return ((a - b).abs() <= ulp * torch.maximum(a.abs(), b.abs()) + atol).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_model_matches_plain_backward(shape):
    B_, N, C, nH, types = shape
    q, k, v, do, table, region = _inputs(*shape)
    scale = (C // nH) ** -0.5
    got = _model(q, k, v, do, table, region, B_, N, nH, scale, True)
    want = wa.window_attention_bwd_plain(
        *(t.to(torch.bfloat16) for t in (q, k, v, do)), table, region, N, nH,
        scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _close(a, b.float(), 2 ** -7, 2 ** -7), name
    s = want[3].abs().max()
    assert (got[3] - want[3]).abs().max() <= 1e-5 * s


@pytest.mark.parametrize("shape", SHAPES)
def test_fp32_model_and_plain_backward_match_autograd(shape):
    B_, N, C, nH, types = shape
    q, k, v, do, table, region = _inputs(*shape, seed=1)
    scale = (C // nH) ** -0.5
    ts = [t.clone().requires_grad_() for t in (q, k, v, table)]
    out = wa.window_attention_plain(*ts, region, N, nH, scale)
    want = torch.autograd.grad(out, ts, do)
    model = _model(q, k, v, do, table, region, B_, N, nH, scale, False)
    plain = wa.window_attention_bwd_plain(q, k, v, do, table, region, N, nH,
                                          scale)
    for got in (model, plain):
        for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
            s = b.abs().max()
            assert (a - b).abs().max() <= FP32_TOL * s, name


# (N, nH, hd, window types, images, shifted, stage side H, ws, shift ss):
# JAX's packed kernel takes N 16, 36, 49 and 64 at these head dims.
JAX_CASES = [
    (16, 2, 24, 4, 2, True, 8, 4, 2),
    (36, 2, 10, 4, 1, True, 12, 6, 3),
    (49, 3, 32, 16, 1, True, 28, 7, 3),
    (64, 2, 16, 1, 2, False, 8, 8, 0),
]


@pytest.mark.parametrize("case", JAX_CASES)
def test_plain_backward_matches_jax_packed_kernel(case):
    N, nH, hd, nW, B, shifted, H, ws, ss = case
    C, scale = nH * hd, hd ** -0.5
    rng = np.random.default_rng(2)
    q, k, v, do = (rng.normal(size=(B * nW * N, C)).astype(np.float32)
                   for _ in range(4))
    bias = (0.3 * rng.normal(size=(nH, N, N))).astype(np.float32)
    region = jwops.window_region_ids(H, H, ws, ss) if shifted else None
    fn = functools.partial(packed_window_attention, N=N, nH=nH, scale=scale,
                           score_dtype=jnp.float32, interpret=True,
                           region=region)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v, bias)))
    want = vjp(jnp.asarray(do))
    got = wa.window_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, do, bias)),
        None if region is None else torch.from_numpy(region), N, nH, scale)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        b = np.asarray(b)
        s = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a.numpy() / s, b / s, rtol=2e-5, atol=2e-5,
                                   err_msg=name)


# Launch geometry: (windows B_, N, hd, heads, window types, itemsize, SMs).
PLANS = [
    (4096, 49, 32, 3, 1, 2, 132),
    (4096, 49, 32, 3, 64, 2, 132),
    (64, 49, 32, 24, 1, 2, 132),
    (1024, 49, 32, 6, 16, 4, 132),
    (37, 49, 32, 3, 1, 2, 132),
    (12, 64, 64, 2, 4, 2, 1),
]


def bwd_blocks(plan, B_, nH, types, itemsize):
    """Yields (block x, block y, window, head, partial index within head)
    as the backward tile kernel maps them, in both dtypes: groups of four
    warps, group k of block x taking the run of i from
    (x * groups + k) * run; block (x, y = h * types + t) writes partial
    t * chunks + x of head h."""
    per_type = B_ // types
    groups = plan.warps // 4
    for x in range(plan.chunks):
        for y in range(nH * types):
            t, h = y % types, y // types
            for k in range(groups):
                i0 = (x * groups + k) * plan.run
                for i in range(i0, min(i0 + plan.run, per_type)):
                    yield x, y, i * types + t, h, t * plan.chunks + x


@pytest.mark.parametrize("case", PLANS)
def test_bwd_blocks_cover_each_window_and_head_once(case):
    B_, N, hd, nH, types, itemsize, sms = case
    plan = wa.tile_plan(B_, N, hd, nH, types, itemsize, sms, backward=True)
    assert plan.smem == wa.tile_smem_bytes(N, hd, itemsize, plan.warps, True)
    assert plan.smem <= 232448
    per_block = plan.run * plan.warps // 4
    assert (plan.chunks - 1) * per_block < B_ // types <= plan.chunks * per_block
    assert plan.warps in (4, 8)
    seen, parts = {}, set()
    for x, y, w, h, part in bwd_blocks(plan, B_, nH, types, itemsize):
        seen[w, h] = seen.get((w, h), 0) + 1
        parts.add((h, part))
    assert seen == {(w, h): 1 for w in range(B_) for h in range(nH)}
    # the wrapper's partials hold one (N, N) slot per block
    n_parts = wa.bwd_partials(plan, types)
    assert parts <= {(h, c) for h in range(nH) for c in range(n_parts)}


@pytest.mark.parametrize("N,hd,itemsize,warps,want", [
    # bias slice 49 x 52 fp32 (10240 bytes with rounding); per group of
    # four warps four 49 x 40 bf16 tiles (15744), 768 bytes of row
    # constants and a dbias accumulator laid out as the bias slice
    (49, 32, 2, 8, 10240 + 2 * (15744 + 768 + 10240)),
    (64, 64, 2, 4, 17408 + (36864 + 768 + 17408)),
    (16, 5, 2, 4, 1280 + (3072 + 768 + 1280)),
    # fp32: four 49 x 36 tiles (28288 with rounding) and four warps'
    # 16 x 60 scratch (15360)
    (49, 32, 4, 8, 10240 + 2 * (28288 + 768 + 10240 + 15360)),
    (64, 64, 4, 8, 17408 + 2 * (69632 + 768 + 17408 + 17408)),
    (37, 16, 4, 4, 6528 + (11904 + 768 + 6528 + 11264)),
])
def test_bwd_tile_smem_bytes_counts_the_layout(N, hd, itemsize, warps, want):
    assert wa.tile_smem_bytes(N, hd, itemsize, warps, backward=True) == want


def test_bwd_plan_at_swin_shapes():
    """Swin-T's backward tiles: at N=49, hd=32 the bf16 plan holds the 16
    warps per SM the registers allow (four groups of four), and the 224 px
    stage-3 call still gives half a wave of blocks; the fp32 plan (the
    same kernel on the CUDA cores) fits a block with room for two."""
    plan = wa.tile_plan(64, 49, 32, 24, 1, 2, backward=True)
    resident = min(wa._SM_SMEM // (plan.smem + wa._BLOCK_RESERVED),
                   16 // plan.warps)
    assert plan.warps * resident == 16
    assert 2 * plan.chunks * 24 >= resident * 132
    f32 = wa.tile_plan(1024, 49, 32, 6, 16, 4, backward=True)
    assert f32.smem == wa.tile_smem_bytes(49, 32, 4, f32.warps, True)
    assert 2 * (f32.smem + wa._BLOCK_RESERVED) <= wa._SM_SMEM
