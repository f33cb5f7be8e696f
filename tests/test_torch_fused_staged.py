"""The block-fused backward's split (csrc/fused_block.cu: T1, A1, T2, A2,
T3, then the weight GEMMs) on the CPU, as the plain-torch staged model
``esvit_tpu_torch.ops.fused_block.fused_block_bwd_staged``, which rounds
to the compute dtype where the stage kernels do.

- Against autograd through ``fused_swin_block_plain`` (the function the
  CUDA pair is held to on the card): fp32 within 2e-6 of each result's
  max-abs (the same math, sums in another order); bf16 within 3e-2, the
  card's tolerance, since the stages round where the kernels do (dp and
  the LayerNorm gradients stay fp32, autograd rounds them), not where
  autograd does.
- Against ``esvit_tpu``'s ``fused_swin_block`` in interpret mode, fp32:
  the tolerances of tests/test_torch_fused_block.py (every gradient rtol
  1e-4 / atol 1e-5 x the largest gradient).
- The token tiles as the kernels form them (ragged last tile, tiles across
  window and image boundaries): every row in exactly one tile, each tile's
  pad and drop-path columns the staged model's rows, and T1 and T2 run
  tile by tile giving the rows they give over the whole input.

Shapes: femto widths, shifted, padded (a 12 px stage in 7 px windows)
and augmented (N=37: 36 tokens and the virtual pad column).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu.ops import fused_block as jfb
from esvit_tpu_torch.ops import fused_block as tfb
from tests.test_torch_fused_block import NAMES, _augmented_case, _window_case
from tests.torch_threads import one_intra_op_thread  # noqa: F401

CASES = [
    # B, H, ws, C, nH, shift, padded (None: augmented), drop-path
    pytest.param(2, 14, 7, 32, 2, False, False, False, id="plain"),
    pytest.param(2, 14, 7, 32, 2, True, False, True, id="shift"),
    pytest.param(2, 12, 7, 32, 2, True, True, True, id="pad+shift"),
    pytest.param(2, 14, 7, 64, 4, True, False, False, id="multi-head"),
    pytest.param(3, 6, 7, 32, 2, True, None, True, id="augmented"),
]


def _case(B, H, ws, C, nH, shift, padded, dp, seed=0):
    rng = np.random.default_rng(seed)
    if padded is None:
        case = _augmented_case(rng, B, H, ws, C, nH, shift)
    else:
        case = _window_case(rng, B, H, ws, C, nH, shift, padded)
    x, p, N, nW, region, pad, pad_p, slots, Lp = case
    do = rng.normal(size=x.shape).astype(np.float32)
    keep = ((None, None) if not dp else
            tuple(np.where(rng.random(B) < 0.5, 0.0, 2.0).astype(np.float32)
                  for _ in range(2)))
    return x, p, do, keep, N, nW, region, pad, pad_p, slots, Lp


def _torch_kw(N, nH, nW, C, region, pad):
    return dict(N=N, nH=nH, nW=nW, scale=(C // nH) ** -0.5,
                region=None if region is None else torch.from_numpy(region),
                pad=None if pad is None else torch.from_numpy(pad), eps=1e-6)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,H,ws,C,nH,shift,padded,dp", CASES)
def test_staged_matches_plain_autograd(B, H, ws, C, nH, shift, padded, dp,
                                       dtype, tol):
    x, p, do, keep, N, nW, region, pad, *_ = _case(B, H, ws, C, nH, shift,
                                                   padded, dp)
    kw = _torch_kw(N, nH, nW, C, region, pad)
    keep = [None if k is None else torch.from_numpy(k) for k in keep]
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    dout = torch.from_numpy(do).to(dtype)
    out = tfb.fused_swin_block_plain(xt, pt, *keep, **kw)
    want = dict(zip(("x", *NAMES), torch.autograd.grad(
        out, [xt, *(pt[n] for n in NAMES)], dout)))
    st = tfb.fused_block_bwd_staged(xt.detach(), {k: v.detach() for k, v in
                                                  pt.items()}, *keep, dout, **kw)
    got = {"x": st["dx"], **st["grads"]}
    gscale = max(v.float().abs().max().item() for v in want.values())
    for name, b in want.items():
        # dbk's exact value is 0: held at the scale of the largest gradient
        s = gscale if name == "bk" else b.float().abs().max().item()
        err = (got[name].float() - b.float()).abs().max().item() / s
        assert err <= tol, (name, err)
        assert got[name].dtype == (dtype if name == "x" else torch.float32)


@pytest.mark.parametrize("B,H,ws,C,nH,shift,padded,dp", [
    CASES[1], CASES[2], CASES[4]])
def test_staged_fp32_matches_jax_kernel(B, H, ws, C, nH, shift, padded, dp):
    x, p, do, keep, N, nW, region, pad, pad_p, slots, Lp = _case(
        B, H, ws, C, nH, shift, padded, dp, seed=1)
    scale = (C // nH) ** -0.5
    sl = jnp.asarray(slots)
    dp_k = tuple(None if k is None else jnp.asarray(np.broadcast_to(
        k[:, None, None], (B, 8, C)).reshape(-1, C)) for k in keep)

    def f_jax(x, p):
        xp = jnp.zeros((B, Lp, C), jnp.float32).at[:, sl, :].set(x)
        out = jfb.fused_swin_block(xp, p, *dp_k, N=N, nH=nH, nW=nW,
                                   scale=scale, region=region, pad=pad_p,
                                   eps=1e-6, interpret=True)
        return out[:, sl, :]

    _, vjp = jax.vjp(f_jax, jnp.asarray(x), {k: jnp.asarray(v)
                                             for k, v in p.items()})
    j_dx, j_dp = vjp(jnp.asarray(do))
    want = {"x": np.asarray(j_dx), **{k: np.asarray(v) for k, v in j_dp.items()}}
    st = tfb.fused_block_bwd_staged(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        *(None if k is None else torch.from_numpy(k) for k in keep),
        torch.from_numpy(do), **_torch_kw(N, nH, nW, C, region, pad))
    got = {"x": st["dx"].numpy(), **{k: v.numpy()
                                      for k, v in st["grads"].items()}}
    gscale = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-5 * gscale, err_msg=f"d{k}")


@pytest.mark.parametrize("B,H,ws,C,nH,shift,padded,dp", CASES[:3])
def test_stage_outputs_have_the_workspace_shapes(B, H, ws, C, nH, shift,
                                                 padded, dp):
    """Every stage output is a (rows, width) tensor of the kernel's
    scratch: qkv and dqkv 3C wide, g and dh M wide, dx2 fp32, the rest C
    wide in the compute dtype; and qkv's thirds are what the stage
    functions compute from y."""
    x, p, do, keep, N, nW, region, pad, *_ = _case(B, H, ws, C, nH, shift,
                                                   padded, dp)
    dtype = torch.bfloat16
    xt = torch.from_numpy(x).to(dtype)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    st = tfb.fused_block_bwd_staged(
        xt, pt, *(None if k is None else torch.from_numpy(k) for k in keep),
        torch.from_numpy(do).to(dtype), **_torch_kw(N, nH, nW, C, region, pad))
    rows, M = x.shape[0] * x.shape[1], 4 * C
    widths = dict(y=C, qkv=3 * C, a=C, x2=C, y2=C, do2=C, g=M, dh=M, dx2=C,
                  do1=C, da=C, dqkv=3 * C)
    for name, width in widths.items():
        assert st[name].shape == (rows, width), name
        want = torch.float32 if name == "dx2" else dtype
        assert st[name].dtype == want, name
    y, qkv = tfb.stage_t1(xt.reshape(rows, C), pt,
                          None if pad is None else torch.from_numpy(pad),
                          x.shape[1], 1e-6)
    assert torch.equal(qkv, st["qkv"]) and torch.equal(y, st["y"])


def kernel_tiles(rows, R):
    """(row0, n) of each token tile as csrc/fused_block.cu make_tok forms
    them: tile b starts at row b R and takes min(R, rows - row0) rows."""
    return [(b * R, min(R, rows - b * R)) for b in range(-(-rows // R))]


def tile_columns(t, row0, n, L, by_image):
    """A tile's per-row column as the token kernels read it (Tok::keep:
    t[(row0 + r) / L]; Tok::pad: t[(row0 + r) % L])."""
    r = torch.arange(row0, row0 + n)
    return t[r // L if by_image else r % L]


@pytest.mark.parametrize("B,nW,N,C", [
    (64, 64, 49, 96),      # 224 s0: 200704 rows, tiles of 64
    (256, 16, 49, 192),    # 96 s1 padded
    (3, 1, 37, 384),       # the augmented window, tiles of 32, ragged
    (2, 4, 16, 64),
    (2, 4, 49, 64),        # a ragged last tile of 8 rows
    (3, 9, 16, 96),        # a ragged last tile of 48 rows
])
def test_token_tiles_cover_rows_across_windows_and_images(B, nW, N, C):
    """Every row in exactly one tile, only the last one short; each tile's
    pad and drop-path columns, read as the kernels read them, are the
    staged model's (_per_row) rows of that tile."""
    R = tfb.token_rows(C)
    assert R in (32, 64) and tfb.token_rows(C, 4) in (16, 32, 64)
    rows, L = B * nW * N, nW * N
    tiles = kernel_tiles(rows, R)
    assert [r0 for r0, _ in tiles] == list(range(0, rows, R))
    assert all(n == R for _, n in tiles[:-1]) and 0 < tiles[-1][1] <= R
    assert sum(n for _, n in tiles) == rows
    rng = np.random.default_rng(0)
    pad = torch.from_numpy(rng.random(L).astype(np.float32))
    keep = torch.from_numpy(rng.random(B).astype(np.float32))
    want_pad = tfb._per_row(pad, rows, L, False)[:, 0]
    want_keep = tfb._per_row(keep, rows, L, True)[:, 0]
    step = max(1, len(tiles) // 512)
    for row0, n in tiles[::step] + tiles[-1:]:
        assert torch.equal(tile_columns(pad, row0, n, L, False),
                           want_pad[row0:row0 + n])
        assert torch.equal(tile_columns(keep, row0, n, L, True),
                           want_keep[row0:row0 + n])


def _stage_params(rng, C):
    M = 4 * C

    def r(*shape, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32))

    return dict(g1=1 + r(C, s=0.1), be1=r(C, s=0.1),
                wq=r(C, C, s=C ** -0.5), bq=r(C, s=0.02),
                wk=r(C, C, s=C ** -0.5), bk=r(C, s=0.02),
                wv=r(C, C, s=C ** -0.5), bv=r(C, s=0.02),
                wp=r(C, C, s=C ** -0.5), bp=r(C, s=0.02),
                g2=1 + r(C, s=0.1), be2=r(C, s=0.1),
                w1=r(C, M, s=C ** -0.5), b1=r(M, s=0.02),
                w2=r(M, C, s=M ** -0.5), b2=r(C, s=0.02))


@pytest.mark.parametrize("B,nW,N,C", [
    (2, 4, 49, 64),
    (3, 1, 37, 384),
    (3, 9, 16, 96),
])
def test_token_tiles_compute_the_staged_rows(B, nW, N, C):
    """T1 and T2 are row-local: run tile by tile over the kernels' tiles
    (ragged last tile, tiles across window and image boundaries), with
    each tile's pad and drop-path columns read as the kernels read them,
    stage_t1 and stage_t2 give the rows they give over the whole input
    (fp32; the vector gradients are sums of the tiles' partials)."""
    rng = np.random.default_rng(1)
    rows, L = B * nW * N, nW * N
    p = _stage_params(rng, C)
    x, a, do = (torch.from_numpy(rng.normal(size=(rows, C)).astype(np.float32))
                for _ in range(3))
    pad = torch.from_numpy((rng.random(L) < 0.8).astype(np.float32))
    keep1, keep2 = (torch.from_numpy(np.where(rng.random(B) < 0.5, 0.0, 2.0)
                                     .astype(np.float32)) for _ in range(2))
    y, qkv = tfb.stage_t1(x, p, pad, L, 1e-6)
    t2 = tfb.stage_t2(x, a, do, p, keep1, keep2, L, 1e-6)
    vectors = ("db1", "db2", "dg2", "dbe2", "dbp")
    sums = {k: torch.zeros_like(t2[k]) for k in vectors}
    for row0, n in kernel_tiles(rows, tfb.token_rows(C)):
        sl = slice(row0, row0 + n)
        # a column of n rows: _per_row reads row r at r % n (pad) or at
        # r // 1 (keep), so it takes the tile's column as it stands
        ty, tqkv = tfb.stage_t1(x[sl], p, tile_columns(pad, row0, n, L, False),
                                n, 1e-6)
        torch.testing.assert_close(ty, y[sl], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(tqkv, qkv[sl], rtol=1e-5, atol=1e-5)
        k1, k2 = (tile_columns(k, row0, n, L, True) for k in (keep1, keep2))
        tt = tfb.stage_t2(x[sl], a[sl], do[sl], p, k1, k2, 1, 1e-6)
        for name in ("x2", "y2", "do2", "g", "dh", "dx2", "do1", "da"):
            torch.testing.assert_close(tt[name], t2[name][sl], rtol=1e-5,
                                       atol=1e-5, msg=name)
        for k in vectors:
            sums[k] += tt[k]
    for k in vectors:
        torch.testing.assert_close(sums[k], t2[k], rtol=1e-4, atol=1e-4,
                                   msg=k)
