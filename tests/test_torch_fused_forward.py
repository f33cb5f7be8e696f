"""The block-fused forward's split (csrc/fused_block.cu: F1, A1, F2, F3,
F4) on the CPU, as the plain-torch staged model
``esvit_tpu_torch.ops.fused_block.fused_block_fwd_staged``, which rounds
to the compute dtype where the stage kernels do.

- Against ``fused_swin_block_plain`` (the function the CUDA kernels are
  held to on the card): fp32 within 2e-6 of the output's max-abs, or
  within the bound that the products' fp32 accumulation allows if that is
  larger (``_fp32_order_bound``), bf16 within 3e-2, the card's
  tolerance.
- Against ``esvit_tpu``'s ``fused_swin_block`` in interpret mode, fp32:
  the output tolerance of tests/test_torch_fused_block.py (rtol 1e-5,
  atol 2e-5).
- Its attention output ``a`` (A1) and ``qkv`` (F1) bit for bit those of
  the backward's staged model (``fused_block_bwd_staged``), which the
  backward's A1 recomputes on the card.
- The forward's token tiles as the kernels form them, at their height
  (``fwd_token_rows``: 128 rows in bf16, 32 in fp32): every row in exactly
  one tile, only the last one short, tiles across window and image
  boundaries with each tile's pad and drop-path columns the staged
  model's rows; and F2, F3, F4 run tile by tile giving the rows they give
  over the whole input.

Shapes: femto widths, shifted, padded (a 12 px stage in 7 px windows) and
augmented (N=37: 36 tokens and the virtual pad column).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu.ops import fused_block as jfb
from esvit_tpu_torch.ops import fused_block as tfb
from esvit_tpu_torch.ops.fused_block import _ln as fb_ln
from tests.test_torch_fused_staged import (CASES, _case, _stage_params,
                                           _torch_kw, kernel_tiles,
                                           tile_columns)
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def _fp32_order_bound(st, x, p, N, nH, eps=1e-6):
    """How far two fp32 forwards that form the same products in another
    summation order may differ, over the output's max-abs.

    The staged and plain forwards compute the same sums, but through other
    calls: one [q | k | v] product against three, 2-D against 3-D
    operands, strided views against contiguous ones in the attention
    einsums. A BLAS is free to split and order each dot product as it
    chooses (its kernel may depend on state outside the test: its thread
    team, its dispatch), and one run of the whole suite once saw 4.8e-5
    where a run of this file alone sees 0. Any order of a length-K sum
    lies within gamma_K * sum |a_i b_i| of the exact value (gamma_K = K u
    / (1 - K u), u = 2^-24), so two orders differ by at most twice that.
    The block's six products (inner lengths C for q/k/v, hd for the
    scores, N for P V with probabilities summing to 1, C for the
    projection and fc1, 4C for fc2) each add that much to the residual
    stream, taken here at unit gain: the sum of 2 gamma_K max(|A| |B|)
    over the products, at the staged forward's own operands."""
    u = 2.0 ** -24
    C = x.shape[-1]
    hd = C // nH

    def gamma(k):
        return k * u / (1 - k * u)

    xr = x.reshape(-1, C)
    q, k, v = st["qkv"].split(C, dim=-1)
    y = fb_ln(xr, p["g1"], p["be1"], eps)
    y2 = fb_ln(st["x2"], p["g2"], p["be2"], eps)
    wqkv = torch.cat([p["wq"], p["wk"], p["wv"]], dim=1)
    scores = torch.einsum("bnhd,bmhd->bhnm",
                          q.reshape(-1, N, nH, hd).abs() * hd ** -0.5,
                          k.reshape(-1, N, nH, hd).abs())
    terms = [gamma(C) * (y.abs() @ wqkv.abs()).max(),
             gamma(hd) * scores.max(),
             gamma(N) * v.abs().max(),
             gamma(C) * (st["a"].abs() @ p["wp"].abs()).max(),
             gamma(C) * (y2.abs() @ p["w1"].abs()).max(),
             gamma(4 * C) * (st["g"].abs() @ p["w2"].abs()).max()]
    return 2 * sum(t.item() for t in terms) / st["out"].abs().max().item()


def _torch_inputs(x, p, keep, dtype):
    return (torch.from_numpy(x).to(dtype),
            {k: torch.from_numpy(v) for k, v in p.items()},
            [None if k is None else torch.from_numpy(k) for k in keep])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,H,ws,C,nH,shift,padded,dp", CASES)
def test_fwd_staged_matches_plain(B, H, ws, C, nH, shift, padded, dp, dtype,
                                  tol):
    x, p, _, keep, N, nW, region, pad, *_ = _case(B, H, ws, C, nH, shift,
                                                  padded, dp)
    kw = _torch_kw(N, nH, nW, C, region, pad)
    xt, pt, keep = _torch_inputs(x, p, keep, dtype)
    want = tfb.fused_swin_block_plain(xt, pt, *keep, **kw)
    st = tfb.fused_block_fwd_staged(xt, pt, *keep, **kw)
    got = st["out"]
    assert got.shape == xt.shape and got.dtype == dtype
    err = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    if dtype == torch.float32:
        tol = max(tol, _fp32_order_bound(st, xt, pt, N, nH))
    assert err <= tol, err
    rows = B * xt.shape[1]
    for name, width in dict(qkv=3 * C, a=C, x2=C, g=4 * C).items():
        assert st[name].shape == (rows, width) and st[name].dtype == dtype


@pytest.mark.parametrize("B,H,ws,C,nH,shift,padded,dp", [
    CASES[1], CASES[2], CASES[4]])
def test_fwd_staged_fp32_matches_jax_kernel(B, H, ws, C, nH, shift, padded,
                                            dp):
    x, p, _, keep, N, nW, region, pad, pad_p, slots, Lp = _case(
        B, H, ws, C, nH, shift, padded, dp, seed=2)
    sl = jnp.asarray(slots)
    dp_k = tuple(None if k is None else jnp.asarray(np.broadcast_to(
        k[:, None, None], (B, 8, C)).reshape(-1, C)) for k in keep)
    xp = jnp.zeros((B, Lp, C), jnp.float32).at[:, sl, :].set(jnp.asarray(x))
    want = jfb.fused_swin_block(
        xp, {k: jnp.asarray(v) for k, v in p.items()}, *dp_k, N=N, nH=nH,
        nW=nW, scale=(C // nH) ** -0.5, region=region, pad=pad_p, eps=1e-6,
        interpret=True)[:, sl, :]
    xt, pt, keep = _torch_inputs(x, p, keep, torch.float32)
    got = tfb.fused_block_fwd_staged(xt, pt, *keep,
                                     **_torch_kw(N, nH, nW, C, region, pad))
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want),
                               rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("B,H,ws,C,nH,shift,padded,dp", CASES)
def test_fwd_staged_attention_is_the_backward_recompute(B, H, ws, C, nH,
                                                        shift, padded, dp):
    """F1's qkv and A1's a are, bit for bit, what the backward's staged
    model recomputes (its T1 and A1) from the same inputs, in bf16."""
    x, p, do, keep, N, nW, region, pad, *_ = _case(B, H, ws, C, nH, shift,
                                                   padded, dp)
    kw = _torch_kw(N, nH, nW, C, region, pad)
    xt, pt, keep = _torch_inputs(x, p, keep, torch.bfloat16)
    fwd = tfb.fused_block_fwd_staged(xt, pt, *keep, **kw)
    bwd = tfb.fused_block_bwd_staged(xt, pt, *keep,
                                     torch.from_numpy(do).to(torch.bfloat16),
                                     **kw)
    for name in ("qkv", "a", "x2", "g"):
        assert torch.equal(fwd[name], bwd[name]), name


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("B,nW,N,C", [
    (64, 64, 49, 96),      # 224 s0: 200704 rows, whole tiles
    (256, 1, 37, 384),     # the 96 px augmented window: 9472 rows, ragged
    (3, 1, 37, 384),       # 111 rows: one short tile (bf16)
    (3, 9, 16, 96),        # 432 rows: a ragged last tile, windows of 16
    (2, 4, 49, 64),        # 392 rows
])
def test_fwd_token_tiles_cover_rows_across_windows_and_images(B, nW, N, C,
                                                              itemsize):
    """At the forward's tile height: every row in exactly one tile, only
    the last one short; each tile's pad and drop-path columns, read as the
    kernels read them, are the staged model's (_per_row) rows of that
    tile."""
    R = tfb.fwd_token_rows(itemsize)
    assert R == {2: 128, 4: 32}[itemsize]
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
    crossing = 0
    step = max(1, len(tiles) // 512)
    for row0, n in tiles[::step] + tiles[-1:]:
        assert torch.equal(tile_columns(pad, row0, n, L, False),
                           want_pad[row0:row0 + n])
        assert torch.equal(tile_columns(keep, row0, n, L, True),
                           want_keep[row0:row0 + n])
        crossing += (row0 // N != (row0 + n - 1) // N)
    assert crossing > 0 or rows <= N


@pytest.mark.parametrize("B,nW,N,C", [
    (3, 1, 37, 64),
    (3, 9, 16, 96),
    (2, 4, 49, 64),
])
def test_fwd_token_tiles_compute_the_staged_rows(B, nW, N, C):
    """F1-F4 are row-local: run tile by tile over the forward's tiles
    (ragged last tile, tiles across window and image boundaries), with
    each tile's pad and drop-path columns read as the kernels read them,
    stage_t1 (F1), stage_f2, stage_f3 and stage_f4 give the rows they give
    over the whole input (fp32)."""
    rng = np.random.default_rng(2)
    rows, L = B * nW * N, nW * N
    p = _stage_params(rng, C)
    x, a = (torch.from_numpy(rng.normal(size=(rows, C)).astype(np.float32))
            for _ in range(2))
    pad = torch.from_numpy((rng.random(L) < 0.8).astype(np.float32))
    keep1, keep2 = (torch.from_numpy(np.where(rng.random(B) < 0.5, 0.0, 2.0)
                                     .astype(np.float32)) for _ in range(2))
    qkv = tfb.stage_t1(x, p, pad, L, 1e-6)[1]
    x2 = tfb.stage_f2(x, a, p, keep1, L)
    g = tfb.stage_f3(x2, p, 1e-6)
    out = tfb.stage_f4(x2, g, p, keep2, L)
    for row0, n in kernel_tiles(rows, tfb.fwd_token_rows(4)):
        sl = slice(row0, row0 + n)
        # a column of n rows: _per_row reads row r at r % n (pad) or at
        # r // 1 (keep), so it takes the tile's column as it stands
        tq = tfb.stage_t1(x[sl], p, tile_columns(pad, row0, n, L, False), n,
                          1e-6)[1]
        k1, k2 = (tile_columns(k, row0, n, L, True) for k in (keep1, keep2))
        tx2 = tfb.stage_f2(x[sl], a[sl], p, k1, 1)
        tg = tfb.stage_f3(tx2, p, 1e-6)
        tout = tfb.stage_f4(tx2, tg, p, k2, 1)
        for name, got, want in (("qkv", tq, qkv), ("x2", tx2, x2),
                                ("g", tg, g), ("out", tout, out)):
            torch.testing.assert_close(got, want[sl], rtol=1e-5, atol=1e-5,
                                       msg=name)
