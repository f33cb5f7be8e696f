"""The port's CUDA kernels against their plain versions.

Needs an NVIDIA GPU with nvcc (the kernels build from csrc/ at first use);
every test here is marked ``cuda`` and skips without a card. Run on one
with ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``. This
file imports no jax, so it runs where only torch is installed.

Tolerances: fp32 2e-5 and bf16 3e-2 (tests/test_packed_window_attention.py
:52), each gradient normalised by its max-abs. dbias must be
bit-identical when run twice: the kernel sums its partials in a fixed
order.
"""

import numpy as np
import pytest
import torch

from esvit_tpu_torch.ops import window as wops
from esvit_tpu_torch.ops import window_attention as wa

# (N(ws^2), nH, n_windows, B, shifted, H, W, ws, ss), as the JAX kernel's tests
CASES = [
    (16, 2, 4, 2, False, 8, 8, 4, 0),
    (16, 2, 4, 2, True, 8, 8, 4, 2),
    (49, 3, 16, 1, True, 28, 28, 7, 3),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain(cuda, case, dtype, tol):
    N, nH, nW, B, shifted, H, W, ws, ss = case
    C = nH * 32
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(B * nW * N, C).astype(np.float32)
                   for _ in range(4))
    bias = (0.3 * rng.randn(nH, N, N)).astype(np.float32)
    region = (torch.as_tensor(wops.window_region_ids(H, W, ws, ss),
                              device=cuda) if shifted else None)

    def run(fn):
        ts = [torch.tensor(a, device=cuda, dtype=t).requires_grad_()
              for a, t in zip((q, k, v, bias), (dtype,) * 3 + (torch.float32,))]
        out = fn(*ts, region, N, nH, 32 ** -0.5)
        out.backward(torch.tensor(do, device=cuda, dtype=dtype))
        return [out.detach().float().cpu()] + [t.grad.float().cpu() for t in ts]

    got = run(wa._WindowAttention.apply)
    again = run(wa._WindowAttention.apply)
    ref = run(wa.window_attention_plain)
    torch.testing.assert_close(got[4], again[4], rtol=0, atol=0)
    for name, a, b in zip(["out", "dq", "dk", "dv", "dbias"], got, ref):
        s = max(b.abs().max().item(), 1e-6)
        torch.testing.assert_close(a / s, b / s, rtol=tol, atol=tol, msg=name)


# Shapes the forward's tiles can get wrong: (N, C, nH, windows B_, window
# types nW (0: unshifted), element offset of q/k/v's base). N below 49
# (16, 36) and N = 64 (the largest tile); a head dim not a multiple of 16
# (24 zero-filled to 32; 10, whose 40-byte rows take the narrow loads);
# window counts that are not a multiple of a block's windows; a base 2 or
# 4 bytes off 16-byte alignment. Region ids are random per window type.
TILE_CASES = [
    (16, 64, 2, 12, 4, 0),
    (36, 48, 2, 8, 2, 0),
    (64, 128, 2, 3, 0, 0),
    (49, 96, 3, 37, 0, 0),
    (49, 96, 3, 40, 8, 0),
    (49, 20, 2, 6, 2, 0),
    (49, 96, 3, 8, 0, 1),
    (37, 64, 2, 9, 3, 0),
    (64, 128, 4, 20, 4, 1),
]
# Rows 3-4 on the large-window tile (64 < N <= 256, head dim 32): Swin-B's
# W=14 stage 0 over 4 window types, its stage 2 width (one window type),
# the augmented window's size N=145 (a run of windows that does not fill a
# block's), and a base 2 or 4 bytes off 16-byte alignment. Appended, so
# earlier case ids stay.
TILE_CASES = TILE_CASES + [
    (196, 128, 4, 12, 4, 0),
    (196, 512, 16, 3, 0, 0),
    (145, 256, 8, 5, 0, 0),
    (196, 128, 4, 9, 0, 1),
]
# The large tile's key blocks of 64: N=65 and 129, one key past a block
# (head dims 5 and 32), N=100 over three window types, N=196 at head dim
# 64 (the KD=4 kernels, the bias slice in device memory), N=100 at head
# dim 64 (KD=4 with the slice staged) and N=256 (never staged). Appended.
TILE_CASES = TILE_CASES + [
    (65, 10, 2, 7, 0, 0),
    (129, 64, 2, 6, 3, 0),
    (100, 96, 3, 6, 3, 0),
    (196, 128, 2, 4, 2, 0),
    (256, 64, 2, 3, 0, 0),
    (100, 128, 2, 4, 2, 0),
]


def _offset_tensor(a, dtype, cuda, offset):
    """a on the card, contiguous, its data `offset` elements past an
    allocation's (16-byte aligned) start."""
    flat = torch.empty(a.size + offset, device=cuda, dtype=dtype)
    t = flat[offset:].view(a.shape)
    t.copy_(torch.as_tensor(a))
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", TILE_CASES)
def test_cuda_kernel_tile_shapes_match_plain(cuda, case, dtype, tol):
    N, C, nH, B_, nW, offset = case
    rng = np.random.RandomState(1)
    q, k, v, do = (rng.randn(B_ * N, C).astype(np.float32) for _ in range(4))
    bias = (0.3 * rng.randn(nH, N, N)).astype(np.float32)
    region = (torch.as_tensor(rng.randint(0, 3, size=(nW, N)).astype(np.int32),
                              device=cuda) if nW else None)
    scale = (C // nH) ** -0.5

    def run(fn):
        ts = [_offset_tensor(a, dtype, cuda, offset).requires_grad_()
              for a in (q, k, v)]
        b = torch.tensor(bias, device=cuda).requires_grad_()
        out = fn(*ts, b, region, N, nH, scale)
        out.backward(torch.tensor(do, device=cuda, dtype=dtype))
        return [out.detach().float().cpu()] + [t.grad.float().cpu()
                                               for t in (*ts, b)]

    before = dict(wa.launches)
    got = run(wa._WindowAttention.apply)
    assert wa.launches == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    again = run(wa._WindowAttention.apply)
    ref = run(wa.window_attention_plain)
    for name, a, b, c in zip(["out", "dq", "dk", "dv", "dbias"], got, again,
                             ref):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
        s = max(c.abs().max().item(), 1e-6)
        torch.testing.assert_close(a / s, c / s, rtol=tol, atol=tol, msg=name)


@pytest.mark.cuda
def test_cuda_tile_plan_fits_the_card(cuda):
    """tile_smem_bytes is the kernels' own count (wtile::smem_bytes, and
    bwd_smem_bytes for the backward), and every plan
    of a shape supports() admits fits a block."""
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = wa._lib()
    counts = {False: lib.esvit_window_attention_tile_smem_bytes,
              True: lib.esvit_window_attention_bwd_smem_bytes}
    for N in range(1, 65):
        for hd in range(1, 65):
            for itemsize in (2, 4):
                for backward, count in counts.items():
                    for warps in range(1, 9):
                        assert (count(N, hd, itemsize, warps)
                                == wa.tile_smem_bytes(N, hd, itemsize, warps,
                                                      backward))
                    plan = wa.tile_plan(8, N, hd, 1, 1, itemsize,
                                        backward=backward)
                    assert plan.smem <= limit, (N, hd, itemsize, plan)


@pytest.mark.cuda
def test_cuda_large_tile_plan_fits_the_card(cuda):
    """The large-window tile (64 < N <= 256): tile_smem_bytes is the
    kernels' own count (wtile::large_smem_bytes, large_bwd_smem_bytes),
    and every plan of a window and head dim that large_tile_fits admits
    fits a block, in both passes and both dtypes."""
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = wa._lib()
    counts = {False: lib.esvit_window_attention_tile_smem_bytes,
              True: lib.esvit_window_attention_bwd_smem_bytes}
    for N in range(65, 257):
        for hd in (1, 5, 16, 24, 32, 48, 64):
            for itemsize in (2, 4):
                for backward, count in counts.items():
                    for warps in range(1, wa._LARGE_MAX_WARPS + 1):
                        assert (count(N, hd, itemsize, warps)
                                == wa.tile_smem_bytes(N, hd, itemsize, warps,
                                                      backward))
                    if wa.large_tile_fits(N, hd, backward):
                        plan = wa.tile_plan(64, N, hd, 3, 1, itemsize,
                                            backward=backward)
                        assert plan.smem <= limit, (N, hd, itemsize, plan)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(49 * 2, 96, device=cuda, dtype=torch.float16)
    bias = torch.zeros(3, 49, 49, device=cuda)
    with pytest.raises(TypeError):
        wa.window_attention(q, q, q, bias, None, 49, 3, 0.17)
    q = torch.zeros(49 * 2, 192, device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        wa.window_attention(q, q, q, bias, None, 49, 3, 0.17)
    # more tokens than the large-window tile holds
    q = torch.zeros(257 * 2, 96, device=cuda)
    with pytest.raises(ValueError):
        wa.window_attention(q, q, q, torch.zeros(3, 257, 257, device=cuda),
                            None, 257, 3, 0.17)


# The block-fused kernel pair (ops/fused_block.py) against its plain
# version: (B, H, ws, C, nH, shifted, spatially padded, drop-path). C and nH
# keep the head dim at 32 as in Swin-T; the last case is a stage-2 width.
FUSED_CASES = [
    (2, 14, 7, 64, 2, False, False, False),
    (2, 14, 7, 64, 2, True, False, True),
    (2, 12, 7, 64, 2, True, True, False),
    (2, 7, 7, 384, 12, False, False, True),
]
# Swin at W=14 on the large-window tile (N = 196): a shifted stage of four
# windows an image, a padded one (24 -> 28 tokens a side) and a stage-2
# width of one window an image. Appended to every fused list, so earlier
# case ids stay.
W14_FUSED_CASES = [
    (2, 28, 14, 96, 3, True, False, True),
    (2, 24, 14, 96, 3, True, True, False),
    (3, 14, 14, 384, 12, False, False, True),
]
# Swin-S / Swin-B's stage 2 width (C=512, 16 heads, M=2048): W=7's N=49,
# unshifted and shifted, and W=14's N=196 (one window an image).
# Appended to every fused list, so earlier case ids stay.
C512_FUSED_CASES = [
    (2, 14, 7, 512, 16, False, False, False),
    (2, 14, 7, 512, 16, True, False, True),
    (2, 14, 14, 512, 16, False, False, True),
]
# The large tile's other instances under the fused block's policy: W=14
# at head dim 64 (C=128, 2 heads: KD=4, the bias slice in device
# memory), W=10 at head dim 64 (N=100: KD=4, staged) and W=16 (N=256,
# never staged). Appended.
LARGE_FUSED_CASES = [
    (2, 14, 14, 128, 2, True, False, False),
    (2, 20, 10, 128, 2, True, False, False),
    (2, 16, 16, 64, 2, False, False, True),
]
FUSED_CASES = FUSED_CASES + W14_FUSED_CASES + C512_FUSED_CASES + LARGE_FUSED_CASES


def _fused_inputs(cuda, B, H, ws, C, nH, shifted, padded, dp, seed=0):
    rng = np.random.RandomState(seed)
    Hp = -(-H // ws) * ws
    N, nW, M = ws * ws, (Hp // ws) ** 2, 4 * C
    ss = ws // 2 if shifted else 0
    x = (0.5 * rng.randn(B, nW * N, C)).astype(np.float32)
    p = _fused_params(rng, C, M, nH, N)
    keep = None
    if dp:
        keep = [np.where(np.arange(B) == i, 0.0, 1 / 0.9).astype(np.float32)
                for i in (0, B - 1)]
    region = (torch.as_tensor(wops.window_region_ids(H, H, ws, ss),
                              device=cuda) if shifted else None)
    pad = (torch.as_tensor(wops.pad_token_mask(H, H, Hp, Hp, ws, ss),
                           device=cuda) if padded else None)
    kw = dict(N=N, nH=nH, nW=nW, scale=(C // nH) ** -0.5, region=region,
              pad=pad, eps=1e-6)
    return x, p, keep, kw


def _fused_params(rng, C, M, nH, N):
    return {k: v.astype(np.float32) for k, v in dict(
        g1=1 + 0.1 * rng.randn(C), be1=0.1 * rng.randn(C),
        wq=rng.randn(C, C) * C ** -0.5, bq=0.02 * rng.randn(C),
        wk=rng.randn(C, C) * C ** -0.5, bk=0.02 * rng.randn(C),
        wv=rng.randn(C, C) * C ** -0.5, bv=0.02 * rng.randn(C),
        bias=0.05 * rng.randn(nH, N, N),
        wp=rng.randn(C, C) * C ** -0.5, bp=0.02 * rng.randn(C),
        g2=1 + 0.1 * rng.randn(C), be2=0.1 * rng.randn(C),
        w1=rng.randn(C, M) * C ** -0.5, b1=0.02 * rng.randn(M),
        w2=rng.randn(M, C) * M ** -0.5, b2=0.02 * rng.randn(C)).items()}


def _fused_scale(ref, name):
    """What a result is normalised by: its own max-abs, except dbk. The key
    bias adds the same q.b_k to every score of a row, which softmax
    ignores, so its exact gradient is 0 and both sides are rounding noise:
    it is held at the scale of the largest gradient, as
    tests/test_fused_block.py:156 holds every gradient."""
    if name == "dbk":
        return max(v.abs().max().item() for k, v in ref.items() if k != "out")
    return max(ref[name].abs().max().item(), 1e-6)


def _fused_run(fn, cuda, dtype, x, p, keep, kw, dout):
    xt = torch.tensor(x, device=cuda, dtype=dtype).requires_grad_()
    pt = {k: torch.tensor(v, device=cuda).requires_grad_() for k, v in p.items()}
    k1, k2 = ((None, None) if keep is None
              else [torch.tensor(k, device=cuda) for k in keep])
    out = fn(xt, pt, k1, k2, **kw)
    out.backward(torch.tensor(dout, device=cuda, dtype=dtype))
    grads = {"out": out.detach(), "dx": xt.grad}
    grads.update({f"d{k}": t.grad for k, t in pt.items()})
    return {k: v.float().cpu() for k, v in grads.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_cuda_fused_block_matches_plain(cuda, case, dtype, tol):
    from esvit_tpu_torch.ops import fused_block as fb

    x, p, keep, kw = _fused_inputs(cuda, *case)
    dout = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    before = dict(fb.launches)
    got = _fused_run(fb.fused_swin_block, cuda, dtype, x, p, keep, kw, dout)
    assert fb.launches == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    again = _fused_run(fb.fused_swin_block, cuda, dtype, x, p, keep, kw, dout)
    ref = _fused_run(fb.fused_swin_block_plain, cuda, dtype, x, p, keep, kw,
                     dout)
    for name, a in got.items():
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, again[name], rtol=0, atol=0, msg=name)
        s = _fused_scale(ref, name)
        torch.testing.assert_close(a / s, ref[name] / s, rtol=tol, atol=tol,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_cuda_fused_block_augmented_window(cuda, dtype, tol):
    """The 96px stage-2 route: one augmented window of 6x6 real tokens plus
    the virtual pad token (pad multiplier 0 on its row), N = 37."""
    _augmented_window_case(cuda, dtype, tol, 4, 384, 12, 37)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_cuda_fused_block_large_augmented_window(cuda, dtype, tol):
    """W=14's 96 px stage-1 route on the large-window tile: one augmented
    window of 12x12 real tokens plus the virtual one, N = 145."""
    _augmented_window_case(cuda, dtype, tol, 4, 192, 6, 145)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("N", [37, 145])
def test_cuda_fused_block_c512_augmented_window(cuda, dtype, tol, N):
    """C=512 (Swin-B's stage 2) on the augmented windows: 6x6 + 1 (its 96
    px route, the small tile) and 12x12 + 1 (the large one)."""
    _augmented_window_case(cuda, dtype, tol, 4, 512, 16, N)


def _augmented_window_case(cuda, dtype, tol, B, C, nH, N):
    from esvit_tpu_torch.ops import fused_block as fb

    rng = np.random.RandomState(2)
    x = (0.5 * rng.randn(B, N, C)).astype(np.float32)
    x[:, -1] = 0.0
    p = _fused_params(rng, C, 4 * C, nH, N)
    p["bias"][:, -1, :] = 0.0
    pad = torch.ones(N, device=cuda)
    pad[-1] = 0.0
    kw = dict(N=N, nH=nH, nW=1, scale=(C // nH) ** -0.5, region=None,
              pad=pad, eps=1e-6)
    dout = rng.randn(*x.shape).astype(np.float32)
    dout[:, -1] = 0.0
    keep = [np.array([1 / 0.9, 0.0, 1 / 0.9, 1 / 0.9], np.float32)] * 2
    got = _fused_run(fb.fused_swin_block, cuda, dtype, x, p, keep, kw, dout)
    again = _fused_run(fb.fused_swin_block, cuda, dtype, x, p, keep, kw, dout)
    ref = _fused_run(fb.fused_swin_block_plain, cuda, dtype, x, p, keep, kw,
                     dout)
    for name, a in got.items():
        torch.testing.assert_close(a, again[name], rtol=0, atol=0, msg=name)
        s = _fused_scale(ref, name)
        torch.testing.assert_close(a / s, ref[name] / s, rtol=tol, atol=tol,
                                   msg=name)


# The backward's split (T1, A1, T2, A2, T3): (B, H, ws, C, nH, shifted,
# padded, drop-path). N 16 over 9 window types with 432 rows (a ragged last
# token tile of 48), N 64 (the largest window tile), Swin's 49 at C=384
# (32-row token tiles, 882 rows) and a padded stage.
FUSED_STAGE_CASES = [
    (3, 12, 4, 64, 2, True, False, True),
    (2, 16, 8, 128, 4, True, False, False),
    (2, 21, 7, 384, 12, True, False, True),
    (3, 10, 7, 96, 3, True, True, False),
]
# The learning gate's nano Swin (W=4): stage 0 at 64 px (C=32, head dim
# 16), stage 1 at 32 px (one window, shifted), stage 2 at 64 px (head dim
# 32). Appended to the lists below, so earlier case ids stay.
NANO_FUSED_CASES = [
    (2, 16, 4, 32, 2, True, False, True),
    (3, 4, 4, 64, 4, True, False, False),
    (2, 4, 4, 128, 4, False, False, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", FUSED_STAGE_CASES + NANO_FUSED_CASES
                         + W14_FUSED_CASES + C512_FUSED_CASES)
def test_cuda_fused_backward_stages_match_plain(cuda, case, dtype, tol):
    """All 19 results within tol of the plain version and bit-identical on
    repeat; each stage kernel within tol of its plain twin on its own
    inputs (ops/fused_block.py bwd_stage_errors)."""
    from esvit_tpu_torch.ops import fused_block as fb

    x, p, keep, kw = _fused_inputs(cuda, *case, seed=3)
    dout = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    got = _fused_run(fb.fused_swin_block, cuda, dtype, x, p, keep, kw, dout)
    again = _fused_run(fb.fused_swin_block, cuda, dtype, x, p, keep, kw, dout)
    ref = _fused_run(fb.fused_swin_block_plain, cuda, dtype, x, p, keep, kw,
                     dout)
    for name, a in got.items():
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, again[name], rtol=0, atol=0, msg=name)
        s = _fused_scale(ref, name)
        torch.testing.assert_close(a / s, ref[name] / s, rtol=tol, atol=tol,
                                   msg=name)
    k1, k2 = ((None, None) if keep is None
              else [torch.tensor(k, device=cuda) for k in keep])
    errs = fb.bwd_stage_errors(
        torch.tensor(x, device=cuda, dtype=dtype),
        {k: torch.tensor(v, device=cuda) for k, v in p.items()}, k1, k2,
        torch.tensor(dout, device=cuda, dtype=dtype), **kw)
    assert max(errs.values()) <= tol, errs


# The forward's split (F1, A1, F2, F3, F4) at the backward's stage cases
# and three more: rows 432, 512, 882 and 588 in tiles of 128 (bf16) or 32
# (fp32), so ragged last tiles and whole ones, tiles across windows and
# images; then a single 7x7 window per image (3 images, one short tile),
# a 384-wide stage whose column tiles split over the grid one per block,
# and one with 66 row tiles, whose column tiles split over 6 blocks on a
# 132-SM card, several a block (the epilogue's bias slots in turn).
FUSED_FWD_CASES = FUSED_STAGE_CASES + [
    (3, 6, 7, 96, 3, False, False, True),
    (4, 14, 7, 384, 12, False, False, False),
    (43, 14, 7, 384, 12, True, False, True),
] + NANO_FUSED_CASES + W14_FUSED_CASES + C512_FUSED_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", FUSED_FWD_CASES)
def test_cuda_fused_forward_stages_match_plain(cuda, case, dtype, tol):
    """Each forward stage kernel within tol of its plain twin on its own
    inputs (ops/fused_block.py fwd_stage_errors); the output within tol of
    fused_swin_block_plain and bit-identical on repeat; one launch per
    forward call."""
    from esvit_tpu_torch.ops import fused_block as fb

    x, p, keep, kw = _fused_inputs(cuda, *case, seed=5)
    xt = torch.tensor(x, device=cuda, dtype=dtype)
    pt = {k: torch.tensor(v, device=cuda) for k, v in p.items()}
    k1, k2 = ((None, None) if keep is None
              else [torch.tensor(k, device=cuda) for k in keep])
    errs = fb.fwd_stage_errors(xt, pt, k1, k2, **kw)
    assert set(errs) == {"qkv", "a", "x2", "g", "out"}
    assert max(errs.values()) <= tol, errs
    before = fb.launches["fwd"]
    with torch.no_grad():
        a = fb.fused_swin_block(xt, pt, k1, k2, **kw)
        b = fb.fused_swin_block(xt, pt, k1, k2, **kw)
        ref = fb.fused_swin_block_plain(xt, pt, k1, k2, **kw)
    assert fb.launches["fwd"] == before + 2
    assert torch.isfinite(a).all() and torch.equal(a, b)
    s = ref.float().abs().max()
    torch.testing.assert_close(a.float() / s, ref.float() / s, rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_cuda_fused_forward_refuses_what_the_kernels_do_not_take(cuda):
    """The forward wrapper refuses CPU tensors, a dtype the kernels have no
    instantiation for, and widths the token tiles do not take (C not a
    multiple of 32, M not of 128)."""
    from esvit_tpu_torch.ops import fused_block as fb

    x, p, keep, kw = _fused_inputs(cuda, 2, 14, 7, 64, 2, False, False, False)
    pt = {k: torch.tensor(v, device=cuda) for k, v in p.items()}
    geo = (kw["N"], kw["nH"], kw["nW"], kw["scale"], kw["eps"])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fb._fwd(torch.tensor(x), {k: v.cpu() for k, v in pt.items()}, None,
                None, None, None, geo)
    with pytest.raises(TypeError):
        fb._fwd(torch.tensor(x, device=cuda, dtype=torch.float16), pt, None,
                None, None, None, geo)
    x48, p48, _, kw48 = _fused_inputs(cuda, 2, 14, 7, 48, 2, False, False,
                                      False)
    with pytest.raises(ValueError, match="unsupported block shape"):
        fb._fwd(torch.tensor(x48, device=cuda),
                {k: torch.tensor(v, device=cuda) for k, v in p48.items()},
                None, None, None, None,
                (kw48["N"], 2, kw48["nW"], kw48["scale"], 1e-6))
    p_m = dict(pt, w1=pt["w1"][:, :192], b1=pt["b1"][:192],
               w2=pt["w2"][:192])
    with pytest.raises(ValueError, match="unsupported block shape"):
        fb._fwd(torch.tensor(x, device=cuda), p_m, None, None, None, None,
                geo)


@pytest.mark.cuda
def test_cuda_fused_forward_token_tiles_fit_the_card(cuda):
    """The forward's token-tile blocks (F1-F4) fit a block at every
    admitted width, bf16 and fp32."""
    from esvit_tpu_torch.ops import fused_block as fb

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = fb._lib()
    for C in range(32, fb._MAX_C + 1, 32):
        for itemsize in (2, 4):
            assert lib.esvit_fused_block_fwd_smem_bytes(
                C, 4 * C, itemsize) <= limit, (C, itemsize)


@pytest.mark.cuda
def test_cuda_fused_backward_token_tiles_fit_the_card(cuda):
    """The backward's token-tile blocks (T1, T2, T3) at the rows
    token_rows gives every admitted width fit a block."""
    from esvit_tpu_torch.ops import fused_block as fb

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = fb._lib()
    for C in range(32, fb._MAX_C + 1, 32):
        for itemsize in (2, 4):
            assert lib.esvit_fused_block_bwd_smem_bytes(
                C, fb.token_rows(C, itemsize), itemsize) <= limit, (C, itemsize)


@pytest.mark.cuda
def test_cuda_fused_block_refuses_what_the_kernel_does_not_take(cuda):
    from esvit_tpu_torch.ops import fused_block as fb

    x, p, keep, kw = _fused_inputs(cuda, 2, 14, 7, 64, 2, False, False, False)
    pt = {k: torch.tensor(v, device=cuda) for k, v in p.items()}
    with pytest.raises(TypeError):
        fb.fused_swin_block(torch.tensor(x, device=cuda, dtype=torch.float16),
                            pt, None, None, **kw)
    with pytest.raises(ValueError):
        fb.fused_swin_block(torch.tensor(x, device=cuda), pt, None, None,
                            **dict(kw, nH=8))
    # more tokens than the large-window tile holds
    N, C, nH = 257, 96, 3
    p257 = {k: torch.tensor(v, device=cuda) for k, v in _fused_params(
        np.random.RandomState(0), C, 4 * C, nH, N).items()}
    with pytest.raises(ValueError, match="unsupported block shape"):
        fb.fused_swin_block(torch.zeros(1, N, C, device=cuda), p257, None,
                            None, N=N, nH=nH, nW=1, scale=0.17)


# The sliding-chunk kernel pair (ops/sliding_chunk.py) against its plain
# version: (BH, nx, ny, nglo, W, M). The ViL-T shapes at a small BH (224
# and 96 px, stages 0-1: 8x8, 4x4, 4x4 padded and 2x2 padded chunks),
# then a rectangular grid, no globals, 8 globals and the largest tile
# the shape rule admits.
SC_CASES = [
    (2, 56, 56, 1, 7, 48),
    (3, 28, 28, 1, 7, 32),
    (2, 24, 24, 1, 7, 48),
    (3, 12, 12, 1, 7, 32),
    (2, 21, 10, 1, 7, 16),
    (2, 14, 14, 0, 7, 32),
    (2, 16, 16, 8, 4, 24),
    (1, 20, 20, 3, 8, 64),
    # The learning gate's nano ViL (W=4, head dim 16: KD = 1).
    (2, 16, 16, 1, 4, 16),
    (4, 4, 4, 1, 4, 16),
]


def _sc_run(fn, cuda, dtype, arrays, dout, nx, ny, W):
    ts = [torch.tensor(a, device=cuda, dtype=dtype).requires_grad_()
          for a in arrays]
    out = fn(*ts, nx=nx, ny=ny, W=W)
    out.backward(torch.tensor(dout, device=cuda, dtype=dtype))
    return [out.detach().float().cpu()] + [t.grad.float().cpu() for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", SC_CASES)
def test_cuda_sliding_chunk_matches_plain(cuda, case, dtype, tol):
    from esvit_tpu_torch.ops import sliding_chunk as sc

    BH, nx, ny, nglo, W, M = case
    rng = np.random.RandomState(0)
    grid = (BH, nx, ny, M)
    arrays = [rng.randn(*grid).astype(np.float32) * M ** -0.5,
              rng.randn(*grid).astype(np.float32),
              rng.randn(*grid).astype(np.float32),
              rng.randn(BH, nglo, M).astype(np.float32),
              rng.randn(BH, nglo, M).astype(np.float32)]
    dout = rng.randn(*grid).astype(np.float32)
    before = dict(sc.launches)
    got = _sc_run(sc.sliding_chunk_attention, cuda, dtype, arrays, dout, nx,
                  ny, W)
    assert sc.launches == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    again = _sc_run(sc.sliding_chunk_attention, cuda, dtype, arrays, dout,
                    nx, ny, W)
    ref = _sc_run(sc.sliding_chunk_attention_plain, cuda, dtype, arrays, dout,
                  nx, ny, W)
    for name, a, b, c in zip(["out", "dq", "dk", "dv", "dkg", "dvg"], got,
                             again, ref):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
        s = max(c.abs().max().item(), 1e-6) if c.numel() else 1.0
        torch.testing.assert_close(a / s, c / s, rtol=tol, atol=tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", SC_CASES)
def test_cuda_sliding_chunk_kernels_match_their_twins(cuda, case, dtype, tol):
    """Each kernel (forward, bwd_q, bwd_k, the globals' reduce) against its
    staged twin on its own inputs, and every output and scratch buffer
    bit-identical when the pair runs twice."""
    from esvit_tpu_torch.ops import sliding_chunk as sc

    BH, nx, ny, nglo, W, M = case
    rng = np.random.RandomState(1)
    grid = (BH, nx, ny, M)
    ins = [torch.tensor(a, device=cuda, dtype=dtype) for a in (
        rng.randn(*grid).astype(np.float32) * M ** -0.5,
        rng.randn(*grid).astype(np.float32),
        rng.randn(*grid).astype(np.float32),
        rng.randn(BH, nglo, M).astype(np.float32),
        rng.randn(BH, nglo, M).astype(np.float32))]
    do = torch.tensor(rng.randn(*grid).astype(np.float32), device=cuda,
                      dtype=dtype)
    errs = sc.stage_errors(*ins, do, nx=nx, ny=ny, W=W)
    assert len(errs) == (10 if nglo else 7)
    assert max(errs.values()) <= tol, errs

    def run():
        out, stats = sc._fwd(*ins, nx, ny, W)
        grads, scratch = sc._bwd_buffers(*ins, stats, do, nx, ny, W)
        return [out, stats, *grads, scratch["rsum"], scratch["partial"]]

    for a, b in zip(run(), run()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_sliding_chunk_smem_mirror(cuda):
    """ops/sliding_chunk.py kernel_smem_bytes equals each kernel's own
    count at every admitted shape, in both dtypes; the bf16 kernels at
    ViL-T's shapes leave room for five blocks per SM."""
    from esvit_tpu_torch.ops import sliding_chunk as sc

    lib = sc._lib()
    for W in range(1, 9):
        for M in range(8, 65, 8):
            for nglo in range(9):
                for dtype, itemsize in ((0, 4), (1, 2)):
                    mirror = sc.kernel_smem_bytes(W, M, nglo, itemsize)
                    for which, name in enumerate(("fwd", "bwd_q", "bwd_k")):
                        assert lib.esvit_sliding_chunk_kernel_smem_bytes(
                            W, M, nglo, dtype, which) == mirror[name]
    for M in (48, 32):
        assert 5 * (max(sc.kernel_smem_bytes(7, M, 1, 2).values()) + 1024) \
            <= 233472


@pytest.mark.cuda
def test_cuda_sliding_chunk_refuses_what_the_kernel_does_not_take(cuda):
    from esvit_tpu_torch.ops import sliding_chunk as sc

    q = torch.zeros(2, 14, 14, 32, device=cuda, dtype=torch.float16)
    g = torch.zeros(2, 1, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        sc.sliding_chunk_attention(q, q, q, g, g, nx=14, ny=14, W=7)
    q = torch.zeros(2, 14, 14, 36, device=cuda)
    g = torch.zeros(2, 1, 36, device=cuda)
    with pytest.raises(ValueError):
        sc.sliding_chunk_attention(q, q, q, g, g, nx=14, ny=14, W=7)


@pytest.mark.cuda
def test_cuda_sliding_chunk_shape_rule_fits_the_card(cuda):
    """Every shape supports() admits fits a block's shared memory."""
    from esvit_tpu_torch.ops import sliding_chunk as sc

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = sc._lib()
    for W in range(1, 9):
        for M in range(8, 65, 8):
            for nglo in range(9):
                assert sc.supports(W, M, nglo)
                assert lib.esvit_sliding_chunk_smem_bytes(W, M, nglo) <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("kw,mode,launched", [
    ({"rpe": True}, 0, False), ({}, 3, False), ({"exact": 1}, 0, False),
    ({}, 0, True)])
def test_cuda_vil_layer_routes_by_its_options(cuda, kw, mode, launched):
    """A ViL-T stage-1 sliding-chunk layer (dim 96, 3 heads, W=7, one
    global token, 14 x 14) in fp32 on the card: with rpe, a sampled mode
    or exact=1 it launches no sliding-chunk kernel and matches its plain
    version (the same layer on the CPU); at mode 0 with none of them it
    launches the forward and the backward once each and matches the
    fused_sc='off' layer within 2e-5 of each result's max-abs."""
    import copy

    from esvit_tpu_torch.models.vil_layers import Long2DSCAttention
    from esvit_tpu_torch.ops import sliding_chunk as sc

    layer = Long2DSCAttention(96, 3, 7, 1, generator=torch.Generator()
                              .manual_seed(0), **kw)
    ref = copy.deepcopy(layer)
    ref.fused_sc = "off"
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 1 + 14 * 14, 96, generator=gen)
    dout = torch.randn(x.shape, generator=gen)

    def run(mod, dev):
        mod = mod.to(dev)
        xt = x.to(dev).requires_grad_()
        out = mod(xt, 14, 14, mode=mode)
        out.backward(dout.to(dev))
        return [out.detach().cpu(), xt.grad.cpu()] + [
            p.grad.cpu() for p in mod.parameters()]

    sc.launches.update(fwd=0, bwd=0)
    got = run(layer, cuda)
    torch.cuda.synchronize()
    assert sc.launches == ({"fwd": 1, "bwd": 1} if launched
                           else {"fwd": 0, "bwd": 0})
    want = run(ref, cuda if launched else torch.device("cpu"))
    for a, b in zip(got, want):
        s = b.abs().max().clamp_min(1e-6)
        torch.testing.assert_close(a / s, b / s, rtol=2e-5, atol=2e-5)


# The forward-only window attention over the qkv layout
# (ops/pallas_window_attention.py) against its plain version: (B_, N, C,
# nH, nWm). Swin-T's head dim 32 shifted (nWm > 1) and unshifted, a
# stage-3 width, a head dim of 8 with N=37, and the largest shape
# supports() admits (N=64, head dim 64: the opt-in shared-memory path).
PWA_CASES = [
    (16, 49, 96, 3, 4),
    (8, 49, 96, 3, 1),
    (4, 49, 768, 24, 1),
    (6, 37, 40, 5, 2),
    (2, 64, 128, 2, 1),
    # the tiles' edges, as TILE_CASES: N 16 and 36, head dims 24 and 10 (qkv
    # rows of 120 bytes in bf16: the narrow loads), window counts that are
    # not a multiple of a block's windows, and a head dim of 5
    (12, 16, 64, 2, 4),
    (8, 36, 48, 2, 2),
    (37, 49, 96, 3, 1),
    (40, 49, 96, 3, 8),
    (6, 49, 20, 2, 2),
    (6, 9, 15, 3, 3),
    # the large-window tile: Swin at W=14 (N 196, and the augmented 145),
    # its largest window with head dim 64, and a ragged N with head dim 5
    (8, 196, 96, 3, 4),
    (4, 145, 192, 6, 1),
    (2, 256, 128, 2, 2),
    (6, 100, 15, 3, 3),
    # the large tile's key blocks: N=65 and 129, one key past a block
    # (head dims 5 and 32), N=196 at head dim 64 (KD=4, the bias slice in
    # device memory) and N=100 at head dim 64 (KD=4, staged)
    (4, 65, 15, 3, 1),
    (3, 129, 96, 3, 1),
    (4, 196, 192, 3, 2),
    (4, 100, 128, 2, 2),
]


def _pwa_run(fn, cuda, dtype, qkv, bias, dout, nH, offset=0):
    qt = _offset_tensor(qkv, dtype, cuda, offset).requires_grad_()
    bt = torch.tensor(bias, device=cuda).requires_grad_()
    out = fn(qt, bt, nH, (qkv.shape[2] // 3 // nH) ** -0.5)
    out.backward(torch.tensor(dout, device=cuda, dtype=dtype))
    return [t.float().cpu() for t in (out.detach(), qt.grad, bt.grad)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", PWA_CASES)
def test_cuda_pallas_window_attention_matches_plain(cuda, case, dtype, tol):
    """The output within tol of the plain one (normalised by its max-abs)
    and bit-identical on repeat; d(qkv) and d(bias) are the plain
    version's own (the backward recomputes it), so they are equal."""
    from esvit_tpu_torch.ops import pallas_window_attention as pwa

    B_, N, C, nH, nWm = case
    rng = np.random.RandomState(0)
    qkv = rng.randn(B_, N, 3 * C).astype(np.float32)
    bias = (0.3 * rng.randn(nWm, nH, N, N)).astype(np.float32)
    if nWm > 1:
        bias[1:, :, : N // 2, N // 2:] -= 100.0
    dout = rng.randn(B_, N, C).astype(np.float32)
    before = pwa.launches["fwd"]
    got = _pwa_run(pwa.fused_window_attention, cuda, dtype, qkv, bias, dout,
                   nH)
    assert pwa.launches["fwd"] == before + 1
    again = _pwa_run(pwa.fused_window_attention, cuda, dtype, qkv, bias,
                     dout, nH)
    ref = _pwa_run(pwa.pallas_window_attention_plain, cuda, dtype, qkv, bias,
                   dout, nH)
    assert torch.isfinite(got[0]).all()
    torch.testing.assert_close(got[0], again[0], rtol=0, atol=0)
    s = ref[0].abs().max().item()
    torch.testing.assert_close(got[0] / s, ref[0] / s, rtol=tol, atol=tol)
    for name, a, b in zip(("dqkv", "dbias"), got[1:], ref[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_cuda_pallas_window_attention_unaligned_base(cuda, dtype, tol):
    """qkv whose data starts one element past 16-byte alignment takes the
    narrow loads and gives the same result as an aligned copy."""
    from esvit_tpu_torch.ops import pallas_window_attention as pwa

    rng = np.random.RandomState(4)
    qkv = rng.randn(8, 49, 288).astype(np.float32)
    bias = (0.3 * rng.randn(2, 3, 49, 49)).astype(np.float32)
    dout = rng.randn(8, 49, 96).astype(np.float32)
    got = _pwa_run(pwa.fused_window_attention, cuda, dtype, qkv, bias, dout,
                   3, offset=1)
    aligned = _pwa_run(pwa.fused_window_attention, cuda, dtype, qkv, bias,
                       dout, 3)
    ref = _pwa_run(pwa.pallas_window_attention_plain, cuda, dtype, qkv, bias,
                   dout, 3)
    torch.testing.assert_close(got[0], aligned[0], rtol=0, atol=0)
    s = ref[0].abs().max().item()
    torch.testing.assert_close(got[0] / s, ref[0] / s, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_pallas_window_attention_refuses_what_the_kernel_does_not_take(
        cuda):
    from esvit_tpu_torch.ops import pallas_window_attention as pwa

    bias = torch.zeros(1, 3, 49, 49, device=cuda)
    qkv = torch.zeros(2, 49, 288, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        pwa.fused_window_attention(qkv, bias, 3, 0.17)
    qkv = torch.zeros(2, 49, 576, device=cuda)[..., ::2]
    with pytest.raises(ValueError):
        pwa.fused_window_attention(qkv, bias, 3, 0.17)
    qkv = torch.zeros(3, 49, 288, device=cuda)
    with pytest.raises(ValueError):
        pwa.fused_window_attention(qkv, bias.expand(2, 3, 49, 49).contiguous(),
                                   3, 0.17)
    # more tokens than the large-window tile holds
    with pytest.raises(ValueError):
        pwa.fused_window_attention(torch.zeros(1, 257, 288, device=cuda),
                                   torch.zeros(1, 3, 257, 257, device=cuda),
                                   3, 0.17)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {}, {"fused_block_stages": ()},
    {"attention_impl": "pallas", "fused_block_stages": ()}])
def test_cuda_swin_w14_routes_by_each_kernels_supports(cuda, kw):
    """Swin-T's widths at W=14 (one block a stage), fp32, 224 and 96 px on
    the card: every kernel route runs (no kernel is handed a shape its
    supports() refuses), each kernel launches as the model derives, and
    the features are within 1e-4 of the plain route's (attention_impl=
    'xla', no fused stages) from the same weights."""
    _w14_routes(cuda, "swin_tiny", kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {}, {"fused_block_stages": ()},
    {"attention_impl": "pallas", "fused_block_stages": ()}])
def test_cuda_swin_b_w14_routes_by_each_kernels_supports(cuda, kw):
    """The same at Swin-B's widths (C 128 / 256 / 512 / 1024, 4-32 heads):
    the block-fused pair at C=512 on the default route, the packed pair at
    N=196 on fused_block_stages=()."""
    _w14_routes(cuda, "swin_base", kw)


def _w14_routes(cuda, arch, kw):
    import dataclasses

    from esvit_tpu_torch import config as tcfg
    from esvit_tpu_torch.models.swin import SwinTransformer
    from esvit_tpu_torch.ops import fused_block as fb
    from esvit_tpu_torch.ops import pallas_window_attention as pwa

    torch.backends.cudnn.allow_tf32 = False

    def swin(**extra):
        return dataclasses.replace(getattr(tcfg, arch)(
            window_size=14, drop_path_rate=0.0, **extra), depths=(1, 1, 1, 1))

    model = SwinTransformer(swin(**kw),
                            generator=torch.Generator().manual_seed(0)).to(cuda)
    plain = SwinTransformer(swin(attention_impl="xla",
                                 fused_block_stages=())).to(cuda)
    plain.load_state_dict(model.state_dict())
    for size in (224, 96):
        x = torch.randn(2, size, size, 3,
                        generator=torch.Generator().manual_seed(size)).to(cuda)
        counters = (fb.launches, wa.launches, pwa.launches)
        before = [c["fwd"] for c in counters]
        with torch.no_grad():
            got = model.forward_features(x)[1]
            want = plain.forward_features(x)[1]
        launched = [c["fwd"] - b for c, b in zip(counters, before)]
        assert launched == [model.fused_block_calls(size),
                            model.window_attention_calls(size),
                            model.pallas_window_attention_calls(size)]
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert torch.isfinite(got).all() and err <= 1e-4, (size, err)


# The fp32 large-tile backward with the last key column's bias lifted
# (tests/test_torch_window_attention_large_tiles.py lifts it by 8 on the
# CPU): p at that column tends to 1, so its ds is a difference of nearly
# equal fp32 numbers and dk and dbias there sums of N such differences.
# Both kernels that run the large tile's backward in fp32: the packed pair
# (row 4; csrc/window_attention_large_bwd_fp32.cu) at (N, C, nH, windows
# B_, window types), and the block-fused backward's attention half (row 2,
# A2; csrc/fused_block_large_bwd_fp32.cu) at (B, H, ws, C, nH, shifted,
# padded, drop-path) or, at N=145, the augmented 12 x 12 + 1 window (B, C,
# nH); unshifted, so no -100 mask lowers the lifted column. dq, dk, dv and dbias against autograd through window_attention_plain
# in float64 on the kernel's own inputs, each within max(2e-5, 2 x the fp32
# plain version's own error against it) of the fp64 gradient's max-abs;
# each bit-identical on repeat.
LIFTS = (8, 12, 16, 24)
LIFT_PACKED = {145: (145, 256, 8, 5, 0), 196: (196, 128, 4, 12, 0),
               256: (256, 64, 2, 3, 0)}
LIFT_FUSED = {145: (4, 192, 6), 196: (2, 28, 14, 96, 3, False, False, True),
              256: (2, 16, 16, 64, 2, False, False, True)}
FP64_GATE = 2e-5


def _lift_gate(label, got, again, args):
    """Holds got (dq, dk, dv, dbias) to the fp64 gate; again to got bit
    for bit. Prints the kernel's and the fp32 plain version's errors."""
    for name, a, b in zip(wa.GRAD_NAMES, got, again):
        assert torch.isfinite(a).all(), (label, name)
        assert torch.equal(a, b), (label, name, "differs on repeat")
    kernel = wa.fp64_grad_errors(got, *args)
    plain = wa.fp64_grad_errors(wa.plain_grads(*args), *args)
    for name in wa.GRAD_NAMES:
        gate = max(FP64_GATE, 2 * plain[name])
        print(f"fp64 {label} {name}: kernel {kernel[name]:.3e} plain "
              f"{plain[name]:.3e} gate {gate:.3e}")
        assert kernel[name] <= gate, (label, name, kernel[name], gate)


@pytest.mark.cuda
@pytest.mark.parametrize("lift", LIFTS)
@pytest.mark.parametrize("N", sorted(LIFT_PACKED))
def test_cuda_large_bwd_fp32_lifted_bias_against_fp64(cuda, N, lift):
    N, C, nH, B_, nW = LIFT_PACKED[N]
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.tensor(rng.randn(B_ * N, C).astype(np.float32),
                                device=cuda) for _ in range(4))
    bias = torch.tensor((0.3 * rng.randn(nH, N, N)).astype(np.float32),
                        device=cuda)
    bias[:, :, N - 1] += lift
    region = (torch.as_tensor(rng.randint(0, 3, size=(nW, N)).astype(np.int32),
                              device=cuda) if nW else None)
    args = (q, k, v, do, bias, region, N, nH, (C // nH) ** -0.5)
    got = wa._bwd(q, k, v, bias, region, do, N, nH, args[-1])
    again = wa._bwd(q, k, v, bias, region, do, N, nH, args[-1])
    _lift_gate(f"packed N={N} lift={lift}", got, again, args)


def _fused_lift_inputs(cuda, N, lift):
    """(x, params, keep1, keep2, do, kw) of an fp32 block-fused call on the
    card at LIFT_FUSED[N], the last key column's bias lifted."""
    if N == 145:
        B, C, nH = LIFT_FUSED[N]
        rng = np.random.RandomState(2)
        x = (0.5 * rng.randn(B, N, C)).astype(np.float32)
        x[:, -1] = 0.0
        p = _fused_params(rng, C, 4 * C, nH, N)
        p["bias"][:, -1, :] = 0.0
        pad = torch.ones(N, device=cuda)
        pad[-1] = 0.0
        kw = dict(N=N, nH=nH, nW=1, scale=(C // nH) ** -0.5, region=None,
                  pad=pad, eps=1e-6)
        keep = [np.array([1 / 0.9, 0.0, 1 / 0.9, 1 / 0.9], np.float32)] * 2
    else:
        x, p, keep, kw = _fused_inputs(cuda, *LIFT_FUSED[N], seed=5)
        keep = keep or (None, None)
    p["bias"][:, :, N - 1] += lift
    do = np.random.RandomState(6).randn(*x.shape).astype(np.float32)
    k1, k2 = (None if k is None else torch.tensor(k, device=cuda)
              for k in keep)
    return (torch.tensor(x, device=cuda),
            {k: torch.tensor(v, device=cuda) for k, v in p.items()}, k1, k2,
            torch.tensor(do, device=cuda), kw)


@pytest.mark.cuda
@pytest.mark.parametrize("lift", LIFTS)
@pytest.mark.parametrize("N", sorted(LIFT_FUSED))
def test_cuda_fused_large_bwd_fp32_lifted_bias_against_fp64(cuda, N, lift):
    from esvit_tpu_torch.ops import fused_block as fb

    x, p, k1, k2, do, kw = _fused_lift_inputs(cuda, N, lift)
    (q2, k2_, v2, da), got = fb.attention_bwd_io(x, p, k1, k2, do, **kw)
    _, again = fb.attention_bwd_io(x, p, k1, k2, do, **kw)
    args = (q2, k2_, v2, da, p["bias"], kw["region"], N, kw["nH"],
            kw["scale"])
    _lift_gate(f"fused N={N} lift={lift}", got, again, args)
