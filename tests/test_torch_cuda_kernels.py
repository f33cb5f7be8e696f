"""The port's CUDA window-attention kernels against their plain version.

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


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(49 * 2, 96, device=cuda, dtype=torch.float16)
    bias = torch.zeros(3, 49, 49, device=cuda)
    with pytest.raises(TypeError):
        wa.window_attention(q, q, q, bias, None, 49, 3, 0.17)
    q = torch.zeros(49 * 2, 192, device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        wa.window_attention(q, q, q, bias, None, 49, 3, 0.17)


# The block-fused kernel pair (ops/fused_block.py) against its plain
# version: (B, H, ws, C, nH, shifted, spatially padded, drop-path). C and nH
# keep the head dim at 32 as in Swin-T; the last case is a stage-2 width.
FUSED_CASES = [
    (2, 14, 7, 64, 2, False, False, False),
    (2, 14, 7, 64, 2, True, False, True),
    (2, 12, 7, 64, 2, True, True, False),
    (2, 7, 7, 384, 12, False, False, True),
]


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
    from esvit_tpu_torch.ops import fused_block as fb

    B, C, nH, N = 4, 384, 12, 37
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
    ref = _fused_run(fb.fused_swin_block_plain, cuda, dtype, x, p, keep, kw,
                     dout)
    for name, a in got.items():
        s = _fused_scale(ref, name)
        torch.testing.assert_close(a / s, ref[name] / s, rtol=tol, atol=tol,
                                   msg=name)


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
]


def _pwa_run(fn, cuda, dtype, qkv, bias, dout, nH):
    qt = torch.tensor(qkv, device=cuda, dtype=dtype).requires_grad_()
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
