"""The port's window attention against esvit_tpu's packed Pallas kernel.

On the CPU the port's ``window_attention`` is its plain PyTorch version;
the JAX kernel runs in Pallas interpret mode, as its own tests run it.
Both get the same numpy inputs. Tolerance 2e-5 in fp32 (the two sum in
different orders), the same as tests/test_packed_window_attention.py.
The CUDA kernels are held against the plain version in
tests/test_torch_cuda_kernels.py, on a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu.ops import window as jwops
from esvit_tpu.ops.packed_window_attention import packed_window_attention
from esvit_tpu_torch.ops import window as twops
from esvit_tpu_torch.ops import window_attention as twa
from tests.test_packed_window_attention import CASES
from tests.torch_threads import one_intra_op_thread  # noqa: F401

FP32_TOL = 2e-5


def _inputs(case, seed=0):
    N, nH, nW, B, shifted, H, W, ws, ss = case
    C = nH * 32
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B * nW * N, C).astype(np.float32) for _ in range(3))
    bias = (0.3 * rng.randn(nH, N, N)).astype(np.float32)
    region = jwops.window_region_ids(H, W, ws, ss) if shifted else None
    return q, k, v, bias, region


def _jax_fn(N, nH, region):
    return functools.partial(packed_window_attention, N=N, nH=nH,
                             scale=32 ** -0.5, score_dtype=jnp.float32,
                             interpret=True, region=region)


def _torch_out_and_grads(q, k, v, bias, region, N, nH):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    reg = torch.as_tensor(region) if region is not None else None
    out = twa.window_attention(*ts, reg, N, nH, 32 ** -0.5)
    (out.float() ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_packed_kernel(case):
    N, nH = case[0], case[1]
    q, k, v, bias, region = _inputs(case)
    fn = _jax_fn(N, nH, region)
    args = tuple(jnp.asarray(a) for a in (q, k, v, bias))
    ref = fn(*args)
    ref_g = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2, 3))(*args)

    out, grads = _torch_out_and_grads(q, k, v, bias, region, N, nH)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=FP32_TOL,
                               atol=FP32_TOL)
    for name, a, b in zip("qkvb", grads, ref_g):
        b = np.asarray(b)
        s = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / s, b / s, rtol=FP32_TOL, atol=FP32_TOL,
                                   err_msg=f"grad {name}")


def test_plain_softmax_stable_across_head_scales():
    """Per-(window, head) softmax max: head 0's scores sit far above head
    1's (tests/test_packed_window_attention.py:100); a shared max would
    underflow head 1 to 0/0."""
    N, nH, nW, B = 16, 2, 4, 2
    C = nH * 32
    rng = np.random.RandomState(3)
    q = rng.randn(B * nW * N, C).astype(np.float32)
    k = rng.randn(B * nW * N, C).astype(np.float32)
    q[:, :32] *= 40.0
    k[:, :32] *= 40.0
    v = rng.randn(B * nW * N, C).astype(np.float32)
    bias = (0.3 * rng.randn(nH, N, N)).astype(np.float32)
    ref = _jax_fn(N, nH, None)(*(jnp.asarray(a) for a in (q, k, v, bias)))
    out, grads = _torch_out_and_grads(q, k, v, bias, None, N, nH)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-4, atol=2e-4)
    for g in grads:
        assert np.isfinite(g).all()


def test_region_tables_match_reference():
    for args in [(8, 8, 4, 2), (28, 28, 7, 3), (24, 24, 7, 3)]:
        np.testing.assert_array_equal(twops.window_region_ids(*args),
                                      jwops.window_region_ids(*args))
        np.testing.assert_array_equal(twops.shifted_window_mask(*args),
                                      jwops.shifted_window_mask(*args))


@pytest.mark.parametrize("Hp,ws,src,dst", [(8, 4, 0, 2), (28, 7, 3, 0),
                                           (14, 7, 0, 3)])
def test_window_major_moves_match_reference(Hp, ws, src, dst):
    x = np.random.RandomState(0).randn(2, Hp * Hp, 5).astype(np.float32)
    tx = torch.from_numpy(x)
    for ours, ref in [
            (twops.to_window_major(tx, Hp, Hp, ws, src),
             jwops.to_window_major(jnp.asarray(x), Hp, Hp, ws, src)),
            (twops.from_window_major(tx, Hp, Hp, ws, dst),
             jwops.from_window_major(jnp.asarray(x), Hp, Hp, ws, dst)),
            (twops.transition_window_major(tx, Hp, Hp, ws, src, dst),
             jwops.transition_window_major(jnp.asarray(x), Hp, Hp, ws, src,
                                           dst))]:
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_kernel_path_refuses_cpu_tensors():
    """The CUDA path never computes on the CPU: only window_attention's
    device test picks the plain version."""
    q = torch.zeros(16, 64)
    bias = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        twa._WindowAttention.apply(q, q, q, bias, None, 16, 2, 0.125)
