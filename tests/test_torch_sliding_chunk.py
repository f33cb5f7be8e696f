"""The port's sliding-chunk attention against esvit_tpu's Pallas kernel.

On the CPU the port's ``sliding_chunk_attention`` is its plain PyTorch
version; the JAX kernel runs in Pallas interpret mode, as its own tests
run it. Both get the same numpy inputs, fp32. Tolerances: the forward
within 2e-5 (tests/test_sliding_chunk_fused.py:44), the gradients of all
five inputs within 5e-5 after normalising each by its max-abs (sums in
another order through the softmax's backward). The attention module is
held against esvit_tpu's ``Long2DSCAttention`` on both of its routes, with
bridged weights. The CUDA kernels are held against the plain version in
tests/test_torch_cuda_kernels.py, on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu.models.vil_layers import Long2DSCAttention as JAttention
from esvit_tpu.ops import slidingchunk as jsc
from esvit_tpu.ops.sliding_chunk_fused import \
    sliding_chunk_attention as jax_sliding_chunk
from esvit_tpu_torch.io.jax_params import state_dict_from_flax
from esvit_tpu_torch.models.vil_layers import Long2DSCAttention as TAttention
from esvit_tpu_torch.ops import sliding_chunk as tsc
from tests.torch_threads import one_intra_op_thread  # noqa: F401

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
GRADS = ("q", "k", "v", "k_glo", "v_glo")


def _inputs(BH, nx, ny, nglo, M, seed=0):
    rng = np.random.default_rng(seed)
    grid = (BH, nx, ny, M)
    return ([rng.normal(size=grid).astype(np.float32) * M ** -0.5,
             rng.normal(size=grid).astype(np.float32),
             rng.normal(size=grid).astype(np.float32),
             rng.normal(size=(BH, nglo, M)).astype(np.float32),
             rng.normal(size=(BH, nglo, M)).astype(np.float32)],
            rng.normal(size=grid).astype(np.float32))


def _close(name, got, want, tol):
    s = max(np.abs(want).max(initial=0.0), 1e-6)
    np.testing.assert_allclose(got / s, want / s, rtol=tol, atol=tol,
                               err_msg=name)


# (nx, ny, nglo, W): tests/test_sliding_chunk_fused.py:31-38, plus a
# 4x4-chunk grid at W=4. (12, 12, 1) is the padded 2x2-chunk grid of the
# ViL-T 96 px stage 1.
@pytest.mark.parametrize("nx,ny,nglo,W", [
    (14, 14, 1, 7), (12, 12, 1, 7), (14, 14, 0, 7), (21, 21, 1, 7),
    (21, 10, 1, 7), (6, 6, 1, 7), (16, 16, 1, 4)])
def test_plain_matches_jax_kernel(nx, ny, nglo, W):
    arrays, w = _inputs(2, nx, ny, nglo, 8)

    def jfn(*a):
        return jax_sliding_chunk(*a, nx=nx, ny=ny, W=W, interpret=True)

    ja = [jnp.asarray(a) for a in arrays]
    ref = jfn(*ja)
    ref_g = jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=range(5))(*ja)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = tsc.sliding_chunk_attention(*ts, nx=nx, ny=ny, W=W)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for name, t, g in zip(GRADS, ts, ref_g):
        _close(f"grad {name}", t.grad.numpy(), np.asarray(g), GRAD_TOL)


@pytest.mark.parametrize("args", [(8, 8, 0, 0, 7), (4, 4, 4, 4, 7),
                                  (2, 2, 2, 2, 7), (3, 2, 2, 3, 7),
                                  (1, 1, 1, 1, 7), (4, 4, 0, 0, 4)])
def test_mask_matches_reference(args):
    np.testing.assert_array_equal(tsc.invalid_mask_zero(*args),
                                  jsc.invalid_mask_zero(*args))


@pytest.mark.parametrize("W,M,nglo,kw,ok", [
    (7, 48, 1, {}, True),            # ViL-T stage 0
    (7, 32, 1, {}, True),            # ViL-T stage 1
    (8, 64, 8, {}, True),            # the largest tile the rule admits
    (7, 32, 0, {}, True),
    (9, 32, 1, {}, False),           # W^2 > 64
    (7, 36, 1, {}, False),           # head dim not a multiple of 8
    (7, 72, 1, {}, False),           # head dim above 64
    (7, 32, 9, {}, False),           # more global keys than 8
    (7, 32, 1, {"mode": 1}, False),  # a sampled neighbour: einsum path
    (7, 32, 1, {"exact": 1}, False),
    (7, 32, 1, {"rpe": True}, False),
])
def test_supports_is_a_shape_rule(W, M, nglo, kw, ok):
    assert tsc.supports(W, M, nglo, **kw) is ok


def test_only_cpu_tensors_take_the_plain_version():
    """A tensor on any device but the CPU goes to the kernel wrapper, which
    refuses what is not CUDA: no quiet fall-back to the plain version."""
    q = torch.zeros(2, 14, 14, 32, device="meta")
    g = torch.zeros(2, 1, 32, device="meta")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tsc.sliding_chunk_attention(q, q, q, g, g, nx=14, ny=14, W=7)
    q, g = torch.zeros(2, 14, 14, 32), torch.zeros(2, 1, 32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tsc._SlidingChunk.apply(q, q, q, g, g, 14, 14, 7)


@pytest.mark.parametrize("jax_route", ["interpret", "off"])
@pytest.mark.parametrize("nx,ny,nglo", [(14, 14, 1), (12, 12, 0)])
def test_attention_module_matches_jax(jax_route, nx, ny, nglo):
    """Forward and every parameter gradient of the attention module (the
    local-q / shared-kv projections, the *_global projections and the
    global rows' MHA), with the JAX module's weights."""
    dim, heads, B = 24, 3, 2
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, nglo + nx * ny, dim)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    mod = JAttention(dim=dim, num_heads=heads, window=7, nglo=nglo,
                     rpe=False, fused_sc=jax_route)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), nx, ny)["params"]

    def loss(p, x):
        return jnp.sum(mod.apply({"params": p}, x, nx, ny) * w)

    ref = mod.apply({"params": params}, jnp.asarray(x), nx, ny)
    ref_g = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    ours = TAttention(dim, heads, 7, nglo)
    ours.load_state_dict(state_dict_from_flax(jax.device_get(params)),
                         strict=True)
    xt = torch.tensor(x, requires_grad=True)
    out = ours(xt, nx, ny)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=FWD_TOL, atol=FWD_TOL)
    _close("grad x", xt.grad.numpy(), np.asarray(ref_g[1]), GRAD_TOL)
    want = state_dict_from_flax(jax.device_get(ref_g[0]))
    got = dict(ours.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        _close(f"grad {name}", got[name].grad.numpy(), g.numpy(), GRAD_TOL)
