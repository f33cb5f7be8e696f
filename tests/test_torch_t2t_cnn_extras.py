"""The port's T2T module and CNN extras against esvit_tpu's.

``unfold`` (torch's (c, kh, kw) patch order), ``T2TAttention``,
``T2TModule`` (32 px, token_dim 8, embed 16: a 2x2 token grid) in fp32
and bf16 and its input gradient; ``SELayer2D``, ``h_sigmoid``,
``DyReLU2``, ``FrozenBatchNorm`` (the ``frozen_stats`` collection into
buffers) and ``DropBlock`` on jax.random's own uniform draws. Weights
drawn with numpy at flax's shapes, carried over by io/jax_params.py.
Tolerance: 1e-5 relative to each output's largest value in fp32, 3e-2
in bf16.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu.models import cnn_extras as JC
from esvit_tpu.models import t2t as JT
from esvit_tpu_torch.io.jax_params import state_dict_from_flax
from esvit_tpu_torch.models import cnn_extras as TC
from esvit_tpu_torch.models import t2t as TT
from tests.test_torch_aux_attention import TDT, TOL, _close, _variables
from tests.torch_threads import one_intra_op_thread  # noqa: F401

JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(jmod, tmod, x, dtype="fp32", **call):
    """Variables for jmod, loaded into tmod; both outputs on x."""
    v = _variables(jmod, x)
    sd = state_dict_from_flax(v.get("params", {}),
                              frozen_stats=v.get("frozen_stats"))
    tmod.load_state_dict(sd, strict=True)
    want = jax.jit(lambda v, a: jmod.apply(v, a, **call))(
        v, jnp.asarray(x, JDT[dtype]))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).to(TDT[dtype]), **call)
    return got, want, v


@pytest.mark.parametrize("k,s,p", [(7, 4, 2), (3, 2, 1)])
def test_unfold(k, s, p):
    x = _rand(2, 16, 16, 5)
    want = jax.jit(JT.unfold, static_argnums=(1, 2, 3))(jnp.asarray(x), k,
                                                         s, p)
    _close(TT.unfold(torch.from_numpy(x), k, s, p), want, 0.0)


def test_t2t_attention():
    x = _rand(2, 10, 12)
    got, want, _ = _pair(JT.T2TAttention(12, 8, qkv_bias=True),
                         TT.T2TAttention(12, 8, qkv_bias=True), x)
    _close(got, want, TOL["fp32"])


def test_t2t_module_bf16():
    x = _rand(2, 32, 32, 3)
    got, want, _ = _pair(
        JT.T2TModule(embed_dim=16, token_dim=8, dtype=jnp.bfloat16),
        TT.T2TModule(embed_dim=16, token_dim=8, dtype=torch.bfloat16), x,
        "bf16")
    _close(got, want, TOL["bf16"])


def test_t2t_module_and_input_gradient():
    """fp32: the output and d(sum(out * w)) / dx."""
    x = _rand(2, 32, 32, 3)
    jmod = JT.T2TModule(embed_dim=16, token_dim=8)
    tmod = TT.T2TModule(embed_dim=16, token_dim=8)
    v = _variables(jmod, x)
    tmod.load_state_dict(state_dict_from_flax(v["params"]), strict=True)
    w = _rand(2, 4, 16, seed=3)
    def fwd_grad(a):
        out, vjp = jax.vjp(lambda b: jmod.apply(v, b), a)
        return out, vjp(jnp.asarray(w))[0]
    want, want_g = jax.jit(fwd_grad)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tmod(xt)
    (got * torch.from_numpy(w)).sum().backward()
    assert got.shape == (2, 4, 16)
    _close(got, want, TOL["fp32"])
    _close(xt.grad, want_g, TOL["fp32"])


def test_t2t_attention_refuses_heads():
    with pytest.raises(ValueError, match="num_heads=1"):
        TT.T2TAttention(12, 8, num_heads=2)


def test_se_layer():
    x = _rand(2, 6, 6, 16)
    got, want, _ = _pair(JC.SELayer2D(16, reduction=4),
                         TC.SELayer2D(16, reduction=4), x)
    _close(got, want, TOL["fp32"])


def test_h_sigmoid():
    x = np.linspace(-5, 5, 41).astype(np.float32)
    _close(TC.h_sigmoid(torch.from_numpy(x), 2.0),
           JC.h_sigmoid(jnp.asarray(x), 2.0), 1e-7)


@pytest.mark.parametrize("kw", [
    dict(), dict(lambda_a=0.5, init_a=(1.5, 0.25), init_b=(0.1, -0.2))],
    ids=["default", "custom"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dyrelu(kw, dtype):
    x = _rand(2, 5, 5, 8)
    got, want, _ = _pair(JC.DyReLU2(8, dtype=JDT[dtype], **kw),
                         TC.DyReLU2(8, dtype=TDT[dtype], **kw), x, dtype)
    _close(got, want, TOL[dtype])


def test_frozen_batchnorm():
    x = _rand(2, 4, 4, 6)
    tmod = TC.FrozenBatchNorm(6)
    got, want, v = _pair(JC.FrozenBatchNorm(6), tmod, x)
    assert set(dict(tmod.named_buffers())) == {
        "weight", "bias", "running_mean", "running_var"}
    assert not list(tmod.parameters())
    _close(got, want, TOL["fp32"])


class _Draw(fnn.Module):
    """The draws DropBlock's make_rng('dropblock') gives at the root
    scope."""
    shape: tuple

    @fnn.compact
    def __call__(self):
        return jax.random.uniform(self.make_rng("dropblock"), self.shape)


@pytest.mark.parametrize("bs,keep,progress", [(5, 0.8, 1.0), (4, 0.7, 0.5),
                                              (7, 0.9, 1.0)])
def test_dropblock_on_jax_draws(bs, keep, progress):
    """bs 4 is even: SAME pads one more after than before."""
    x = _rand(2, 12, 12, 3)

    @jax.jit
    def reference(a, k):
        """esvit_tpu's DropBlock and the uniform field it draws."""
        rngs = {"dropblock": k}
        return (JC.DropBlock(block_size=bs, keep_prob=keep).apply(
            {}, a, deterministic=False, progress=progress, rngs=rngs),
            _Draw(a.shape).apply({}, rngs=rngs))
    want, u = reference(jnp.asarray(x), jax.random.PRNGKey(bs))
    m = TC.DropBlock(block_size=bs, keep_prob=keep)
    mask = TC.dropblock_mask(torch.tensor(np.asarray(u)),
                             *m.gamma(12, progress))
    got = m.apply_mask(torch.from_numpy(x), mask)
    assert (mask == 0).any()
    _close(got, want, TOL["fp32"])


def test_dropblock_own_draws():
    x = torch.ones(2, 16, 16, 4)
    m = TC.DropBlock(block_size=5, keep_prob=0.8)
    assert m(x) is x                                  # deterministic
    out = m(x, deterministic=False, generator=torch.Generator().manual_seed(3))
    again = m(x, deterministic=False,
              generator=torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    assert (out == 0).any() and out.max() > 1.0
