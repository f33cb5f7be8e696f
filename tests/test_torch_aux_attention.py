"""The port's auxiliary attentions against esvit_tpu's.

``AxialAttention``, ``CrissCrossAttention``, ``ConvQKVAttention`` (every
stem, with and without CLS, the linear path, ``qkv_ratio`` 3 and 2,
chained ``res_score``, the average-attention modes, ``add_v_res``,
``return_attn``), ``DownAttention`` and ``CrossScaleAttention`` (v_full
before and after ``proj``): weights and BatchNorm statistics drawn
with numpy at flax's shapes, carried over by io/jax_params.py, the same
numpy input through both, a 4x4 grid of width 16 with 2 heads. With ``bn_train``
the batch statistics normalise and the running buffers move as flax's
``batch_stats`` do. Tolerance: 1e-5 relative to each output's largest
value in fp32, 3e-2 in bf16. esvit_tpu's own tests of these modules
need the original torch EsViT tree; these are the parity checks here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu.models import aux_attention as J
from esvit_tpu_torch.io.jax_params import state_dict_from_flax
from esvit_tpu_torch.models import aux_attention as T
from tests.torch_threads import one_intra_op_thread  # noqa: F401

B, H, C, NH = 2, 4, 16, 2
TOL = {"fp32": 1e-5, "bf16": 3e-2}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _x(cls=True, seed=0):
    n = H * H + (1 if cls else 0)
    return np.random.default_rng(seed).normal(size=(B, n, C)).astype(
        np.float32)


def _variables(jmod, x, seed=0, std=0.3, **call):
    """The module's variables drawn with numpy at flax's shapes
    (``jax.eval_shape`` of init: nothing compiles); BatchNorm statistics
    away from their init (mean 0, var 1), so running-statistics
    normalisation shows. Drawn once for each module (whatever its
    ``dtype``: the parameters are fp32), input shape and seed."""
    if hasattr(jmod, "dtype"):
        jmod = jmod.clone(dtype=jnp.float32)
    spec = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32),
                        x)
    return _draw(jmod, spec, seed, std, tuple(sorted(call.items())))


@functools.lru_cache(maxsize=None)
def _draw(jmod, spec, seed, std, call):
    shapes = jax.eval_shape(lambda k, a: jmod.init(k, a, **dict(call)),
                            jax.random.PRNGKey(0), spec)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf == "scale":
            return rng.normal(1.0, 0.2, s.shape).astype(np.float32)
        return rng.normal(0.0, {"mean": 0.5, "bias": 0.1}.get(leaf, std),
                          s.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(cls, kw, variables, dtype="fp32"):
    m = cls(**kw, dtype=TDT[dtype])
    m.load_state_dict(state_dict_from_flax(variables["params"],
                                           variables.get("batch_stats")),
                      strict=True)
    return m


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _apply(jmod, kw):
    """``jmod.apply(variables, x, **kw)`` under ``jax.jit``, one program
    for each module and keyword set."""
    return jax.jit(lambda v, a: jmod.apply(v, a, **dict(kw)))


def _check(jcls, tcls, kw, x, dtype="fp32", bn_train=False, pair=True,
           **call):
    """One module on both sides: outputs (and prev), and with bn_train the
    running buffers against flax's updated batch_stats."""
    jmod = jcls(**kw, dtype=JDT[dtype])
    v = _variables(jmod, x, **call)
    tmod = _port(tcls, kw, v, dtype)
    xt = torch.from_numpy(x).to(TDT[dtype])
    jx = jnp.asarray(x, JDT[dtype])
    extra = {"bn_train": bn_train} if pair else {}
    mutable = {"mutable": ("batch_stats",)} if bn_train else {}
    out = _apply(jmod, tuple(sorted({**extra, **mutable, **call}.items())))(
        v, jx)
    want, upd = out if bn_train else (out, None)
    with torch.no_grad():
        got = tmod(xt, **extra, **call)
    if pair:
        for i, (g, w) in enumerate(zip(got, want)):
            if w is None:
                assert g is None
            else:
                _close(g, w, TOL[dtype], f"output {i}")
    else:
        _close(got, want, TOL[dtype])
    if bn_train:
        sd = tmod.state_dict()
        for name, want_b in state_dict_from_flax(
                {}, upd["batch_stats"]).items():
            _close(sd[name], want_b.numpy(), TOL[dtype], name)
    return tmod, v


@pytest.mark.parametrize("horizontal", [False, True])
def test_axial(horizontal):
    _check(J.AxialAttention, T.AxialAttention,
           dict(dim=C, num_heads=NH, horizontal=horizontal), _x(), pair=False)


@pytest.mark.parametrize("cls", [True, False])
def test_criss_cross(cls):
    _check(J.CrissCrossAttention, T.CrissCrossAttention,
           dict(dim=C, num_heads=NH, use_cls_token=cls), _x(cls), pair=False)


@pytest.mark.parametrize("cls", [True, False])
@pytest.mark.parametrize("method", T.METHODS)
def test_conv_qkv_stem(method, cls):
    _check(J.ConvQKVAttention, T.ConvQKVAttention,
           dict(dim=C, num_heads=NH, use_qkvconv=True, method=method,
                qkv_bias=True), _x(cls, seed=len(method)))


@pytest.mark.parametrize("method", ["dw_bn_glu_pw", "dw_pw"])
@pytest.mark.parametrize("cls", [True, False])
def test_conv_qkv_reduced_ratio(method, cls):
    """qkv_ratio 2: q and k 10 wide in h-major [q | k | v] blocks."""
    _check(J.ConvQKVAttention, T.ConvQKVAttention,
           dict(dim=C, num_heads=NH, use_qkvconv=True, method=method,
                qkv_ratio=2.0), _x(cls))


@pytest.mark.parametrize("kw", [
    dict(), dict(add_v_res=True), dict(use_avg_att=True, add_v_res=True),
    dict(use_avg_att_all=True, add_v_res=True)],
    ids=["plain", "add_v_res", "avg_att", "avg_att_all"])
def test_conv_qkv_linear_path(kw):
    """use_qkvconv=False; avg_att with ratio 3 rewrites the v add_v_res
    adds (the reference's view)."""
    _check(J.ConvQKVAttention, T.ConvQKVAttention,
           dict(dim=C, num_heads=NH, **kw), _x())


def test_conv_qkv_avg_att_reduced_ratio():
    """With ratio 2 the split forces a copy: avg_att leaves v as it is."""
    _check(J.ConvQKVAttention, T.ConvQKVAttention,
           dict(dim=C, num_heads=NH, use_qkvconv=True, method="dw_pw",
                qkv_ratio=2.0, use_avg_att=True, add_v_res=True), _x())


def test_conv_qkv_return_attn():
    _check(J.ConvQKVAttention, T.ConvQKVAttention,
           dict(dim=C, num_heads=NH, use_qkvconv=True, method="conv"),
           _x(), return_attn=True)


@pytest.mark.parametrize("method", ["dw_bn_glu_pw", "pw_glu_conv_bn_swish_pw",
                                    "conv_pw"])
def test_conv_qkv_res_score_chain(method):
    """Two layers, the second adding the first's scores (prev)."""
    kw = dict(dim=C, num_heads=NH, use_qkvconv=True, method=method,
              res_score=True)
    x = _x()
    jmod = J.ConvQKVAttention(**kw)
    v1, v2 = _variables(jmod, x, 0), _variables(jmod, x, 5)
    t1, t2 = _port(T.ConvQKVAttention, kw, v1), _port(T.ConvQKVAttention,
                                                      kw, v2)

    @jax.jit
    def chain(v1, v2, a):
        o1, p1 = jmod.apply(v1, a)
        return (o1, p1) + tuple(jmod.apply(v2, o1, prev=p1))
    o1, p1, o2, p2 = chain(v1, v2, jnp.asarray(x))
    with torch.no_grad():
        g1, q1 = t1(torch.from_numpy(x))
        g2, q2 = t2(g1, prev=q1)
    for g, w, what in ((g1, o1, "out1"), (q1, p1, "prev1"), (g2, o2, "out2"),
                       (q2, p2, "prev2")):
        _close(g, w, TOL["fp32"], what)


@pytest.mark.parametrize("method", ["dw_bn_glu_pw", "pw_glu_conv_bn_swish_pw"])
def test_conv_qkv_bn_train(method):
    _check(J.ConvQKVAttention, T.ConvQKVAttention,
           dict(dim=C, num_heads=NH, use_qkvconv=True, method=method,
                qkv_bias=True), _x(seed=len(method)), bn_train=True)


@pytest.mark.parametrize("method", ["conv", "dw_bn_glu_pw",
                                    "pw_glu_conv_bn_swish_pw"])
def test_conv_qkv_bf16(method):
    _check(J.ConvQKVAttention, T.ConvQKVAttention,
           dict(dim=C, num_heads=NH, use_qkvconv=True, method=method,
                qkv_bias=True), _x(seed=len(method)), dtype="bf16")


@pytest.mark.parametrize("kw,cls", [
    (dict(), True), (dict(), False),
    (dict(add_v_full_after_proj=True), True),
    (dict(qkv_ratio=2.0, method="dw_swish_pw"), True),
    (dict(res_score=True, method="dw_glu_pw"), False)],
    ids=["cls", "no_cls", "after_proj", "ratio2", "res_score"])
def test_down_attention(kw, cls):
    """Stride 2: the 2x2 attention upsampled back to 4x4."""
    _check(J.DownAttention, T.DownAttention,
           dict(dim=C, num_heads=NH, stride=2, **kw), _x(cls))


def test_down_attention_bn_train():
    _check(J.DownAttention, T.DownAttention,
           dict(dim=C, num_heads=NH, stride=2), _x(), bn_train=True)


@pytest.mark.parametrize("kw,cls", [
    (dict(stride=2), True), (dict(stride=2), False),
    (dict(stride=2, add_v_full_after_proj=True, method="dw_pw"), True),
    (dict(add_v_res=True, res_score=True, method="dw_bn_pw"), True)],
    ids=["cls", "no_cls", "after_proj", "v_res"])
def test_cross_scale(kw, cls):
    """Queries 16 (+1) tokens, keys 4 (+1) at stride 2: the raw-view head
    split scrambles tokens and channels."""
    _check(J.CrossScaleAttention, T.CrossScaleAttention,
           dict(dim=C, num_heads=NH, **kw), _x(cls))


def test_cross_scale_bn_train():
    _check(J.CrossScaleAttention, T.CrossScaleAttention,
           dict(dim=C, num_heads=NH, stride=2), _x(), bn_train=True)


@pytest.mark.parametrize("name", ["axial", "criss_cross", "conv_qkv", "down"])
def test_input_gradient(name):
    """d(sum(out * w)) / dx against jax.grad, fp32."""
    jcls, tcls, kw, pair = {
        "axial": (J.AxialAttention, T.AxialAttention, {}, False),
        "criss_cross": (J.CrissCrossAttention, T.CrissCrossAttention, {},
                        False),
        "conv_qkv": (J.ConvQKVAttention, T.ConvQKVAttention,
                     dict(use_qkvconv=True, method="pw_glu_dw_glu_pw"), True),
        "down": (J.DownAttention, T.DownAttention, dict(stride=2), True),
    }[name]
    kw = dict(dim=C, num_heads=NH, **kw)
    x = _x()
    jmod = jcls(**kw)
    v = _variables(jmod, x)
    tmod = _port(tcls, kw, v)
    w = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    @jax.jit
    def jgrad(a):
        def loss(a):
            out = jmod.apply(v, a)
            return jnp.sum((out[0] if pair else out) * w)
        return jax.grad(loss)(a)
    want = jgrad(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmod(xt)
    ((out[0] if pair else out) * torch.from_numpy(w)).sum().backward()
    _close(xt.grad, want, TOL["fp32"])


def test_refusals():
    with pytest.raises(ValueError, match="qkv_ratio"):
        T.ConvQKVAttention(C, num_heads=NH, use_qkvconv=True, method="conv",
                           qkv_ratio=2.0)
    with pytest.raises(ValueError, match="dw_"):
        T.DownAttention(C, num_heads=NH, method="conv")
