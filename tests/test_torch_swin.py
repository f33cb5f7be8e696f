"""The port's Swin backbone, heads, loss and weight bridge against esvit_tpu.

Same weights (the JAX init, carried over by io/jax_params.py) and the
same numpy inputs through both packages, fp32, at femto size. 32px crops
run the window-major path with a shifted stage; 24px crops run the padded
window-major path (6x6 -> 8x8) in stage 0 and the sub-window path in
stage 1. The JAX side runs its XLA path (attention_impl='xla',
fused_block_stages=()). Tolerance 1e-4 for the backbone and head outputs
(float32 sums in another order across ~10 layers), 1e-5 for the loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu import losses as jlosses
from esvit_tpu.io import torch_import
from esvit_tpu.models.esvit import EsViTModel as JEsViT
from esvit_tpu.models.swin import SwinTransformer as JSwin
from esvit_tpu.utils import schedules as jsched
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch import losses as tlosses
from esvit_tpu_torch.io.jax_params import state_dict_from_flax
from esvit_tpu_torch.models.esvit import EsViTModel as TEsViT
from esvit_tpu_torch.models.registry import build_backbone
from esvit_tpu_torch.models.swin import SwinTransformer as TSwin
from esvit_tpu_torch.utils import schedules as tsched

TOL = 1e-4
HEAD = dict(out_dim=32, hidden_dim=16, bottleneck_dim=8)
B = 2


def _crops(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2 * B, 32, 32, 3)).astype(np.float32),
            rng.normal(size=(2 * B, 24, 24, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_model():
    model = JEsViT(jcfg.swin_femto(attention_impl="xla", fused_block_stages=()),
                   jcfg.HeadConfig(**HEAD), use_dense_prediction=True,
                   dtype=jnp.float32)
    crops = tuple(jnp.asarray(c) for c in _crops())
    params = jax.jit(lambda r: model.init({"params": r}, crops))(
        jax.random.PRNGKey(0))["params"]
    return model, jax.tree.map(np.asarray, params)


def _torch_model(params, **swin_kw):
    model = TEsViT(tcfg.swin_femto(**swin_kw), tcfg.HeadConfig(**HEAD),
                   use_dense_prediction=True)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def test_state_dict_round_trip(jax_model):
    """flax -> port state_dict -> torch_import -> the same flax tree."""
    _, params = jax_model
    sd = _torch_model(params).state_dict()
    assert "layers.0.blocks.1.attn.qkv.weight" in sd
    assert "head.mlp.4.weight" in sd and "head_dense.last_layer.weight_g" in sd
    back = torch_import.import_esvit_model(
        {k: v.numpy() for k, v in sd.items()}, "swin")["params"]
    assert not torch_import.verify_tree_matches(back, params)
    jax.tree.map(np.testing.assert_array_equal, back, params)


@pytest.mark.parametrize("layout_opt", [True, False])
@pytest.mark.parametrize("attention_impl", ["packed", "xla"])
@pytest.mark.parametrize("size", [32, 24])
def test_forward_features_matches_jax(jax_model, size, attention_impl,
                                      layout_opt):
    _, params = jax_model
    x = _crops()[0 if size == 32 else 1]
    j_cls, j_region = JSwin(jcfg.swin_femto(attention_impl="xla",
                                            fused_block_stages=())).apply(
        {"params": params["backbone"]}, jnp.asarray(x))
    ours = TSwin(tcfg.swin_femto(attention_impl=attention_impl,
                                 layout_opt=layout_opt))
    ours.load_state_dict(state_dict_from_flax(params["backbone"]), strict=True)
    with torch.no_grad():
        t_cls, t_region = ours.forward_features(torch.from_numpy(x))
    np.testing.assert_allclose(t_region.numpy(), np.asarray(j_region),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_cls.numpy(), np.asarray(j_cls),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("batch_size", [None, B])
def test_multicrop_model_matches_jax(jax_model, batch_size):
    model, params = jax_model
    crops = _crops(1)
    ref = model.apply({"params": params}, tuple(map(jnp.asarray, crops)),
                      batch_size=batch_size)
    with torch.no_grad():
        got = _torch_model(params)(tuple(map(torch.from_numpy, crops)),
                                   batch_size=batch_size)
    assert got[3] == ref[3]
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout", ["batch_major", "flat"])
def test_ddino_loss_matches_jax(layout):
    """Loss, both centers and the gradient w.r.t. the student outputs."""
    rng = np.random.default_rng(2)
    K, Cf, ncrops, Ng, Nl = 16, 8, 4, 4, 1
    S = 2 * Ng + 2 * Nl
    t_temp = 0.05
    s_cls = rng.normal(size=(ncrops * B, K)).astype(np.float32)
    t_cls = rng.normal(size=(2 * B, K)).astype(np.float32)
    shapes = {"batch_major": ((B, S, K), (B, S, Cf), (B, 2 * Ng, K), (B, 2 * Ng, Cf)),
              "flat": ((B * S, K), (B * S, Cf), (2 * B * Ng, K), (2 * B * Ng, Cf))}
    s_reg, s_fea, t_reg, t_fea = (rng.normal(size=s).astype(np.float32)
                                  for s in shapes[layout])
    c0 = rng.normal(size=K).astype(np.float32)
    c1 = rng.normal(size=K).astype(np.float32)
    npatch = (Ng, Nl)

    def jloss(sc, sr):
        return jlosses.ddino_loss(
            (sc, sr, jnp.asarray(s_fea), npatch),
            (jnp.asarray(t_cls), jnp.asarray(t_reg), jnp.asarray(t_fea), (Ng,)),
            jlosses.DinoCenters(jnp.asarray(c0), jnp.asarray(c1)),
            jnp.float32(t_temp), ncrops=ncrops, batch_size=B)

    (j_loss, j_c), j_g = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(s_cls), jnp.asarray(s_reg))
    sc, sr = (torch.tensor(a, requires_grad=True) for a in (s_cls, s_reg))
    loss, centers = tlosses.ddino_loss(
        (sc, sr, torch.from_numpy(s_fea), npatch),
        (torch.from_numpy(t_cls), torch.from_numpy(t_reg),
         torch.from_numpy(t_fea), (Ng,)),
        tlosses.DinoCenters(torch.from_numpy(c0), torch.from_numpy(c1)),
        t_temp, ncrops=ncrops, batch_size=B)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    for a, b in zip(centers, j_c):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    for a, b in zip((sc.grad, sr.grad), j_g):
        b = np.asarray(b)
        s = np.abs(b).max()
        np.testing.assert_allclose(a.numpy() / s, b / s, rtol=1e-5, atol=1e-5)


def test_dino_loss_matches_jax():
    rng = np.random.default_rng(3)
    s = rng.normal(size=(4 * B, 16)).astype(np.float32)
    t = rng.normal(size=(2 * B, 16)).astype(np.float32)
    c = rng.normal(size=16).astype(np.float32)
    j_loss, j_c = jlosses.dino_loss(jnp.asarray(s), jnp.asarray(t),
                                    jnp.asarray(c), jnp.float32(0.04), ncrops=4)
    loss, center = tlosses.dino_loss(torch.from_numpy(s), torch.from_numpy(t),
                                     torch.from_numpy(c), 0.04, ncrops=4)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(center.numpy(), np.asarray(j_c), rtol=1e-6)


@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_match_jax(warmup):
    kw = dict(base_value=5e-4, final_value=1e-6, total_steps=20,
              warmup_steps=warmup)
    for step in range(20):
        assert tsched.cosine_schedule(step, **kw) == pytest.approx(
            float(jsched.cosine_schedule(step, **kw)), rel=1e-6, abs=0)
    tk = dict(warmup_teacher_temp=0.04, teacher_temp=0.07,
              warmup_teacher_temp_epochs=5)
    for epoch in range(8):
        assert tsched.teacher_temp_schedule(epoch, **tk) == float(
            jsched.teacher_temp_schedule(epoch, **tk))


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="queue 2 items 1-3"):
        tcfg.check_supported(tcfg.TrainConfig(
            model=tcfg.swin_tiny(fused_block_stages=(0,))))
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        build_backbone(type("ViL", (), {"name": "vil"})())
    tcfg.check_supported(tcfg.TrainConfig())
