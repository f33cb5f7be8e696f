"""The port's ViL (Vision Longformer) backbone and train step against
esvit_tpu.

Same weights (the JAX init, carried over by io/jax_params.py) and the
same numpy inputs through both packages, fp32. Models: ``vil_femto``
(W=2: a sparse stage and a full-attention stage, 32 and 24 px) and a
narrow W=7 model with two sparse stages and a last stage without global
tokens (112 px: 4x4 and 2x2 chunks; 48 px: the padded 2x2-chunk and
single-chunk grids, and the 7x7 -> 3x3 position-table resample of the
ViL-T 96 px stage 3). The JAX side runs its einsum path
(``fused_sc='off'``); the port its default route, which on the CPU is the
kernel's plain version. Tolerance 1e-5 on features and train state (fp32
sums in another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.io import torch_import
from esvit_tpu.models.vil import MsViT as JViL
from esvit_tpu.ops.resample import torch_interpolate_scale as jax_resample
from esvit_tpu.train.step import EsViTTrainer as JTrainer
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import (_adam_state, state_dict_from_flax,
                                           train_state_from_jax)
from esvit_tpu_torch.models.registry import build_backbone
from esvit_tpu_torch.models.vil import MsViT as TViL
from esvit_tpu_torch.ops.resample import torch_interpolate_scale
from esvit_tpu_torch.train.step import EsViTTrainer as TTrainer
from tests.test_torch_step import TINY_GRAD, TINY_GRAD_TOL
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
NARROW = ("l1,h1,d16,n1,s1,g1,p4,f7_l2,h2,d32,n1,s1,g1,p2,f7_"
          "l3,h2,d32,n1,s0,g0,p2,f7")
SIZES = {"femto": (32, 24), "narrow": (112, 48)}


def _cfg(pkg, name, **kw):
    """The model's config from esvit_tpu.config or esvit_tpu_torch.config."""
    if name == "femto":
        return pkg.vil_femto(**kw)
    return pkg.vil_from_arch(NARROW, img_size=112, **kw)


# ViL-T's resample scales (224 px: stages 0-2 with one global token; 96
# px: every stage, stage 3 without one): (construction grid, input grid,
# global tokens).
@pytest.mark.parametrize("n0,n,g", [(56, 56, 1), (28, 28, 1), (14, 14, 1),
                                    (56, 24, 1), (28, 12, 1), (14, 6, 1),
                                    (7, 3, 0)])
def test_resample_matches_jax(n0, n, g):
    """Values and gradient. At equal sizes (the 224 px stages) the scale
    still maps the coordinates, where F.interpolate's backward would act
    as a copy."""
    scale = math.sqrt((g + n * n) / (n0 * n0))
    rng = np.random.default_rng(n0 + n)
    x = (0.02 * rng.normal(size=(1, n0, n0, 8))).astype(np.float32)
    w = rng.normal(size=(1, n, n, 8)).astype(np.float32)
    want = np.asarray(jax_resample(jnp.asarray(x), scale))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(jax_resample(a, scale) * w))(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = torch_interpolate_scale(xt, scale)
    (got * torch.from_numpy(w)).sum().backward()
    assert got.shape == want.shape == (1, n, n, 8)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL * 0.02)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def jax_models():
    out = {}
    for name, sizes in SIZES.items():
        model = JViL(_cfg(jcfg, name, fused_sc="off"))
        x = jnp.zeros((1, sizes[0], sizes[0], 3))
        params = jax.jit(lambda r: model.init({"params": r}, x))(
            jax.random.PRNGKey(0))["params"]
        out[name] = (model, jax.tree.map(np.asarray, params))
    return out


def _port(name, params):
    model = TViL(_cfg(tcfg, name))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


@pytest.mark.parametrize("name,size", [("femto", 32), ("femto", 24),
                                       ("narrow", 112), ("narrow", 48)])
def test_forward_features_matches_jax(jax_models, name, size):
    model, params = jax_models[name]
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(
        np.float32)
    j_cls, j_region = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        t_cls, t_region = _port(name, params).forward_features(
            torch.from_numpy(x))
    np.testing.assert_allclose(t_region.numpy(), np.asarray(j_region),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_cls.numpy(), np.asarray(j_cls), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", list(SIZES))
def test_state_dict_round_trip(jax_models, name):
    """flax -> port state_dict (reference names) -> torch_import -> the
    same flax tree."""
    _, params = jax_models[name]
    sd = _port(name, params).state_dict()
    assert {"layer1.0.proj.weight", "layer1.0.x_pos_embed",
            "layer1.1.attn.kv_global.weight", "layer1.2.mlp.fc1.weight",
            "layer2.1.attn.qkv.weight" if name == "femto"
            else "layer3.1.attn.qkv.weight", "norm.weight"} <= set(sd)
    back = torch_import.import_esvit_model(
        {k: v.numpy() for k, v in sd.items()}, "vil")["params"]["backbone"]
    jax.tree.map(np.testing.assert_array_equal, back, params)


@pytest.mark.parametrize("size", [224, 96])
def test_vil_tiny_sliding_chunk_calls(size):
    """ViL-T runs one sparse block in each of stages 0 and 1: two kernel
    calls per forward at every crop size, none with fused_sc='off'."""
    assert TViL(tcfg.vil_tiny()).sliding_chunk_calls(size) == 2
    assert TViL(tcfg.vil_tiny(fused_sc="off")).sliding_chunk_calls(size) == 0


def test_unported_vil_options_raise():
    """Every ViL option of esvit_tpu passes check_supported: the sampled
    modes and per-layer draws, every attention type, rpe stages and
    fused_sc='on'; only Pallas's interpreter ('interpret') is refused."""
    tcfg.check_supported(tcfg.vil_tiny_multicrop())
    rpe = tcfg.vil_from_arch("l1,h1,d48,n1,s1,g1,p4,f7,a0")
    for model in ([tcfg.vil_tiny(mode=k) for k in range(1, 9)]
                  + [tcfg.vil_tiny(mode=1, per_layer_mode=True), rpe,
                     tcfg.vil_tiny(fused_sc="on"),
                     tcfg.vil_tiny(attn_drop_rate=0.1, drop_rate=0.1, mode=1)]
                  + [tcfg.vil_tiny(attn_type=t)
                     for t in tcfg.VIL_ATTN_TYPES]):
        tcfg.check_supported(tcfg.TrainConfig(model=model))
    with pytest.raises(NotImplementedError, match="interpreter"):
        tcfg.check_supported(tcfg.TrainConfig(
            model=tcfg.vil_tiny(fused_sc="interpret")))
    assert isinstance(build_backbone(tcfg.vil_femto()), TViL)


# --- one multi-crop train step, as tests/test_torch_step.py for Swin ----

STEPS = 3


def _step_cfgs():
    common = dict(steps_per_epoch=2)
    pieces = dict(
        head=dict(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=dict(out_dim=32, warmup_teacher_temp_epochs=2),
        optim=dict(lr=1e-3, epochs=4, warmup_epochs=1,
                   freeze_last_layer_epochs=1))
    j = jcfg.TrainConfig(
        model=jcfg.vil_femto(fused_sc="off"),
        head=jcfg.HeadConfig(**pieces["head"]),
        loss=jcfg.LossConfig(**pieces["loss"]),
        optim=jcfg.OptimConfig(**pieces["optim"]), dtype=jnp.float32,
        **common)
    t = tcfg.TrainConfig(
        model=tcfg.vil_femto(), head=tcfg.HeadConfig(**pieces["head"]),
        loss=tcfg.LossConfig(**pieces["loss"]),
        optim=tcfg.OptimConfig(**pieces["optim"]), dtype=torch.float32,
        **common)
    return j, t


@pytest.fixture(scope="module")
def step_runs():
    jc, tc = _step_cfgs()
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
             rng.normal(size=(8, 24, 24, 3)).astype(np.float32))
    jt = JTrainer(jc, total_batch_size=256)
    jb = tuple(map(jnp.asarray, batch))
    state = jt.init_state(jax.random.PRNGKey(0), jb)
    step = jax.jit(jt.train_step)
    tt = TTrainer(tc, total_batch_size=256, device="cpu")
    tstate = train_state_from_jax(jax.device_get(state), tt)
    tb = tuple(map(torch.from_numpy, batch))
    jax_hist, port_hist = [], []
    for i in range(STEPS):
        state, m = step(state, jb, jax.random.PRNGKey(i + 1))
        jax_hist.append((jax.device_get(state), float(m["loss"])))
        tstate, tm = tt.train_step(tstate, tb)
        port_hist.append(({
            "student": {k: v.clone() for k, v in tstate.student.state_dict().items()},
            "teacher": {k: v.clone() for k, v in tstate.teacher.state_dict().items()},
            "mu": {k: v.clone() for k, v in tstate.mu.items()},
            "nu": {k: v.clone() for k, v in tstate.nu.items()},
            "centers": [c.clone() for c in tstate.centers]},
            float(tm["loss"])))
    return jax_hist, port_hist


@pytest.mark.parametrize("after", [1, STEPS])
def test_vil_step_matches_jax(step_runs, after):
    """Loss, centers, student, teacher and AdamW moments after 1 and 3 fp32
    steps; gradients below 1e-7 are held at 1e-4 for the reason
    tests/test_torch_step.py:31-38 gives."""
    jax_hist, port_hist = step_runs
    jstate, jloss = jax_hist[after - 1]
    port, tloss = port_hist[after - 1]
    np.testing.assert_allclose(tloss, jloss, rtol=TOL, atol=TOL)
    for a, b in zip(port["centers"], jstate.centers):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)
    nu1 = state_dict_from_flax(_adam_state(jax_hist[0][0].opt_state).nu)
    tiny = {k: np.sqrt(v.numpy() / (1 - 0.999)) < TINY_GRAD
            for k, v in nu1.items()}
    adam = _adam_state(jstate.opt_state)
    for part, tree in (("student", jstate.student), ("teacher", jstate.teacher),
                       ("mu", adam.mu), ("nu", adam.nu)):
        want = state_dict_from_flax(tree)
        assert set(want) == set(port[part])
        for name, w in want.items():
            got, w = port[part][name].numpy(), w.numpy()
            if part == "nu":
                got, w = np.sqrt(got), np.sqrt(w)
            t = tiny[name]
            np.testing.assert_allclose(got[~t], w[~t], rtol=TOL, atol=TOL,
                                       err_msg=f"{part} {name}")
            np.testing.assert_allclose(got[t], w[t], rtol=TINY_GRAD_TOL,
                                       atol=TINY_GRAD_TOL,
                                       err_msg=f"{part} {name} (tiny grad)")
