"""The port's SGD, LARS, frozen layers and AdamW with frozen layers
(esvit_tpu_torch/train/optim.py) against esvit_tpu's optax chains and
masks.

- SGD and LARS: 5 updates of ``sgd_lars_ema_apply`` against
  ``esvit_tpu.train.optim.make_optimizer``'s chain as esvit_tpu's step
  runs it unfused (train/step.py:242-257: the freezes on the gradients,
  the chain with its per-parameter clip and masked decay, the freezes on
  the updates, apply, the teacher EMA), with the last layer frozen for
  the first two; parameters, teacher and trace within 1e-6 relative.
- ``fused_adamw_ema_apply`` with a frozen-layers mask against esvit_tpu's.
- ``freeze_mask_by_prefix``: for every family and entry, the parameters
  frozen are the ones esvit_tpu's mask freezes on the bridged tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.models.esvit import EsViTModel as JModel
from esvit_tpu.train import optim as joptim
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import _trace_state, state_dict_from_flax
from esvit_tpu_torch.models.esvit import EsViTModel as TModel
from esvit_tpu_torch.train import optim as toptim
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-6
STEPS = 5
FROZEN_STEPS = 2
LRS = [1e-3, 3e-3, 2e-3, 5e-4, 1e-4]
WDS = [0.04, 0.05, 0.06, 0.07, 0.08]
EMA = 0.99
# One leaf of each kind: a decayed kernel, a bias, a LayerNorm scale, the
# head's hidden layer, its weight-norm last layer.
SHAPES = {
    ("backbone", "layers_0", "blocks_0", "attn", "qkv", "kernel"): (6, 12),
    ("backbone", "layers_0", "blocks_0", "attn", "qkv", "bias"): (12,),
    ("backbone", "norm_final", "ln", "scale"): (6,),
    ("head", "mlp_0", "kernel"): (6, 4),
    ("head", "mlp_0", "bias"): (4,),
    ("head", "last_layer", "kernel_v"): (4, 10),
    ("head", "last_layer", "scale_g"): (10,),
}
FROZEN = ("layers_0",)


def _tree(leaf):
    out = {}
    for path, shape in SHAPES.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf(path, shape)
    return out


def _draws(seed=0):
    """Initial params and STEPS gradients; every other step's gradients
    are large, so the clip at 3 acts."""
    rng = np.random.default_rng(seed)
    params = _tree(lambda p, s: rng.normal(size=s).astype(np.float32))
    grads = [_tree(lambda p, s, i=i: (rng.normal(size=s)
                                      * (20.0 if i % 2 else 0.3))
                   .astype(np.float32))
             for i in range(STEPS)]
    return params, grads


def _sd(tree):
    return {k: v.clone() for k, v in state_dict_from_flax(tree).items()}


def _run_jax(optimizer, clip, params, grads):
    cfg = jcfg.OptimConfig(optimizer=optimizer, clip_grad=clip,
                           frozen_layers=FROZEN)
    lr_fn = lambda c: jnp.asarray(LRS, jnp.float32)[c]
    wd_fn = lambda c: jnp.asarray(WDS, jnp.float32)[c]
    p = jax.tree.map(jnp.asarray, params)
    opt = joptim.make_optimizer(cfg, p, lr_fn, wd_fn, decay_scale_g=True)
    state = opt.init(p)
    teacher = p
    ll = joptim.last_layer_mask(p)
    fm = joptim.freeze_mask_by_prefix(p, FROZEN)
    for i in range(STEPS):
        frozen = jnp.asarray(i < FROZEN_STEPS)
        g = joptim.apply_last_layer_freeze(jax.tree.map(jnp.asarray, grads[i]),
                                           ll, frozen)
        g = joptim.apply_param_freeze(g, fm)
        u, state = opt.update(g, state, p)
        u = joptim.apply_param_freeze(
            joptim.apply_last_layer_freeze(u, ll, frozen), fm)
        p = jax.tree.map(lambda a, b: a + b, p, u)
        teacher = jax.tree.map(lambda t, s: t * EMA + s * (1.0 - EMA),
                               teacher, p)
    trace = _trace_state(jax.device_get(state)).trace
    return tuple(_sd(jax.device_get(t)) for t in (p, teacher, trace))


def _run_port(optimizer, clip, params, grads):
    p = _sd(params)
    names = list(p)
    teacher = {k: v.clone() for k, v in p.items()}
    trace = {k: torch.zeros_like(v) for k, v in p.items()}
    decay = toptim.wd_mask(p, decay_scale_g=True)
    ll = toptim.last_layer_mask(p)
    fm = toptim.freeze_mask_by_prefix(p, FROZEN, "swin")
    for i in range(STEPS):
        g = _sd(grads[i])
        toptim.sgd_lars_ema_apply(
            optimizer, [g[n] for n in names], [p[n] for n in names],
            [trace[n] for n in names], [teacher[n] for n in names],
            lr=float(np.float32(LRS[i])), wd=float(np.float32(WDS[i])),
            ema_m=EMA, clip=clip, decay_mask=[decay[n] for n in names],
            ll_mask=[ll[n] for n in names], frozen=i < FROZEN_STEPS,
            f_mask=[fm[n] for n in names])
    return p, teacher, trace


def _close(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        w = w.numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=TOL * scale, err_msg=f"{what} {k}")


@pytest.mark.parametrize("clip", [3.0, 0.0])
@pytest.mark.parametrize("optimizer", ["sgd", "lars"])
def test_sgd_lars_match_optax(optimizer, clip):
    params, grads = _draws()
    want = _run_jax(optimizer, clip, params, grads)
    got = _run_port(optimizer, clip, params, grads)
    for what, a, b in zip(("params", "teacher", "trace"), got, want):
        _close(a, b, what)
    # The frozen subtree never moved; the last layer moved once free.
    p = _sd(params)
    k = "layers.0.blocks.0.attn.qkv.weight"
    assert torch.equal(got[0][k], p[k])
    assert not torch.equal(got[0]["head.last_layer.weight_v"],
                           p["head.last_layer.weight_v"])


@pytest.mark.parametrize("frozen", [True, False])
def test_fused_adamw_with_frozen_layers_matches_esvit_tpu(frozen):
    params, grads = _draws(seed=1)
    cfg = jcfg.OptimConfig(clip_grad=3.0)
    p = jax.tree.map(jnp.asarray, params)
    opt = joptim.make_optimizer(cfg, p, lambda c: 1e-3, lambda c: 0.04,
                                decay_scale_g=True)
    state = opt.init(p)
    teacher = p
    masks = dict(decay_mask=joptim.wd_mask(p, decay_scale_g=True),
                 ll_mask=joptim.last_layer_mask(p),
                 f_mask=joptim.freeze_mask_by_prefix(p, FROZEN))
    tp = _sd(params)
    names = list(tp)
    tt = {k: v.clone() for k, v in tp.items()}
    mu = {k: torch.zeros_like(v) for k, v in tp.items()}
    nu = {k: torch.zeros_like(v) for k, v in tp.items()}
    decay = toptim.wd_mask(tp, decay_scale_g=True)
    ll = toptim.last_layer_mask(tp)
    fm = toptim.freeze_mask_by_prefix(tp, FROZEN, "swin")
    for i in range(STEPS):
        lr = float(np.float32(LRS[i]))
        p, teacher, state = joptim.fused_adamw_ema_apply(
            jax.tree.map(jnp.asarray, grads[i]), state, p, teacher, lr=lr,
            wd=0.04, ema_m=EMA, clip=3.0, frozen=jnp.asarray(frozen),
            **masks)
        g = _sd(grads[i])
        toptim.fused_adamw_ema_apply(
            [g[n] for n in names], [tp[n] for n in names],
            [mu[n] for n in names], [nu[n] for n in names],
            [tt[n] for n in names], count=i, lr=lr, wd=0.04, ema_m=EMA,
            clip=3.0, decay_mask=[decay[n] for n in names],
            ll_mask=[ll[n] for n in names], frozen=frozen,
            f_mask=[fm[n] for n in names])
    _close(tp, _sd(jax.device_get(p)), "params")
    _close(tt, _sd(jax.device_get(teacher)), "teacher")
    k = "layers.0.blocks.0.attn.qkv.weight"
    assert torch.equal(tp[k], _sd(params)[k])


# --- the frozen-layers mask ----------------------------------------------

FAMILIES = {
    "swin": (lambda m: m.swin_femto(), False),
    "vit": (lambda m: m.ViTConfig(img_size=32, patch_size=8, embed_dim=16,
                                  depth=2, num_heads=2), False),
    "cvt": (lambda m: m.cvt_femto(), True),
    "vil": (lambda m: m.vil_femto(), False),
    "resnet": (lambda m: m.ResNetConfig(depth=50), True),
}
ENTRIES = ["patch_embed", "layers_0", "layers_0/blocks_1", "layers.0", "*",
           "head"]
EXTRA = {"vit": ["blocks_1", "cls_token"],
         "cvt": ["embed_1", "stage0_block0/attn", "stage1_block0"],
         "vil": ["embed_0", "stage1_attn0", "stage0_mlp0/mlp"],
         "resnet": ["stem", "layer1_block0/cb2", "layer4_block2",
                    "head_dense"]}


@pytest.fixture(scope="module")
def trees():
    """Per family: the JAX param tree's shapes and the port's model."""
    out = {}
    for fam, (make, use_bn) in FAMILIES.items():
        jhead = jcfg.HeadConfig(out_dim=16, hidden_dim=8, bottleneck_dim=4,
                                use_bn=use_bn)
        thead = tcfg.HeadConfig(out_dim=16, hidden_dim=8, bottleneck_dim=4,
                                use_bn=use_bn)
        jm = JModel(make(jcfg), jhead)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), (jnp.zeros((2, 32, 32, 3)),),
            deterministic=True))["params"]
        out[fam] = (jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                 shapes), TModel(make(tcfg), thead))
    return out


@pytest.mark.parametrize("entry", ENTRIES + ["extra"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_frozen_mask_matches_esvit_tpu(trees, family, entry):
    entries = EXTRA.get(family, ["norm_final"]) if entry == "extra" else [entry]
    params, model = trees[family]
    want_tree = joptim.freeze_mask_by_prefix(params, tuple(entries))
    want = {k: bool(v) for k, v in state_dict_from_flax(jax.tree.map(
        lambda m: np.asarray(float(m)), want_tree)).items()}
    named = dict(model.named_parameters())
    got = toptim.freeze_mask_by_prefix(named, tuple(entries), family)
    assert set(got) == set(want)
    assert got == want, sorted(k for k in got if got[k] != want[k])
    if entry in ("*", "head"):
        assert any(got.values())
