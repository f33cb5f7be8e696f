"""The port's CvT backbone and train step against esvit_tpu.

Same weights and BatchNorm statistics (the JAX init, carried over by
io/jax_params.py) and the same numpy inputs through both packages, fp32.
``cvt_femto`` (windows of 4, stages of 16 and 32 channels) at 32 px
(grids 16 and 8: window multiples), 24 px (12 and 6: stage 1 pads 6 -> 8)
and 20 px (10 and 5: both stages pad), with BatchNorm on batch statistics
(``bn_train=True``, the buffers updated) and on running ones (made
non-trivial first); a two-block stage with ``shift=True``; a
reference-named state dict made with numpy, through esvit_tpu's importer
and the port's loader; a 2-step train step. Tolerance 1e-5 relative to
each output's scale (fp32 sums in another order); the running buffers
1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.io import torch_import
from esvit_tpu.models.cvt import CvT as JCvT
from esvit_tpu.train.step import EsViTTrainer as JTrainer
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import (_adam_state, state_dict_from_flax,
                                           train_state_from_jax)
from esvit_tpu_torch.io.torch_checkpoint import load_backbone_checkpoint
from esvit_tpu_torch.models.cvt import CvT as TCvT
from esvit_tpu_torch.models.registry import build_backbone
from esvit_tpu_torch.train.step import EsViTTrainer as TTrainer
from tests.test_torch_step import TINY_GRAD, TINY_GRAD_TOL
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
BUF_TOL = 1e-6


def _shifted(pkg):
    """One stage of two blocks with shift=True (block 1 shifted), 16 px
    grid at 32 px input, window 4."""
    return pkg.CvTConfig(img_size=32, stages=(
        pkg.CvTStageConfig(patch_size=3, patch_stride=2, patch_padding=1,
                           embed_dim=16, depth=2, num_heads=2, window_size=4,
                           shift=True),))


CONFIGS = {"femto": lambda pkg: pkg.cvt_femto(img_size=32),
           "shifted": _shifted}


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_models():
    """(model, params, batch_stats) with running statistics moved off their
    initial 0 / 1, so that bn_train=False reads them."""
    out = {}
    for name, make in CONFIGS.items():
        model = JCvT(make(jcfg))
        x = jnp.zeros((1, 32, 32, 3))
        v = jax.jit(lambda r: model.init({"params": r}, x))(
            jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)
        stats = jax.tree.map(
            lambda a: (rng.uniform(0.5, 2.0, a.shape) if a.ndim and
                       np.all(np.asarray(a) == 1.0)
                       else rng.normal(0, 0.3, a.shape)).astype(np.float32),
            _numpy(v["batch_stats"]))
        out[name] = (model, _numpy(v["params"]), stats)
    return out


def _port(name, params, stats):
    model = TCvT(CONFIGS[name](tcfg))
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return model


def scaled_close(got, want, tol=TOL, what=""):
    """max |got - want| within ``tol`` of want's largest |value|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


@functools.lru_cache(maxsize=None)
def _jitted(model, bn_train, method, n):
    kw = {} if n is None else {"n": n}
    return jax.jit(lambda v, x: model.apply(
        v, x, deterministic=True, bn_train=bn_train,
        mutable=["batch_stats"], method=method, **kw))


def _jax_apply(model, params, stats, x, bn_train, method=None, n=None):
    """(output, new batch_stats) of the JAX model."""
    out, upd = _jitted(model, bn_train, method, n)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    return out, _numpy(upd["batch_stats"])


def _buffers(model):
    return {k: v.numpy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("bn_train", [False, True])
@pytest.mark.parametrize("size", [32, 24, 20])
def test_forward_features_matches_jax(jax_models, size, bn_train):
    """24 and 20 px give grids that are not window multiples: the padded
    keys take part in the softmax, unmasked, in both."""
    model, params, stats = jax_models["femto"]
    x = np.random.default_rng(size).normal(size=(3, size, size, 3)).astype(
        np.float32)
    (j_cls, j_region), j_stats = _jax_apply(model, params, stats, x, bn_train)
    port = _port("femto", params, stats)
    with torch.no_grad():
        t_cls, t_region = port.forward_features(torch.from_numpy(x),
                                                bn_train=bn_train)
    scaled_close(t_region.numpy(), j_region, what="region")
    scaled_close(t_cls.numpy(), j_cls, what="cls")
    want = state_dict_from_flax({}, j_stats)
    got = _buffers(port)
    assert set(got) == set(want) and len(got) == 4
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w.numpy(), rtol=BUF_TOL,
                                   atol=BUF_TOL, err_msg=k)
        if not bn_train:
            np.testing.assert_array_equal(got[k], w.numpy())


@pytest.mark.parametrize("bn_train", [False, True])
def test_shifted_stage_matches_jax(jax_models, bn_train):
    model, params, stats = jax_models["shifted"]
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    (_, j_region), _ = _jax_apply(model, params, stats, x, bn_train)
    port = _port("shifted", params, stats)
    assert port.stage0[1].layers[1].mask(16, 16, "cpu") is not None
    assert port.stage0[1].layers[0].mask(16, 16, "cpu") is None
    with torch.no_grad():
        t_region = port.forward_features(torch.from_numpy(x),
                                         bn_train=bn_train)[1]
    scaled_close(t_region.numpy(), j_region)


@pytest.mark.parametrize("n", [1, 2])
def test_n_last_blocks_matches_jax(jax_models, n):
    model, params, stats = jax_models["femto"]
    x = np.random.default_rng(n).normal(size=(2, 24, 24, 3)).astype(
        np.float32)
    want, _ = _jax_apply(model, params, stats, x, False,
                         method=JCvT.forward_return_n_last_blocks, n=n)
    with torch.no_grad():
        got = _port("femto", params, stats).forward_return_n_last_blocks(
            torch.from_numpy(x), n)
    assert got.shape == (2, {1: 32, 2: 48}[n])
    scaled_close(got.numpy(), want)


def test_buffers_after_two_calls_match_jax(jax_models):
    """Two bn_train forwards (a 32 px and a 24 px group, as the student's
    two resolution groups) update the running buffers one after the
    other; the running variance takes the biased batch variance."""
    model, params, stats = jax_models["femto"]
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(4, s, s, 3)).astype(np.float32) for s in (32, 24)]
    port = _port("femto", params, stats)
    j_stats = stats
    for x in xs:
        _, j_stats = _jax_apply(model, params, j_stats, x, True)
        with torch.no_grad():
            port.forward_features(torch.from_numpy(x), bn_train=True)
    want = state_dict_from_flax({}, j_stats)
    got = _buffers(port)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w.numpy(), rtol=BUF_TOL,
                                   atol=BUF_TOL, err_msg=k)
    first = {k: v.numpy() for k, v in state_dict_from_flax({}, stats).items()}
    assert all(np.abs(got[k] - first[k]).max() > 1e-3 for k in got)


def _reference_state_dict(cfg, rng):
    """A state dict with the reference cvt_v4_transformer's names and
    shapes, made with numpy, with num_batches_tracked and the DINO heads'
    entries that loading skips."""
    sd = {}
    cin = 3
    for i, st in enumerate(cfg.stages):
        C, k = st.embed_dim, st.patch_size
        sd[f"stage{i}.0.proj.weight"] = rng.normal(0, .2, (C, cin, k, k))
        sd[f"stage{i}.0.proj.bias"] = rng.normal(0, .1, C)
        sd[f"stage{i}.0.norm.weight"] = rng.uniform(.5, 1.5, C)
        sd[f"stage{i}.0.norm.bias"] = rng.normal(0, .1, C)
        for j in range(st.depth):
            b = f"stage{i}.1.layers.{j}"
            kq, H = st.kernel_qkv, int(C * st.mlp_ratio)
            sd[f"{b}.0.norm.weight"] = rng.uniform(.5, 1.5, C)
            sd[f"{b}.0.norm.bias"] = rng.normal(0, .1, C)
            sd[f"{b}.0.fn.qkv.dw.weight"] = rng.normal(0, .3, (C, 1, kq, kq))
            sd[f"{b}.0.fn.qkv.bn.weight"] = rng.uniform(.5, 1.5, C)
            sd[f"{b}.0.fn.qkv.bn.bias"] = rng.normal(0, .1, C)
            sd[f"{b}.0.fn.qkv.bn.running_mean"] = rng.normal(0, .3, C)
            sd[f"{b}.0.fn.qkv.bn.running_var"] = rng.uniform(.5, 2, C)
            sd[f"{b}.0.fn.qkv.bn.num_batches_tracked"] = np.array(7)
            sd[f"{b}.0.fn.qkv.pw.weight"] = rng.normal(0, .2, (3 * C, C, 1, 1))
            sd[f"{b}.0.fn.qkv.pw.bias"] = rng.normal(0, .1, 3 * C)
            sd[f"{b}.0.fn.proj_out.weight"] = rng.normal(0, .2, (C, C, 1, 1))
            sd[f"{b}.0.fn.proj_out.bias"] = rng.normal(0, .1, C)
            sd[f"{b}.1.norm.weight"] = rng.uniform(.5, 1.5, C)
            sd[f"{b}.1.norm.bias"] = rng.normal(0, .1, C)
            sd[f"{b}.1.fn.net.0.weight"] = rng.normal(0, .2, (H, C, 1, 1))
            sd[f"{b}.1.fn.net.0.bias"] = rng.normal(0, .1, H)
            sd[f"{b}.1.fn.net.2.weight"] = rng.normal(0, .1, (C, H, 1, 1))
            sd[f"{b}.1.fn.net.2.bias"] = rng.normal(0, .1, C)
        cin = C
    C = cfg.stages[-1].embed_dim
    sd["norm.weight"] = rng.uniform(.5, 1.5, C)
    sd["norm.bias"] = rng.normal(0, .1, C)
    sd["head.mlp.0.weight"] = rng.normal(size=(8, C))
    sd["head_dense.last_layer.weight_g"] = np.ones((8, 1))
    return {k: np.asarray(v, np.float32 if v.dtype.kind == "f" else v.dtype)
            for k, v in sd.items()}


@pytest.mark.parametrize("key", ["teacher", "student"])
def test_reference_checkpoint_loads_as_in_jax(tmp_path, key):
    """A reference-named .pth through esvit_tpu's import_cvt_backbone into
    JAX and through the port's load_backbone_checkpoint (strict): the
    same features, on running statistics and on batch ones."""
    cfg_j, cfg_t = jcfg.cvt_femto(), tcfg.cvt_femto()
    sd = _reference_state_dict(cfg_j, np.random.default_rng(4))
    other = _reference_state_dict(cfg_j, np.random.default_rng(9))
    ckpt = {"teacher": {f"module.{k}": torch.from_numpy(v)
                        for k, v in (sd if key == "teacher" else other).items()},
            "student": {k: torch.from_numpy(v)
                        for k, v in (sd if key == "student" else other).items()},
            "epoch": 3}
    torch.save(ckpt, tmp_path / "checkpoint.pth")
    imported = torch_import.import_cvt_backbone(sd)
    port = load_backbone_checkpoint(TCvT(cfg_t), str(tmp_path /
                                                     "checkpoint.pth"), key)
    x = np.random.default_rng(6).normal(size=(2, 24, 24, 3)).astype(
        np.float32)
    for bn_train in (False, True):
        (_, want), _ = _jax_apply(JCvT(cfg_j), imported["params"],
                                  imported["batch_stats"], x, bn_train)
        with torch.no_grad():
            got = port.forward_features(torch.from_numpy(x),
                                        bn_train=bn_train)[1]
        scaled_close(got.numpy(), want, what=f"bn_train={bn_train}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_dict_round_trip(jax_models, name):
    """flax -> the port's state dict (reference names) -> torch_import ->
    the same flax params and batch_stats."""
    _, params, stats = jax_models[name]
    sd = _port(name, params, stats).state_dict()
    assert {"stage0.0.proj.weight", "stage0.0.norm.weight",
            "stage0.1.layers.0.0.fn.qkv.dw.weight",
            "stage0.1.layers.0.0.fn.qkv.bn.running_var",
            "stage0.1.layers.0.0.fn.qkv.pw.weight",
            "stage0.1.layers.0.0.fn.proj_out.bias",
            "stage0.1.layers.0.1.fn.net.2.weight", "norm.bias"} <= set(sd)
    assert sd["stage0.1.layers.0.0.fn.qkv.dw.weight"].shape == (16, 1, 3, 3)
    assert sd["stage0.1.layers.0.1.fn.net.0.weight"].shape == (64, 16, 1, 1)
    back = torch_import.import_cvt_backbone({k: v.numpy()
                                             for k, v in sd.items()})
    jax.tree.map(np.testing.assert_array_equal, back["params"], params)
    jax.tree.map(np.testing.assert_array_equal, back["batch_stats"], stats)


def test_drop_path_rates_and_presets_match_jax():
    """Drop-path rates: a linspace over the total depth up to stage 0's
    rate; cvt_tiny's parameters and buffers have JAX's shapes."""
    t = TCvT(tcfg.cvt_tiny())
    rates = [blk.drop_path.rate for i in range(4)
             for blk in getattr(t, f"stage{i}")[1].layers]
    np.testing.assert_allclose(rates, np.linspace(0, 0.1, 12))
    v = jax.eval_shape(lambda: JCvT(jcfg.cvt_tiny()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    want = state_dict_from_flax(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), v["params"]),
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                     v["batch_stats"]))
    got = t.state_dict()
    assert {k: tuple(x.shape) for k, x in got.items()} == \
        {k: tuple(x.shape) for k, x in want.items()}
    tcfg.check_supported(tcfg.cvt_tiny_multicrop())
    assert isinstance(build_backbone(tcfg.cvt_femto()), TCvT)


def test_weight_decay_mask_matches_jax(jax_models):
    """AdamW's decay mask: the 4-D conv kernels (the depthwise ones too)
    decayed, BatchNorm's and LayerNorm's scales and every bias not, as
    esvit_tpu/train/optim.py:31-48 decides on the flax tree."""
    from esvit_tpu.train import optim as joptim
    from esvit_tpu_torch.train import optim as toptim

    _, params, stats = jax_models["femto"]
    want = state_dict_from_flax(jax.tree.map(
        lambda d: np.float32(d), joptim.wd_mask(params)))
    got = toptim.wd_mask(dict(_port("femto", params, stats)
                              .named_parameters()))
    assert set(got) == set(want)
    assert {k: bool(v) for k, v in want.items()} == got
    assert got["stage0.1.layers.0.0.fn.qkv.dw.weight"]
    assert not got["stage0.1.layers.0.0.fn.qkv.bn.weight"]


def drop_path_draws(block, x, rate):
    """The keep masks ``block``'s DropPath draws in one training forward of
    x (a CPU generator), checked by distribution: two draws (one per
    residual), each keeping 1 - rate of the samples within 4 sigma, and
    independent of each other (both kept in (1 - rate)^2 of them)."""
    masks = []
    draw = block.drop_path.keep_mask

    def record(*a, **kw):
        masks.append(draw(*a, **kw))
        return masks[-1]

    block.drop_path.keep_mask = record
    with torch.no_grad():
        block(x, deterministic=False,
              generator=torch.Generator().manual_seed(0))
    n, p = x.shape[0], 1.0 - rate
    assert len(masks) == 2 and all(m.shape == (n,) for m in masks)
    for q, m in ((p, masks[0]), (p, masks[1]), (p * p, masks[0] & masks[1])):
        assert abs(m.float().mean().item() - q) <= 4 * np.sqrt(q * (1 - q) / n)
    return masks


def test_cvt_block_draws_one_drop_path_twice():
    from esvit_tpu_torch.models.cvt import CvTBlock

    st = tcfg.CvTStageConfig(embed_dim=16, num_heads=2, window_size=4)
    blk = CvTBlock(st, 0.4, 1e-5, shift=False,
                   generator=torch.Generator().manual_seed(0))
    x = torch.randn(1024, 4, 4, 16, generator=torch.Generator().manual_seed(1))
    drop_path_draws(blk, x, 0.4)


# --- a 2-step multi-crop train step, as tests/test_torch_step.py for Swin

STEPS = 2


def _step_cfgs(j_model, t_model, b_local=None):
    pieces = dict(
        head=dict(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=dict(out_dim=32, warmup_teacher_temp_epochs=2),
        optim=dict(lr=1e-3, epochs=4, warmup_epochs=1,
                   freeze_last_layer_epochs=1))
    j = jcfg.TrainConfig(
        model=j_model, head=jcfg.HeadConfig(**pieces["head"]),
        loss=jcfg.LossConfig(**pieces["loss"]),
        optim=jcfg.OptimConfig(**pieces["optim"]), dtype=jnp.float32,
        steps_per_epoch=2)
    t = tcfg.TrainConfig(
        model=t_model, head=tcfg.HeadConfig(**pieces["head"]),
        loss=tcfg.LossConfig(**pieces["loss"]),
        optim=tcfg.OptimConfig(**pieces["optim"]), dtype=torch.float32,
        steps_per_epoch=2)
    return j, t


def run_steps(j_model, t_model, sizes, steps=STEPS):
    """esvit_tpu's jitted train_step and the port's from one state on one
    numpy batch (B=4, 2 global + 2 local views): per step, (JAX state,
    loss) and (the port's snapshot, loss)."""
    jc, tc = _step_cfgs(j_model, t_model)
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(8, sizes[0], sizes[0], 3)).astype(np.float32),
             rng.normal(size=(8, sizes[1], sizes[1], 3)).astype(np.float32))
    jt = JTrainer(jc, total_batch_size=256)
    jb = tuple(map(jnp.asarray, batch))
    state = jt.init_state(jax.random.PRNGKey(0), jb)
    step = jax.jit(jt.train_step)
    tt = TTrainer(tc, total_batch_size=256, device="cpu")
    tstate = train_state_from_jax(jax.device_get(state), tt)
    tb = tuple(map(torch.from_numpy, batch))
    jax_hist, port_hist = [], []
    for i in range(steps):
        state, m = step(state, jb, jax.random.PRNGKey(i + 1))
        jax_hist.append((jax.device_get(state), float(m["loss"])))
        tstate, tm = tt.train_step(tstate, tb)
        port_hist.append(({
            "student": {k: v.clone() for k, v in
                        tstate.student.state_dict().items()},
            "teacher": {k: v.clone() for k, v in
                        tstate.teacher.state_dict().items()},
            "mu": {k: v.clone() for k, v in tstate.mu.items()},
            "nu": {k: v.clone() for k, v in tstate.nu.items()},
            "centers": [c.clone() for c in tstate.centers]},
            float(tm["loss"])))
    return jax_hist, port_hist


def check_step(jax_hist, port_hist, after):
    """Loss, centers, student and teacher (parameters and BatchNorm
    buffers) and both AdamW moments after ``after`` steps, 1e-5; weights
    whose gradient is below 1e-7 are held at 1e-4, for the reason
    tests/test_torch_step.py:31-38 gives."""
    jstate, jloss = jax_hist[after - 1]
    port, tloss = port_hist[after - 1]
    np.testing.assert_allclose(tloss, jloss, rtol=TOL, atol=TOL)
    for a, b in zip(port["centers"], jstate.centers):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    nu1 = state_dict_from_flax(_adam_state(jax_hist[0][0].opt_state).nu)
    tiny = {k: np.sqrt(v.numpy() / (1 - 0.999)) < TINY_GRAD
            for k, v in nu1.items()}
    adam = _adam_state(jstate.opt_state)
    buffers = 0
    for part, tree, stats in (
            ("student", jstate.student, jstate.student_state),
            ("teacher", jstate.teacher, jstate.teacher_state),
            ("mu", adam.mu, None), ("nu", adam.nu, None)):
        want = state_dict_from_flax(tree, (stats or {}).get("batch_stats"))
        assert set(want) == set(port[part]), part
        for name, w in want.items():
            got, w = port[part][name].numpy(), w.numpy()
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got, w, rtol=BUF_TOL, atol=BUF_TOL,
                                           err_msg=f"{part} {name}")
                buffers += 1
                continue
            if part == "nu":
                got, w = np.sqrt(got), np.sqrt(w)
            t = tiny[name]
            np.testing.assert_allclose(got[~t], w[~t], rtol=TOL, atol=TOL,
                                       err_msg=f"{part} {name}")
            np.testing.assert_allclose(got[t], w[t], rtol=TINY_GRAD_TOL,
                                       atol=TINY_GRAD_TOL,
                                       err_msg=f"{part} {name} (tiny grad)")
    return buffers


@pytest.fixture(scope="module")
def cvt_steps():
    return run_steps(jcfg.cvt_femto(), tcfg.cvt_femto(), (32, 24))


@pytest.mark.parametrize("after", [1, STEPS])
def test_cvt_step_matches_jax(cvt_steps, after):
    """The student's BN buffers moved through both resolution groups, the
    teacher's through its own global-view forward: each net's own, and
    they differ."""
    jax_hist, port_hist = cvt_steps
    assert check_step(jax_hist, port_hist, after) == 8
    port = port_hist[after - 1][0]
    name = "stage1.1.layers.0.0.fn.qkv.bn.running_var"
    assert (port["student"][name] - port["teacher"][name]).abs().max() > 1e-4
