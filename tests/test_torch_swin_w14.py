"""Swin at W=14 (EsViT's published best Swin) in the port, on the CPU.

What the card's routes rest on, checked here without a card:

- the block-fused kernels' shape rule admits every Swin-T / Swin-S /
  Swin-B W=14 block that ``esvit_tpu.ops.fused_block.supports`` admits,
  Swin-B's C=512 stage 2 included, and every Swin-S / Swin-B block of
  stages 0-2 at W=7;
- Swin-T's W=14 routes at 224 and 96 px, and the block-fused launches a
  train step derives (30 forward, 20 backward: 22 / 12 at N=196, 2 / 2 on
  the augmented N=145, 6 / 6 on the augmented N=37), through the same
  helpers chip_smoke.py holds the card's counts with;
- each attention site asks its kernel's own ``supports()``: at N=196 the
  packed route and the qkv-layout route each call their kernel entry
  (both take N <= 256 on the large-window tile);
- fp32 parity with esvit_tpu's XLA route (attention_impl='xla', no fused
  stages) at femto width with W=14 (C 32 / 64, head dim 16, so the fused
  stages take their kernels' shapes): ``forward_features`` at 112 px (4
  windows of 196 tokens at stage 0, one at stage 1) and 48 px (the
  augmented windows of 145 and 37 tokens) on the port's fused, packed and
  qkv-layout routes, 1e-4 as tests/test_torch_swin.py, with every fused
  call recorded at N=196 / 145 / 37; and one multi-crop train step (2 x
  112 + 2 x 48 crops) on the fused route against esvit_tpu's trainer from
  the same state: loss, student, teacher, AdamW moments and centres
  within tests/test_torch_step.py's 1e-5; and esvit_tpu's block-fused
  kernel itself, in interpret mode, on one window of 196 tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from esvit_tpu import config as jcfg
from esvit_tpu.models.swin import SwinTransformer as JSwin
from esvit_tpu.ops import fused_block as jfb
from esvit_tpu.train.step import EsViTTrainer as JTrainer
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import (_adam_state, state_dict_from_flax,
                                           train_state_from_jax)
from esvit_tpu_torch.models import swin as tswin
from esvit_tpu_torch.models.registry import build_backbone
from esvit_tpu_torch.models.swin import SwinTransformer as TSwin
from esvit_tpu_torch.ops import fused_block as tfb
from esvit_tpu_torch.train.step import EsViTTrainer as TTrainer
from tests import test_torch_fused_block as fused_cases
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-4
STEP_TOL = 1e-5
# tests/test_torch_step.py's rule for gradients below 1e-7 (the key bias:
# fp32 noise that Adam's update turns into a step of up to lr).
TINY_GRAD, TINY_GRAD_TOL = 1e-7, 1e-4
# Femto at W=14: stage 0 at 28 x 28 tokens (112 px), shifted; stage 1 one
# 14 x 14 window (its construction-time resolution equals the window, so
# no shift). C 32 / 64 with head dim 16 and MLP 128 / 256: shapes the
# block-fused kernels take.
FEMTO = dict(img_size=112, embed_dim=32, num_heads=(2, 4), window_size=14,
             drop_path_rate=0.0)
HEAD = dict(out_dim=32, hidden_dim=16, bottleneck_dim=8)


def _swin_shapes(arch, size, window_size=14):
    """(stage, N, C, nH, M, nW, L_padded) of each stage of a Swin at
    ``window_size`` and ``size`` px whose windows esvit_tpu's fused rule is
    asked about: a full window stage (ws x ws windows, nW of them, L = nW
    * Np) or a single padded window (the augmented H*W + 1 tokens, one
    window)."""
    cfg = getattr(tcfg, arch)(window_size=window_size)
    out = []
    H = size // cfg.patch_size
    for i, nH in enumerate(cfg.num_heads[:3]):
        C = cfg.embed_dim * 2 ** i
        res = cfg.img_size // cfg.patch_size // 2 ** i
        ws = min(cfg.window_size, res)
        Hp = -(-H // ws) * ws
        if Hp == ws and H < ws:
            N, nW = H * H + 1, 1
        else:
            N, nW = ws * ws, (Hp // ws) ** 2
        out.append((i, N, C, nH, int(C * cfg.mlp_ratio), nW,
                    nW * (-(-N // 8) * 8)))
        H = (H + 1) // 2
    return out


SHAPE_CASES = [(arch, size, stage)
               for arch in ("swin_tiny", "swin_small", "swin_base")
               for size in (224, 96) for stage in range(3)]


@pytest.mark.parametrize("arch,size,stage", SHAPE_CASES)
def test_fused_rule_admits_what_esvit_tpu_admits(arch, size, stage):
    """esvit_tpu admits every W=14 block of stages 0-2 (B = the step's
    images at that size); so does the port, Swin-B's C = 512 stage 2
    included."""
    _, N, C, nH, M, nW, L = _swin_shapes(arch, size)[stage]
    B = 64 if size == 224 else 256
    assert N in (196, 145, 37)
    assert jfb.supports(B, L, N, nH, nW, C=C, M=M)
    assert tfb.supports(N, C, nH, M)


@pytest.mark.parametrize("arch,size,stage", [
    (arch, size, stage) for arch in ("swin_small", "swin_base")
    for size in (224, 96) for stage in range(3)])
def test_fused_rule_admits_what_esvit_tpu_admits_at_w7(arch, size, stage):
    """The W=7 twin for Swin-S and Swin-B (C = 384 and 512 at stage 2):
    esvit_tpu admits every block of stages 0-2 at the Swin-T recipe's
    images and at Swin-B's B=8 (2B at 224 px, 8B at 96), N = 49 windows
    and the 96 px stage 2's augmented 37; the port admits each."""
    _, N, C, nH, M, nW, L = _swin_shapes(arch, size, window_size=7)[stage]
    assert N in (49, 37)
    for B in ((64, 16) if size == 224 else (256, 64)):
        assert jfb.supports(B, L, N, nH, nW, C=C, M=M)
    assert tfb.supports(N, C, nH, M)


@pytest.mark.parametrize("size,routes", [
    (224, ["fused", "fused", "fused", "window_major"]),
    (96, ["fused", "fused_subwindow", "fused_subwindow", "classic"]),
])
def test_w14_routes(size, routes):
    """Swin-T W=14: stages 0-2 fused (at 96 px stage 0 padded from 24 to 28
    tokens a side, stages 1-2 the augmented windows); stage 3 has W=7 (its
    resolution), one full window at 224 px (the packed kernel, N=49) and
    an augmented one at 96 px (the plain sub-window path, N=10)."""
    model = build_backbone(tcfg.swin_tiny(window_size=14))
    got = [(stage.window_size, route)
           for stage, _, route in model._stage_routes(size)]
    assert got == list(zip([14, 14, 14, 7], routes))


def test_w14_step_launches_as_derived():
    """The counts chip_smoke.py holds the card's W=14 step to: 30 forward
    and 20 backward block-fused launches, 22 / 12 at N=196, 2 / 2 at
    N=145 and 6 / 6 at N=37; 4 / 2 packed launches (stage 3 at 224 px);
    no kernel on the plain route."""
    base = tcfg.swin_tiny_multicrop(32)
    kernel = base.replace(model=tcfg.swin_tiny(window_size=14))
    plain = base.replace(model=tcfg.swin_tiny(
        window_size=14, fused_block_stages=(), attention_impl="xla"))
    want = chip_smoke._derived_launches(kernel, 1)
    assert want["fused_block"] == {"fwd": 30, "bwd": 20}
    assert want["window_attention"] == {"fwd": 4, "bwd": 2}
    assert want["pallas_window_attention"] == {"fwd": 0}
    assert chip_smoke._fused_n_split(kernel) == {
        "fwd": {196: 22, 145: 2, 37: 6}, "bwd": {196: 12, 145: 2, 37: 6}}
    assert all(v == 0 for kinds in chip_smoke._derived_launches(
        plain, 1).values() for v in kinds.values())


def _record(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapper(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    monkeypatch.setattr(module, name, wrapper)
    return calls


def _femto(**kw):
    return tcfg.swin_femto(**dict(FEMTO, **kw))


@pytest.mark.parametrize("attention_impl,entry,plain", [
    ("packed", "window_attention", "window_attention_plain"),
    ("pallas", "fused_window_attention", "pallas_window_attention_plain"),
])
def test_attention_site_asks_its_kernels_rule(monkeypatch, attention_impl,
                                              entry, plain):
    """At N=196 each route calls its kernel entry and never the plain
    version: both the packed pair's rule and the qkv-layout kernel's take
    N <= 256 on the large-window tile."""
    model = TSwin(_femto(attention_impl=attention_impl,
                         fused_block_stages=()),
                  generator=torch.Generator().manual_seed(0))
    kernel_calls = _record(monkeypatch, tswin, entry)
    plain_calls = _record(monkeypatch, tswin, plain)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 112, 112, 3)).astype(np.float32))
    with torch.no_grad():
        model.forward_features(x)
    assert len(kernel_calls) == 4 and not plain_calls
    if attention_impl == "packed":
        assert all(a[5] == 196 for a, _ in kernel_calls)      # N
    else:
        assert all(a[0].shape[1] == 196 for a, _ in kernel_calls)
    assert len(kernel_calls) == model.window_attention_calls(112) + \
        model.pallas_window_attention_calls(112)


@pytest.mark.parametrize("attention_impl,module,entry,plain", [
    ("packed", "wa", "window_attention", "window_attention_plain"),
    ("pallas", "pwa", "fused_window_attention",
     "pallas_window_attention_plain"),
])
def test_refused_shape_takes_the_plain_version(monkeypatch, attention_impl,
                                               module, entry, plain):
    """Where the kernel's rule refuses (here made to refuse every shape),
    the site takes that kernel's plain version by its admission check and
    the model derives no launch."""
    monkeypatch.setattr(getattr(tswin, module), "supports",
                        lambda *a: False)
    model = TSwin(tcfg.swin_femto(attention_impl=attention_impl,
                                  fused_block_stages=()),
                  generator=torch.Generator().manual_seed(0))
    kernel_calls = _record(monkeypatch, tswin, entry)
    plain_calls = _record(monkeypatch, tswin, plain)
    with torch.no_grad():
        model.forward_features(torch.zeros(1, 32, 32, 3))
    assert not kernel_calls and plain_calls
    assert model.window_attention_calls(32) == 0
    assert model.pallas_window_attention_calls(32) == 0


@pytest.fixture(scope="module")
def jax_backbone():
    """esvit_tpu's femto W=14 on its XLA route, weights from its jitted
    init, and a jitted forward_features."""
    model = JSwin(jcfg.swin_femto(attention_impl="xla", fused_block_stages=(),
                                  **FEMTO))
    x = jnp.zeros((1, 112, 112, 3), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x)["params"]
    forward = jax.jit(lambda p, x: model.apply({"params": p}, x))
    return jax.tree.map(np.asarray, params), forward


@pytest.mark.parametrize("size", [112, 48])
@pytest.mark.parametrize("route", [
    {}, {"fused_block_stages": ()},
    {"attention_impl": "pallas", "fused_block_stages": ()}])
def test_forward_features_matches_jax(monkeypatch, jax_backbone, size, route):
    """The port's fused route (fused_swin_block_plain on the CPU: N=196 at
    112 px, the augmented 145 and 37 at 48 px), its packed route and its
    qkv-layout route against esvit_tpu's XLA route, fp32, same weights."""
    params, forward = jax_backbone
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(
        np.float32)
    j_cls, j_region = forward(params, jnp.asarray(x))
    model = TSwin(_femto(**route))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    fused = _record(monkeypatch, tfb, "fused_swin_block_plain")
    with torch.no_grad():
        t_cls, t_region = model.forward_features(torch.from_numpy(x))
    np.testing.assert_allclose(t_region.numpy(), np.asarray(j_region),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_cls.numpy(), np.asarray(j_cls),
                               rtol=TOL, atol=TOL)
    want = ({112: [196] * 4, 48: [145] * 2 + [37] * 2}[size]
            if not route else [])
    assert [kw["N"] for _, kw in fused] == want
    assert len(fused) == model.fused_block_calls(size)


def _step_cfgs():
    common = dict(steps_per_epoch=2)
    crops = dict(global_size=112, local_size=48, local_crops_number=2)
    j = jcfg.TrainConfig(
        model=jcfg.swin_femto(attention_impl="xla", fused_block_stages=(),
                              **FEMTO),
        head=jcfg.HeadConfig(**HEAD), crops=jcfg.CropConfig(**crops),
        loss=jcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=2),
        optim=jcfg.OptimConfig(lr=1e-3, epochs=4, warmup_epochs=1,
                               freeze_last_layer_epochs=1),
        dtype=jnp.float32, **common)
    t = tcfg.TrainConfig(
        model=_femto(), head=tcfg.HeadConfig(**HEAD),
        crops=tcfg.CropConfig(**crops),
        loss=tcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=2),
        optim=tcfg.OptimConfig(lr=1e-3, epochs=4, warmup_epochs=1,
                               freeze_last_layer_epochs=1),
        dtype=torch.float32, **common)
    return j, t


def test_multicrop_step_matches_jax(monkeypatch):
    """One fp32 step of the multi-crop DDINO trainer (2 x 112 + 2 x 48
    crops, B=2) on the port's fused route against esvit_tpu's XLA route
    from the same state: the loss, both nets, the AdamW moments (the
    gradients) and the centres within 1e-5; the 48 px locals' stage 0
    runs the block-fused function on the augmented window of 145 tokens."""
    jc, tc = _step_cfgs()
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(4, 112, 112, 3)).astype(np.float32),
             rng.normal(size=(4, 48, 48, 3)).astype(np.float32))
    jt = JTrainer(jc, total_batch_size=256)
    jb = tuple(map(jnp.asarray, batch))
    state = jt.init_state(jax.random.PRNGKey(0), jb)
    tt = TTrainer(tc, total_batch_size=256, device="cpu")
    tstate = train_state_from_jax(jax.device_get(state), tt)
    state, m = jax.jit(jt.train_step)(state, jb, jax.random.PRNGKey(1))
    jstate = jax.device_get(state)
    fused = _record(monkeypatch, tfb, "fused_swin_block_plain")
    tstate, tm = tt.train_step(tstate, tuple(map(torch.from_numpy, batch)))
    assert sorted({kw["N"] for _, kw in fused}) == [37, 145, 196]
    np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                               rtol=STEP_TOL, atol=STEP_TOL)
    for a, b in zip(tstate.centers, jstate.centers):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=STEP_TOL,
                                   atol=STEP_TOL)
    adam = _adam_state(jstate.opt_state)
    g = {k: np.sqrt(v.numpy() / (1 - 0.999))
         for k, v in state_dict_from_flax(adam.nu).items()}
    ports = {"student": tstate.student.state_dict(),
             "teacher": tstate.teacher.state_dict(),
             "mu": tstate.mu, "nu": tstate.nu}
    for part, tree in (("student", jstate.student), ("teacher", jstate.teacher),
                       ("mu", adam.mu), ("nu", adam.nu)):
        want = state_dict_from_flax(tree)
        assert set(want) == set(ports[part])
        for name, w in want.items():
            got, w = ports[part][name].numpy(), w.numpy()
            if part == "nu":
                got, w = np.sqrt(got), np.sqrt(w)
            tiny = g[name] < TINY_GRAD
            np.testing.assert_allclose(got[~tiny], w[~tiny], rtol=STEP_TOL,
                                       atol=STEP_TOL, err_msg=f"{part} {name}")
            np.testing.assert_allclose(got[tiny], w[tiny], rtol=TINY_GRAD_TOL,
                                       atol=TINY_GRAD_TOL,
                                       err_msg=f"{part} {name} (tiny)")


def test_femto_w14_shapes_take_the_fused_kernels():
    """The femto model's W=14 blocks are shapes the block-fused kernels
    take, so its CPU tests run the function the card's kernels compute."""
    model = TSwin(_femto())
    for size, want in ((112, ["fused", "fused"]),
                       (48, ["fused_subwindow", "fused_subwindow"])):
        assert [r for _, _, r in model._stage_routes(size)] == want
    for stage in model.layers:
        assert stage.window_size == 14
        assert tfb.supports(196, stage.dim, stage.num_heads, stage.hidden)


def test_fused_plain_matches_jax_interpret_kernel_at_n196():
    """esvit_tpu's block-fused Pallas kernel in interpret mode on one 14 x
    14 window (N=196, padded to 200 rows there) against the port's
    fused_swin_block_plain: the output, dx and all 17 parameter gradients,
    at tests/test_torch_fused_block.py's kernel-level tolerances (its
    case, at W=14; ~6 s on one worker)."""
    fused_cases.test_fused_block_plain_matches_jax_kernel(
        1, 14, 14, 32, 2, False, False, False)
