"""The port's train step with each training option against esvit_tpu's
EsViTTrainer.train_step, and the options' own properties.

The options run, two at a time with an optimizer, two fp32 steps of
swin_femto (8 global crops of 32 px: the streamed loss's two crop sizes
are tests/test_torch_streamed_loss.py's; drop-path off, lr at its peak
from step 0, the last layer free) from esvit_tpu's initial state bridged
into the port: the K-streamed loss with BatchNorm heads under LARS, and
``remat='block'`` with ``frozen_layers`` under SGD (two runs rather than
six keep the JAX compiles inside the suite's time; SGD and LARS hold
no moment that turns rounding noise into steps, so 1e-5 holds on every
element). After each step the loss, student, teacher, both nets'
BatchNorm buffers, the optimizer's trace and the centres agree within
1e-5. ResNet-50 takes one step at 32 px (its own test below).

Then, in the port alone:
- ``remat='block'`` is bit-equal to ``'none'`` with drop-path and dropout
  on (the generator is rewound for the recompute);
- the frozen subtrees stay bit-identical and the rest moves; BatchNorm
  heads keep buffers in both nets, the teacher's never moving;
- backbone dropout: deterministic outputs equal esvit_tpu's with rates
  > 0 (Swin, ViT, ViL); training masks scale by 1 / (1 - p); the routes
  follow esvit_tpu's rules (Swin's fused and sub-window routes, its
  kernels, ViL's kernel while dropout is active) and the launch-count
  helpers follow the routes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.models.swin import SwinTransformer as JSwin
from esvit_tpu.models.vil import MsViT as JViL
from esvit_tpu.models.vit import VisionTransformer as JViT
from esvit_tpu.train.step import EsViTTrainer as JTrainer
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import (_trace_state, state_dict_from_flax,
                                           train_state_from_jax)
from esvit_tpu_torch.models.common import Dropout
from esvit_tpu_torch.models.registry import build_backbone
from esvit_tpu_torch.train.step import EsViTTrainer as TTrainer
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
STEPS = 2
TOTAL_BATCH = 256

OPTIONS = {
    "streamed-bn_head-lars": dict(
        loss=dict(streamed=True, stream_chunks=4), head=dict(use_bn=True),
        optim=dict(optimizer="lars", lr=0.3)),
    "remat-frozen-sgd": dict(
        model=dict(remat="block"),
        optim=dict(optimizer="sgd", lr=0.1,
                   frozen_layers=("patch_embed", "layers_0"))),
}


def _cfgs(opt, model=None):
    o = OPTIONS.get(opt, {})

    def make(m, dtype, model_kw):
        return m.TrainConfig(
            model=(model(m) if model else m.swin_femto(
                drop_path_rate=0.0, **model_kw, **o.get("model", {}))),
            head=m.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8,
                              **o.get("head", {})),
            loss=m.LossConfig(out_dim=32, warmup_teacher_temp_epochs=2,
                              **o.get("loss", {})),
            optim=m.OptimConfig(**{**dict(lr=1e-3, epochs=4, warmup_epochs=0,
                                          freeze_last_layer_epochs=0),
                                   **o.get("optim", {})}),
            dtype=dtype, steps_per_epoch=2)
    return (make(jcfg, jnp.float32, dict(attention_impl="xla",
                                         fused_block_stages=())),
            make(tcfg, torch.float32, {}))


def _batch():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
            rng.normal(size=(8, 24, 24, 3)).astype(np.float32))


def _run(jc, tc, batch, steps=STEPS):
    """[port's initial snapshot, (JAX state, loss, port snapshot, loss)
    after each step]."""
    jt = JTrainer(jc, total_batch_size=TOTAL_BATCH)
    jb = tuple(map(jnp.asarray, batch))
    state = jt.init_state(jax.random.PRNGKey(0), jb)
    step = jax.jit(jt.train_step)
    tt = TTrainer(tc, total_batch_size=TOTAL_BATCH, device="cpu")
    tstate = train_state_from_jax(jax.device_get(state), tt)
    tb = tuple(map(torch.from_numpy, batch))
    hist = [_snapshot(tstate)]
    for i in range(steps):
        state, m = step(state, jb, jax.random.PRNGKey(i + 1))
        tstate, tm = tt.train_step(tstate, tb, torch.Generator().manual_seed(i))
        hist.append((jax.device_get(state), float(m["loss"]),
                     _snapshot(tstate), float(tm["loss"])))
    return hist


def _snapshot(state):
    out = {"student": state.student.state_dict(),
           "teacher": state.teacher.state_dict(),
           "mu": state.mu, "nu": state.nu, "trace": state.trace}
    out = {k: {n: t.clone() for n, t in v.items()} for k, v in out.items()}
    out["centers"] = [c.clone() for c in state.centers]
    return out


def _close(name, got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


def _jax_parts(jstate):
    """(part, state_dict) of a JAX state: both nets with their BatchNorm
    buffers, and the SGD / LARS trace."""
    return [("student", state_dict_from_flax(
                jstate.student, jstate.student_state.get("batch_stats"))),
            ("teacher", state_dict_from_flax(
                jstate.teacher, jstate.teacher_state.get("batch_stats"))),
            ("trace", state_dict_from_flax(
                _trace_state(jstate.opt_state).trace))]


@pytest.fixture(scope="module", params=list(OPTIONS))
def option_run(request):
    jc, tc = _cfgs(request.param)
    init, *hist = _run(jc, tc, _batch()[:1])
    return request.param, init, hist


def test_option_step_matches_esvit_tpu(option_run):
    """The parity above; besides it: BatchNorm heads carry one buffer pair
    per hidden layer in both nets, the student's moving and the teacher's
    (deterministic: running statistics) never; frozen subtrees stay
    bit-identical while the rest moves; SGD and LARS keep a trace and no
    AdamW moments."""
    opt, init, hist = option_run
    for jstate, jloss, port, tloss in hist:
        _close("loss", tloss, jloss)
        for a, b in zip(port["centers"], jstate.centers):
            _close("center", a.numpy(), np.asarray(b))
        for part, want in _jax_parts(jstate):
            assert set(want) == set(port[part]), part
            for name, w in want.items():
                _close(f"{part} {name}", port[part][name].numpy(), w.numpy())
    port = hist[-1][2]
    assert port["mu"] == {} and port["trace"]
    if "bn_head" in opt:
        for net in ("student", "teacher"):
            bufs = [k for k in port[net] if k.startswith("head")
                    and k.endswith("running_var")]
            assert len(bufs) == 4, bufs      # 2 hidden layers x 2 heads
        k = "head.mlp.1.running_mean"
        assert not torch.equal(port["student"][k], init["student"][k])
        assert torch.equal(port["teacher"][k], init["teacher"][k])
    if "frozen" in opt:
        for name, t in port["student"].items():
            if name.startswith(("patch_embed.", "layers.0.")):
                assert torch.equal(t, init["student"][name]), name
            elif name.startswith(("layers.1.blocks", "head.mlp")):
                assert not torch.equal(t, init["student"][name]), name


def test_resnet50_step_matches_esvit_tpu():
    """One LARS step of ResNet-50 with BatchNorm heads at 32 px (DINO
    loss), held as far as esvit_tpu agrees with itself. A deep BatchNorm
    net on batch statistics at initialisation is chaotic in fp32: moving
    esvit_tpu's input by 1e-7 relative (fp32 rounding) moves its own loss
    by 2.9e-4 relative, its running buffers by 5.5e-4 of their largest
    value and turns its update by cosine 0.9955 (measured on this step),
    while one bottleneck's output and gradients agree with the port's
    within 1e-5 (tests/test_torch_resnet.py). The port against it read
    1.2e-4, 7.2e-4 and 0.994. So the loss is held at 1e-3, the buffers
    at 2e-3 and the update as a direction (cosine >= 0.99); the teacher
    is the EMA of the student; every backbone buffer of both nets moved,
    and the student's head buffers, not the teacher's."""
    jc, tc = _cfgs(None, model=lambda m: m.ResNetConfig(depth=50))
    jc = jc.replace(head=jcfg.HeadConfig(out_dim=32, hidden_dim=16,
                                         bottleneck_dim=8, use_bn=True),
                    loss=jcfg.LossConfig(out_dim=32,
                                         use_dense_prediction=False),
                    optim=jcfg.OptimConfig(optimizer="lars", lr=0.3, epochs=4,
                                           warmup_epochs=0,
                                           freeze_last_layer_epochs=0))
    tc = tc.replace(head=tcfg.HeadConfig(out_dim=32, hidden_dim=16,
                                         bottleneck_dim=8, use_bn=True),
                    loss=tcfg.LossConfig(out_dim=32,
                                         use_dense_prediction=False),
                    optim=tcfg.OptimConfig(optimizer="lars", lr=0.3, epochs=4,
                                           warmup_epochs=0,
                                           freeze_last_layer_epochs=0))
    batch = (np.random.default_rng(0).normal(size=(4, 32, 32, 3))
             .astype(np.float32),)
    init, (jstate, jloss, port, tloss) = _run(jc, tc, batch, steps=1)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-3)
    parts = dict(_jax_parts(jstate))
    want, got, start = parts["student"], port["student"], init["student"]
    params = [k for k in start if not k.endswith(("running_mean",
                                                  "running_var"))]
    du_p = torch.cat([(got[k] - start[k]).flatten() for k in params])
    du_j = torch.cat([(want[k] - start[k]).flatten() for k in params])
    assert torch.nn.functional.cosine_similarity(du_p, du_j, dim=0) >= 0.99
    m = 0.996                                  # step 0's teacher momentum
    for k in params:
        torch.testing.assert_close(port["teacher"][k],
                                   start[k] * m + got[k] * (1 - m))
    for net in ("student", "teacher"):
        for k, t in port[net].items():
            if k.endswith(("running_mean", "running_var")):
                w = parts[net][k].numpy()
                np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                           atol=2e-3 * np.abs(w).max())
                # The teacher's head normalises by its running buffers.
                moves = net == "student" or not k.startswith("head")
                assert torch.equal(t, init[net][k]) != moves, (net, k)
    backbone = [k for k in got if k.startswith(("bn1", "layer"))
                and k.endswith("running_mean")]
    assert len(backbone) == 53


# --- remat --------------------------------------------------------------

def _remat_steps(remat):
    cfg = tcfg.TrainConfig(
        model=tcfg.swin_femto(drop_path_rate=0.3, drop_rate=0.1,
                              attn_drop_rate=0.1, remat=remat),
        head=tcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=tcfg.LossConfig(out_dim=32),
        optim=tcfg.OptimConfig(lr=1e-3, epochs=4, warmup_epochs=0,
                               freeze_last_layer_epochs=0),
        dtype=torch.float32, steps_per_epoch=2)
    tt = TTrainer(cfg, device="cpu")
    state = tt.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(3)
    batch = tuple(torch.from_numpy(b[:4]) for b in _batch())
    losses = []
    for _ in range(1):
        state, m = tt.train_step(state, batch, gen)
        losses.append(float(m["loss"]))
    return losses, _snapshot(state), gen.get_state()


def test_remat_is_bit_equal_to_none_with_drop_path_on():
    """Every block rematerialised, with drop-path, dropout and attention
    dropout drawing from the step's generator: the loss, weights, moments
    and the generator's state after a step are bit-identical to the run
    without remat."""
    a, b = _remat_steps("none"), _remat_steps("block")
    assert a[0] == b[0]
    for part in ("student", "teacher", "mu", "nu"):
        for name, t in a[1][part].items():
            assert torch.equal(t, b[1][part][name]), (part, name)
    assert torch.equal(a[2], b[2])


def test_remat_runs_blocks_under_checkpoint(monkeypatch):
    """remat='block' sends each block of the window-major and classic
    loops through models/common.py remat, and no fused block."""
    from esvit_tpu_torch.models import swin

    calls = []
    real = swin.remat
    monkeypatch.setattr(swin, "remat",
                        lambda fn, x, g: calls.append(1) or real(fn, x, g))
    for stages in ((), (0, 1)):
        calls.clear()
        model = build_backbone(tcfg.swin_femto(remat="block",
                                               fused_block_stages=stages))
        model.forward_features(torch.randn(2, 32, 32, 3))[0].sum().backward()
        routes = list(model._stage_routes(32))
        want = sum(len(st.blocks) for st, _, r in routes
                   if r in ("window_major", "classic"))
        assert len(calls) == want, stages
        assert want == (4 if not stages else 2)   # stage 0 fused


# --- backbone dropout ----------------------------------------------------

def _jax_features(jmodel, tmodel, x):
    v = jax.jit(lambda r: jmodel.init(r, jnp.asarray(x)))(
        jax.random.PRNGKey(0))
    tmodel.load_state_dict(state_dict_from_flax(jax.device_get(v["params"])))
    want = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=jmodel.forward_features))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.forward_features(torch.from_numpy(x), deterministic=True)
    return got, want


@pytest.mark.parametrize("family", ["swin", "vit", "vil"])
def test_deterministic_output_with_dropout_matches_esvit_tpu(family):
    rates = dict(drop_rate=0.2, attn_drop_rate=0.3)
    if family == "swin":
        j = JSwin(jcfg.swin_femto(attention_impl="xla", **rates))
        t = build_backbone(tcfg.swin_femto(**rates))
    elif family == "vit":
        kw = dict(img_size=32, patch_size=8, embed_dim=16, depth=2,
                  num_heads=2, **rates)
        j, t = JViT(jcfg.ViTConfig(**kw)), build_backbone(tcfg.ViTConfig(**kw))
    else:
        j = JViL(jcfg.vil_femto(**rates))
        t = build_backbone(tcfg.vil_femto(**rates))
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    got, want = _jax_features(j, t, x)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=TOL * np.abs(b).max())


def test_dropout_masks_scale_by_one_over_keep():
    x = torch.rand(64, 128) + 1.0
    drop = Dropout(0.25)
    assert drop(x, deterministic=True) is x
    y = drop(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    assert 0.65 < kept.float().mean().item() < 0.85
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    again = drop(x, deterministic=False,
                 generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, again)


@pytest.mark.parametrize("rates,want", [
    (dict(), ["window_major", "fused_subwindow"]),
    (dict(drop_rate=0.1), ["window_major", "classic"]),
    (dict(attn_drop_rate=0.1), ["window_major", "window_major"]),
])
def test_swin_routes_follow_esvit_tpu_under_dropout(rates, want):
    """swin_femto at 24 px: stage 0 on whole windows, stage 1 one padded
    window (fused on its augmented window without dropout). Any dropout
    keeps the fused routes off; attention dropout also the sub-window
    route (the padded window then runs window-major, as in esvit_tpu) and
    both window-attention kernels. The launch helpers follow."""
    model = build_backbone(tcfg.swin_femto(fused_block_stages=(0, 1),
                                           **rates))
    assert [r for _, _, r in model._stage_routes(24)] == want
    assert model.fused_block_calls(24) == (2 if not rates else 0)
    attn_drop = bool(rates.get("attn_drop_rate"))
    # Window attention on stage 0's blocks, and on stage 1's once it runs
    # window-major: never under attention dropout.
    assert model.window_attention_calls(24) == (0 if attn_drop else 2)
    pallas = build_backbone(tcfg.swin_femto(
        attention_impl="pallas", fused_block_stages=(), **rates))
    assert (pallas.pallas_window_attention_calls(24) == 0) == attn_drop


def test_vil_kernel_route_off_only_while_attention_dropout_is_active():
    for rates, det, want in ((dict(), False, True),
                             (dict(attn_drop_rate=0.1), True, True),
                             (dict(attn_drop_rate=0.1), False, False),
                             (dict(drop_rate=0.1), False, True)):
        model = build_backbone(tcfg.vil_femto(**rates))
        n = model.sliding_chunk_calls(32, deterministic=det)
        assert (n > 0) == want, (rates, det)
