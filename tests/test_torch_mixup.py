"""Mixup-SSL in the port (esvit_tpu_torch/data/mixup.py, losses.dino_loss
``targets_mixup``, the train step's mixup branch) against esvit_tpu's,
on the CPU.

``jax.random.beta`` and the port's gamma-based Beta draw different
values from one seed, so parity is held on the same draws: the test
repeats esvit_tpu's key splits (mixup_multicrop -> mixup_view ->
_rand_bbox), reads the values ``jax.random`` drew and hands them to the
port. Tolerances: the mixed views and targets within 1e-6; dino_loss
with targets within 1e-6 relative (fp32); two femto train steps with
mixup from the same state within 1e-5 (fp32, as tests/test_torch_step.py
holds the step without it). The port's own draws are held to their
rates by 4-sigma bounds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu import losses as jlosses
from esvit_tpu.data import mixup as jmix
from esvit_tpu.train.step import EsViTTrainer as JTrainer
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch import losses as tlosses
from esvit_tpu_torch.data import mixup as tmix
from esvit_tpu_torch.io.jax_params import (_adam_state, state_dict_from_flax,
                                           train_state_from_jax)
from esvit_tpu_torch.train.step import EsViTTrainer as TTrainer
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-6
STEP_TOL = 1e-5
TINY_GRAD = 1e-7          # as tests/test_torch_step.py: Adam's sign-like
TINY_GRAD_TOL = 1e-4      # step on fp32 noise where the gradient is ~0


def jax_view_draws(rng, cfg, h, w) -> tmix.MixupDraws:
    """The values esvit_tpu's mixup_view draws from ``rng``."""
    k_apply, k_switch, k_lam_m, k_lam_c, k_box = jax.random.split(rng, 5)
    ky, kx = jax.random.split(k_box)
    return tmix.MixupDraws(
        apply=bool(jax.random.bernoulli(k_apply, cfg.prob)),
        use_cutmix=bool(jax.random.bernoulli(k_switch, cfg.switch_prob))
        and cfg.cutmix_alpha > 0,
        lam_mix=float(jax.random.beta(k_lam_m, cfg.mixup_alpha,
                                      cfg.mixup_alpha)),
        lam_cut=float(jax.random.beta(k_lam_c, cfg.cutmix_alpha,
                                      cfg.cutmix_alpha)),
        cy=int(jax.random.randint(ky, (), 0, h)),
        cx=int(jax.random.randint(kx, (), 0, w)))


def jax_multicrop_draws(rng, cfg, sizes):
    """The values esvit_tpu's mixup_multicrop draws from ``rng``."""
    out = []
    for v in range(len(sizes)):
        if v < cfg.num_mixup_views:
            rng, sub = jax.random.split(rng)
            out.append(jax_view_draws(sub, cfg, *sizes[v]))
    return out


CFGS = {
    "mixup": dict(switch_prob=0.0),
    "cutmix": dict(switch_prob=1.0),
    "switch": dict(switch_prob=0.5, prob=0.7),
    "smoothing": dict(label_smoothing=0.1, switch_prob=0.5),
    "no_cutmix_alpha": dict(switch_prob=1.0, cutmix_alpha=0.0),
}


@pytest.mark.parametrize("name", list(CFGS))
def test_mixup_view_on_jax_draws(name):
    kw = CFGS[name]
    jc = jmix.MixupConfig(enabled=True, **kw)
    tc = tmix.MixupConfig(enabled=True, **kw)
    x = np.random.default_rng(0).normal(size=(6, 12, 10, 3)).astype(
        np.float32)
    seen = set()
    for seed in range(8):
        rng = jax.random.PRNGKey(seed)
        jm, jt = jmix.mixup_view(rng, jnp.asarray(x), jc)
        d = jax_view_draws(rng, jc, 12, 10)
        tm, tt = tmix.mixup_view(torch.from_numpy(x), tc, d)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=TOL,
                                   atol=TOL)
        seen.add((d.apply, d.use_cutmix))
    if name == "switch":
        assert len(seen) >= 3                   # each branch was taken


def test_cutmix_box_matches_esvit_tpu():
    for lam in (0.0, 0.1, 0.37, 0.5, 0.93, 1.0):
        for seed in range(5):
            rng = jax.random.PRNGKey(seed)
            want = [int(v) for v in jmix._rand_bbox(rng, 12, 10,
                                                    jnp.float32(lam))]
            ky, kx = jax.random.split(rng)
            cy = int(jax.random.randint(ky, (), 0, 12))
            cx = int(jax.random.randint(kx, (), 0, 10))
            assert list(tmix.cutmix_box(12, 10, float(np.float32(lam)), cy,
                                        cx)) == want


@pytest.mark.parametrize("views,L", [(2, 3), (3, 3), (1, 0)])
def test_mixup_multicrop_on_jax_draws(views, L):
    B = 4
    rng_np = np.random.default_rng(1)
    g = rng_np.normal(size=(2 * B, 16, 16, 3)).astype(np.float32)
    loc = rng_np.normal(size=(L * B, 8, 8, 3)).astype(np.float32)
    kw = dict(enabled=True, num_mixup_views=views, switch_prob=0.5)
    jc, tc = jmix.MixupConfig(**kw), tmix.MixupConfig(**kw)
    rng = jax.random.PRNGKey(3)
    jg, jl, jt = jmix.mixup_multicrop(rng, jnp.asarray(g), jnp.asarray(loc),
                                      jc)
    sizes = [(16, 16)] * 2 + [(8, 8)] * L
    draws = jax_multicrop_draws(rng, jc, sizes)
    assert len(draws) == min(views, 2 + L)
    tg, tl, tt = tmix.mixup_multicrop(torch.from_numpy(g),
                                      torch.from_numpy(loc), tc, draws)
    assert tt.shape == (2 + L, B, B)
    for a, b in ((tg, jg), (tl, jl), (tt, jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    for v in range(views, 2 + L):               # clean views: identity
        assert torch.equal(tt[v], torch.eye(B))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_dino_loss_with_mixup_targets(smoothing):
    B, K, ncrops = 4, 64, 4
    r = np.random.default_rng(2)
    s = r.normal(size=(ncrops * B, K)).astype(np.float32)
    t = r.normal(size=(2 * B, K)).astype(np.float32)
    center = r.normal(size=(K,)).astype(np.float32) * 0.1
    targets = np.stack([np.eye(B, dtype=np.float32)] * ncrops)
    lam = np.float32(0.3)
    for v in (0, 1):
        targets[v] = lam * np.eye(B) + (1 - lam) * np.eye(B)[::-1]
    targets = targets * (1 - smoothing) + smoothing / B
    jl, jc = jlosses.dino_loss(jnp.asarray(s), jnp.asarray(t),
                               jnp.asarray(center), 0.04, ncrops=ncrops,
                               targets_mixup=jnp.asarray(targets))
    tl, tc = tlosses.dino_loss(torch.from_numpy(s), torch.from_numpy(t),
                               torch.from_numpy(center), 0.04, ncrops=ncrops,
                               targets_mixup=torch.from_numpy(targets))
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL,
                               atol=TOL)
    # Identity targets are the plain loss.
    eye = torch.from_numpy(np.stack([np.eye(B, dtype=np.float32)] * ncrops))
    plain, _ = tlosses.dino_loss(torch.from_numpy(s), torch.from_numpy(t),
                                 torch.from_numpy(center), 0.04,
                                 ncrops=ncrops)
    with_eye, _ = tlosses.dino_loss(torch.from_numpy(s), torch.from_numpy(t),
                                    torch.from_numpy(center), 0.04,
                                    ncrops=ncrops, targets_mixup=eye)
    np.testing.assert_allclose(float(with_eye), float(plain), rtol=TOL)


def _step_cfgs(dense):
    mix = dict(enabled=True, num_mixup_views=2, switch_prob=0.5,
               label_smoothing=0.1)
    common = dict(steps_per_epoch=2)
    j = jcfg.TrainConfig(
        model=jcfg.swin_femto(attention_impl="xla", fused_block_stages=(),
                              drop_path_rate=0.0),
        head=jcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=jcfg.LossConfig(out_dim=32, use_dense_prediction=dense,
                             warmup_teacher_temp_epochs=2),
        optim=jcfg.OptimConfig(lr=1e-3, epochs=4, warmup_epochs=1,
                               freeze_last_layer_epochs=0),
        mixup=jmix.MixupConfig(**mix), dtype=jnp.float32, **common)
    t = tcfg.TrainConfig(
        model=tcfg.swin_femto(drop_path_rate=0.0),
        head=tcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=tcfg.LossConfig(out_dim=32, use_dense_prediction=dense,
                             warmup_teacher_temp_epochs=2),
        optim=tcfg.OptimConfig(lr=1e-3, epochs=4, warmup_epochs=1,
                               freeze_last_layer_epochs=0),
        mixup=tmix.MixupConfig(**mix), dtype=torch.float32, **common)
    return j, t


def _close(name, got, want, tol=STEP_TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("dense", [False, True])
def test_two_train_steps_with_mixup_match_jax(dense):
    """Two femto steps with mixup from the same state and draws: the
    losses, centers, student and teacher within 1e-5. With the dense
    head the targets are ignored, as in esvit_tpu."""
    jc, tc = _step_cfgs(dense)
    r = np.random.default_rng(0)
    batch = (r.normal(size=(8, 32, 32, 3)).astype(np.float32),
             r.normal(size=(8, 24, 24, 3)).astype(np.float32))
    jt = JTrainer(jc, total_batch_size=256)
    jb = tuple(map(jnp.asarray, batch))
    state = jt.init_state(jax.random.PRNGKey(0), jb)
    step = jax.jit(jt.train_step)
    tt = TTrainer(tc, total_batch_size=256, device="cpu")
    tstate = train_state_from_jax(jax.device_get(state), tt)
    tb = tuple(map(torch.from_numpy, batch))
    sizes = [(32, 32)] * 2 + [(24, 24)] * 2
    with pytest.raises(ValueError, match="mixup_draws"):
        tt.train_step(train_state_from_jax(jax.device_get(state), tt), tb)
    nu1 = None
    for i in range(2):
        rng = jax.random.PRNGKey(i + 1)
        _, mix_rng = jax.random.split(rng)
        draws = jax_multicrop_draws(mix_rng, jc.mixup, sizes)
        state, m = step(state, jb, rng)
        tstate, tm = tt.train_step(tstate, tb, mixup_draws=draws)
        _close(f"loss {i}", float(tm["loss"]), float(m["loss"]))
        if nu1 is None:
            nu1 = state_dict_from_flax(_adam_state(state.opt_state).nu)
    js = jax.device_get(state)
    for a, b in zip(tstate.centers, js.centers):
        _close("center", a.numpy(), np.asarray(b))
    g1 = {k: np.sqrt(v.numpy() / (1 - 0.999)) for k, v in nu1.items()}
    for part, tree, model in (("student", js.student, tstate.student),
                              ("teacher", js.teacher, tstate.teacher)):
        want = state_dict_from_flax(tree)
        got = model.state_dict()
        for name, w in want.items():
            tiny = g1[name] < TINY_GRAD
            a, w = got[name].numpy(), w.numpy()
            _close(f"{part} {name}", a[~tiny], w[~tiny])
            _close(f"{part} {name} (tiny grad)", a[tiny], w[tiny],
                   TINY_GRAD_TOL)


def test_port_draws_rates_and_ranges():
    """draw_view's rates (4 sigma) and ranges at n = 4000; a fixed
    generator state gives the same draws."""
    cfg = tmix.MixupConfig(enabled=True, prob=0.7, switch_prob=0.4)
    gen = torch.Generator().manual_seed(0)
    n = 4000
    d = [tmix.draw_view(gen, cfg, 12, 10) for _ in range(n)]

    def within(count, p):
        return abs(count / n - p) <= 4 * math.sqrt(p * (1 - p) / n)

    assert within(sum(x.apply for x in d), 0.7)
    assert within(sum(x.use_cutmix for x in d), 0.4)
    lam = np.array([x.lam_mix for x in d])
    # Beta(0.8, 0.8): mean 1/2, variance 1 / (4 (2 alpha + 1)).
    sd = math.sqrt(1 / (4 * 2.6))
    assert abs(lam.mean() - 0.5) <= 4 * sd / math.sqrt(n)
    assert 0 < lam.min() and lam.max() < 1
    assert {x.cy for x in d} == set(range(12))
    assert {x.cx for x in d} == set(range(10))
    a = tmix.draw_view(torch.Generator().manual_seed(5), cfg, 12, 10)
    b = tmix.draw_view(torch.Generator().manual_seed(5), cfg, 12, 10)
    assert a == b
    off = tmix.draw_view(gen, tmix.MixupConfig(mixup_alpha=0.0,
                                               cutmix_alpha=0.0), 4, 4)
    assert off.lam_mix == off.lam_cut == 1.0 and not off.use_cutmix


def test_train_with_mixup_on_the_cpu(tmp_path):
    """train() with cfg.mixup: finite losses, repeatable (the draws come
    from a generator seeded by cfg.seed)."""
    from esvit_tpu_torch.data.datasets import SyntheticImages
    from esvit_tpu_torch.train.train import train

    cfg = tcfg.TrainConfig(
        model=tcfg.swin_femto(drop_path_rate=0.0),
        head=tcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=tcfg.LossConfig(out_dim=32, use_dense_prediction=False,
                             warmup_teacher_temp_epochs=1),
        crops=tcfg.CropConfig(global_size=32, local_size=16,
                              local_crops_number=2),
        optim=tcfg.OptimConfig(lr=1e-3, epochs=1, warmup_epochs=0,
                               batch_size_per_device=2),
        mixup=tmix.MixupConfig(enabled=True, num_mixup_views=3),
        dtype=torch.float32, output_dir=str(tmp_path))
    runs = [train(cfg, dataset=SyntheticImages(n=4, size=40), device="cpu",
                  resume=False)[1] for _ in range(2)]
    losses = [[h["loss"] for h in r] for r in runs]
    assert len(losses[0]) == 2 and all(map(math.isfinite, losses[0]))
    assert losses[0] == losses[1]
