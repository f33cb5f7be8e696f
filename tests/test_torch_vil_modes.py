"""The port's ViL sliding-chunk options against esvit_tpu, on the CPU.

- The invalid-location masks, bit-identical for every ``exact`` and
  neighbour mode, at a padded and an unpadded chunk grid.
- ``Long2DSCAttention`` for every mode: output and every gradient
  (JAX's by ``jax.grad``) from the same weights and inputs, fp32, 1e-5
  (sums in another order). The JAX module runs its einsum path
  (``fused_sc='off'``); the port's runs its own einsum path, or at mode 0
  the kernel's plain twin (tests/test_torch_vil_options.py does the same
  for the other options).
- Per-layer draws (``PER_LAYER_MODE``): a one-sparse-layer net's output
  equals esvit_tpu's at the mode its layer drew, and the draws are
  uniform on 1-8.
- The neighbour-mode schedule of train(): the (mode, teacher_mode) each
  step passes to the step, recorded from esvit_tpu's train() (its step
  function stood in by a recorder) and from the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.models.vil import MsViT as JViL
from esvit_tpu.models.vil_layers import Long2DSCAttention as JAttention
from esvit_tpu.ops import slidingchunk as jsc
from esvit_tpu.train import train as jtrain
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import state_dict_from_flax
from esvit_tpu_torch.models import vil as tvil
from esvit_tpu_torch.models.vil_layers import Long2DSCAttention as TAttention
from esvit_tpu_torch.ops import sliding_chunk as tsc
from esvit_tpu_torch.train import train as ttrain
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
MODES = [-1, 0, 1, 2, 3, 4, 5, 6, 7, 8]


# (nx, ny, padx, pady, w): a padded 3x3-chunk grid and an unpadded 2x4.
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("exact", [-1, 0, 1])
def test_masks_bit_identical(exact, mode):
    for args in ((3, 3, 1, 2, 2), (2, 4, 0, 0, 3)):
        if exact == 1 and mode != 0:
            with pytest.raises(ValueError):
                jsc.invalid_locations_mask(*args, exact=exact, mode=mode)
            with pytest.raises(ValueError):
                tsc.invalid_locations_mask(*args, exact=exact, mode=mode)
            continue
        want = jsc.invalid_locations_mask(*args, exact=exact, mode=mode)
        got = tsc.invalid_locations_mask(*args, exact=exact, mode=mode)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# The attention at W=2 on a 5x6 grid (3x3 chunks, one padded row).
def attention_pair(kw, mode, nx=5, ny=6, dim=16, heads=2, W=2):
    """esvit_tpu's module (einsum path), its params and the port's module
    on the same weights, an input x and a cotangent w."""
    kw = dict(kw)
    nglo = kw.pop("nglo", 1)
    jmod = JAttention(dim=dim, num_heads=heads, window=W, nglo=nglo,
                      fused_sc="off", **kw)
    rng = np.random.default_rng(abs(mode) + 10 * len(kw))
    x = rng.normal(size=(2, nglo + nx * ny, dim)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    params = jax.jit(lambda r: jmod.init(r, jnp.asarray(x), nx, ny,
                                         mode=mode))(
        jax.random.PRNGKey(mode + 1))["params"]
    grid = dict(wx=nx, wy=ny) if kw.get("add_pooled") and kw.get("rpe") else {}
    tmod = TAttention(dim, heads, W, nglo, **kw, **grid)
    tmod.load_state_dict(state_dict_from_flax(jax.device_get(params)),
                         strict=True)
    return jmod, params, tmod, x, w


def check_attention(kw, mode, kernel, nx=5, ny=6):
    """Output, input gradient and every parameter gradient against
    esvit_tpu's; ``kernel``: whether the port routes to the kernel."""
    jmod, params, tmod, x, w = attention_pair(kw, mode, nx, ny)

    def loss(p, x):
        out = jmod.apply({"params": p}, x, nx, ny, mode=mode)
        return jnp.sum(out * w), out

    (_, want), (g_p, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = tmod(xt, nx, ny, mode=mode)
    (out * torch.from_numpy(w)).sum().backward()
    assert tmod.uses_kernel(x.shape[-1], mode=mode) == kernel
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=TOL,
                               atol=TOL)
    want_g = state_dict_from_flax(jax.device_get(g_p))
    got_g = dict(tmod.named_parameters())
    assert set(want_g) == set(got_g)
    for name, g in want_g.items():
        np.testing.assert_allclose(got_g[name].grad.numpy(), g.numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_attention_matches_jax(mode):
    check_attention({}, mode, kernel=mode == 0)


# --- per-layer draws ----------------------------------------------------

ONE_SPARSE = "l1,h2,d16,n1,s1,g1,p4,f2"


@pytest.fixture(scope="module")
def one_sparse():
    cfg = jcfg.vil_from_arch(ONE_SPARSE, img_size=32, fused_sc="off")
    jmodel = JViL(cfg)
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    params = jax.jit(lambda r: jmodel.init(r, jnp.asarray(x)))(
        jax.random.PRNGKey(0))["params"]
    port = tvil.MsViT(tcfg.vil_from_arch(ONE_SPARSE, img_size=32))
    port.load_state_dict(state_dict_from_flax(jax.device_get(params)),
                         strict=True)
    apply = jax.jit(lambda p, x, m: jmodel.apply({"params": p}, x, mode=m),
                    static_argnums=2)
    return apply, params, port, x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_layer_draw_equals_static_mode(one_sparse, seed):
    """The layer's draw is the generator's next randint(1, 9); the net's
    output is esvit_tpu's at that static mode."""
    apply, params, port, x = one_sparse
    drawn = int(torch.randint(1, 9, (1,),
                              generator=torch.Generator().manual_seed(seed)))
    with torch.no_grad():
        got = port.forward_features(
            torch.from_numpy(x), generator=torch.Generator().manual_seed(seed),
            mode=tvil.PER_LAYER_MODE)
    want = apply(params, jnp.asarray(x), drawn)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


def test_per_layer_draws_are_uniform():
    """8000 draws: each mode's count within 4 sigma of 1000."""
    gen = torch.Generator().manual_seed(0)
    seen = [tvil.draw_neighbour_mode(gen) for _ in range(8000)]
    counts = np.bincount(seen, minlength=9)
    assert counts[0] == 0 and counts.sum() == 8000
    sigma = np.sqrt(8000 * (1 / 8) * (7 / 8))
    assert np.all(np.abs(counts[1:] - 1000) < 4 * sigma), counts


# --- the schedule of train() ------------------------------------------

def _schedule_cfgs(per_layer, tmp):
    crops = dict(global_size=32, local_size=24, local_crops_number=2)
    kw = dict(mode=3, mode_switch=0.5, per_layer_mode=per_layer)
    pieces = dict(head=dict(out_dim=16, hidden_dim=8, bottleneck_dim=8),
                  loss=dict(out_dim=16),
                  optim=dict(epochs=2, batch_size_per_device=1,
                             warmup_epochs=0))
    j = jcfg.TrainConfig(
        model=jcfg.vil_femto(fused_sc="off", **kw),
        head=jcfg.HeadConfig(**pieces["head"]),
        loss=jcfg.LossConfig(**pieces["loss"]),
        crops=jcfg.CropConfig(**crops), optim=jcfg.OptimConfig(**pieces["optim"]),
        steps_per_epoch=5, dtype=jnp.float32, seed=4,
        output_dir=str(tmp / "jax"))
    t = tcfg.TrainConfig(
        model=tcfg.vil_femto(**kw), head=tcfg.HeadConfig(**pieces["head"]),
        loss=tcfg.LossConfig(**pieces["loss"]),
        crops=tcfg.CropConfig(**crops), optim=tcfg.OptimConfig(**pieces["optim"]),
        steps_per_epoch=5, dtype=torch.float32, seed=4,
        output_dir=str(tmp / "port"))
    return j, t


@pytest.mark.parametrize("per_layer", [False, True])
def test_schedule_matches_esvit_tpu_train(tmp_path, monkeypatch, per_layer):
    """2 epochs of 5 steps, the switch at step int(0.5 * 10) = 5: the
    modes esvit_tpu's train() hands its step, against the port's
    schedule for all 10 steps and the modes the port's train() records
    over its first 2 steps."""
    jc, tc = _schedule_cfgs(per_layer, tmp_path)
    seen = []
    real_jit = jax.jit

    def recording_jit(fn, **kw):
        if kw.get("static_argnames") != ("mode", "teacher_mode"):
            return real_jit(fn, **kw)

        def step(state, batch, rng, mode, teacher_mode):
            seen.append((mode, teacher_mode))
            return state._replace(step=state.step + 1), {
                "loss": 0.0, "lr": 0.0, "wd": 0.0, "grad_norm": 0.0}
        return step

    monkeypatch.setattr(jtrain.jax, "jit", recording_jit)
    jtrain.train(jc, data_kind="synthetic_device", resume=False)
    monkeypatch.undo()
    modes_for = ttrain.vil_mode_schedule(tc, 5)
    assert [modes_for(s) for s in range(10)] == seen
    assert seen[5:] == [(0, 0)] * 5
    assert all(m != (0, 0) for m in seen[:5])
    _, history = ttrain.train(tc, device="cpu", max_steps=2, resume=False)
    assert [h["modes"] for h in history] == seen[:2]
