"""BatchNorm with esvit_tpu's semantics (models/batchnorm.py) and its
statistics over the process group (parallel/mesh.py ``Mesh.batch_norm``).

- Against flax's ``nn.BatchNorm`` (momentum 0.9, eps 1e-5, fp32 on the
  input cast up, as esvit_tpu/models/cvt.py:58 runs it): the output, the
  gradients of x, scale and bias, and the running buffers, fp32 within
  1e-5 of each tensor's scale (buffers 1e-6), bf16 input within 1e-2 (one
  bf16 rounding of the output); running averages when ``bn_train`` is
  False; two calls (the student's two resolution groups) updating the
  buffers one after the other.
- The running variance is the biased one: it differs from
  ``F.batch_norm``'s own (unbiased) update by n / (n - 1).
- At world size 1 the backward of ``Mesh.batch_norm`` equals autograd of
  the plain formula.
- Two gloo processes, each with half of the batch, equal one process with
  all of it: BatchNorm alone and a cvt_femto forward (outputs, the
  gradients of x and of every parameter, averaged over the processes as
  the step averages them, and the running buffers), and 2 cvt_femto train
  steps (loss, centers, student, teacher, AdamW moments, both nets'
  buffers) under tests/test_torch_distributed.py's tolerances. Some
  gradients of a CvT are ill-conditioned sums: a LayerNorm scale that
  feeds a BatchNorm through the depthwise conv has an exact gradient of
  almost 0 (BatchNorm undoes a per-channel scale), so its fp32 value is
  mostly rounding noise of the sums' order. Every tensor may therefore
  also differ by 10x what reversing the order of the batch's samples
  changes in one process (a permutation that leaves every exact value as
  it is).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.models.batchnorm import BatchNorm
from esvit_tpu_torch.parallel.mesh import Mesh
from tests.test_torch_cvt import scaled_close
from tests.test_torch_distributed import (ADAM_RATIO_TOL, SCALE_TOL,
                                          TINY_GRAD, _close, _spawn)
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
BUF_TOL = 1e-6
C = 6




def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2.0 + 0.7).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
         "bias": rng.normal(0, 0.2, C).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.3, C).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}
    return x, g, p, s


def _flax(x, g, params, stats, train, dtype):
    """(y, dx, dscale, dbias, new stats) of flax's BatchNorm as esvit_tpu's
    CvT runs it."""
    bn = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                      epsilon=1e-5, dtype=jnp.float32,
                      param_dtype=jnp.float32)

    def f(xx, pp):
        y, upd = bn.apply({"params": pp, "batch_stats": stats},
                          xx.astype(jnp.float32), mutable=["batch_stats"])
        y = y.astype(dtype)
        return jnp.sum(y.astype(jnp.float32) * g), (y, upd["batch_stats"])

    xj = jnp.asarray(x).astype(dtype)
    (_, (y, new)), (dx, dp) = jax.value_and_grad(f, argnums=(0, 1),
                                                 has_aux=True)(xj, params)
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(dx.astype(jnp.float32)), np.asarray(dp["scale"]),
            np.asarray(dp["bias"]), jax.tree.map(np.asarray, new))


def _port(params, stats):
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    return bn


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_flax(dtype, train):
    x, g, params, stats = _inputs((4, 3, 5, C))
    jy, jdx, jds, jdb, jstats = _flax(x, g, params, stats, train,
                                      getattr(jnp, dtype))
    bn = _port(params, stats)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    y = bn(xt, train)
    assert y.dtype == xt.dtype
    (y.float() * torch.from_numpy(g)).sum().backward()
    tol = TOL if dtype == "float32" else 1e-2
    scaled_close(y.detach().float().numpy(), jy, tol, "y")
    scaled_close(xt.grad.float().numpy(), jdx, tol, "dx")
    scaled_close(bn.weight.grad.numpy(), jds, tol, "dscale")
    scaled_close(bn.bias.grad.numpy(), jdb, tol, "dbias")
    np.testing.assert_allclose(bn.running_mean.numpy(), jstats["mean"],
                               rtol=BUF_TOL, atol=BUF_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), jstats["var"],
                               rtol=BUF_TOL, atol=BUF_TOL)
    if not train:
        np.testing.assert_array_equal(bn.running_var.numpy(), stats["var"])


def test_two_groups_update_the_buffers_in_turn():
    """A 224-like and a 96-like group: each call updates the buffers once,
    the second from the first's result, as flax's mutable batch_stats."""
    xa, g, params, stats = _inputs((4, 6, 6, C), 1)
    xb = _inputs((8, 3, 3, C), 2)[0]
    *_, s1 = _flax(xa, g, params, stats, True, jnp.float32)
    *_, s2 = _flax(xb, _inputs((8, 3, 3, C), 2)[1], params, s1, True,
                   jnp.float32)
    bn = _port(params, stats)
    with torch.no_grad():
        bn(torch.from_numpy(xa), True)
        bn(torch.from_numpy(xb), True)
    np.testing.assert_allclose(bn.running_mean.numpy(), s2["mean"],
                               rtol=BUF_TOL, atol=BUF_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), s2["var"],
                               rtol=BUF_TOL, atol=BUF_TOL)


def test_running_variance_is_biased():
    """9 rows (stage 3 of a 96 px image at B=1): the running variance
    moves by 0.1 x the biased variance, where F.batch_norm's update would
    move it by 0.1 x n / (n - 1) of it."""
    x = torch.from_numpy(_inputs((1, 3, 3, C), 3)[0])
    flat = x.reshape(-1, C)
    bn = BatchNorm(C)
    with torch.no_grad():
        bn(x, True)
    biased = flat.var(0, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn.running_mean, 0.1 * flat.mean(0),
                               rtol=1e-6, atol=1e-6)
    rv = torch.ones(C)
    F.batch_norm(flat, torch.zeros(C), rv, training=True, momentum=0.1)
    torch.testing.assert_close(rv - 0.9, 0.1 * biased * 9 / 8, rtol=1e-5,
                               atol=1e-6)
    assert ((rv - bn.running_var).abs() > 1e-3).all()


def test_global_batch_norm_backward_is_autograd_of_the_formula():
    """No process group: Mesh.batch_norm's analytic backward against
    autograd through the plain fp32 formula."""
    x, g, params, _ = _inputs((50, C), 4)
    w = torch.tensor(params["scale"], requires_grad=True)
    b = torch.tensor(params["bias"], requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    y, mean, var = Mesh().batch_norm(xt, w, b, 1e-5)
    (y * torch.from_numpy(g)).sum().backward()
    got = [t.grad.clone() for t in (xt, w, b)]
    for t in (xt, w, b):
        t.grad = None
    m = xt.mean(0)
    v = torch.clamp((xt * xt).mean(0) - m * m, min=0)
    ref = (xt - m) * (torch.rsqrt(v + 1e-5) * w) + b
    torch.testing.assert_close(y, ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(var, v.detach(), rtol=1e-6, atol=1e-6)
    (ref * torch.from_numpy(g)).sum().backward()
    for a, t, name in zip(got, (xt, w, b), ("dx", "dw", "db")):
        scaled_close(a.numpy(), t.grad.numpy(), what=name)


# --- two gloo processes against one -------------------------------------

B = 8          # the global batch of the forward jobs


def _share(mesh: Mesh, n: int, reverse: bool):
    """This process's samples of a batch of n (all of them, in reversed
    order, with ``reverse``)."""
    if reverse:
        return np.arange(n)[::-1].copy()
    return np.arange(mesh.rank * n // mesh.world,
                     (mesh.rank + 1) * n // mesh.world)


def _forward_job(mesh: Mesh, reverse: bool = False) -> dict:
    """BatchNorm alone and a cvt_femto forward with bn_train on this
    process's share of one global batch; loss = sum(out * G) / B_local, so
    the processes' mean loss is the one-process loss."""
    from esvit_tpu_torch.models.cvt import CvT

    torch.set_num_threads(1)
    share = _share(mesh, B, reverse)
    nb = B // mesh.world
    x, g, params, stats = _inputs((B, 3, 3, C), 5)
    bn = _port(params, stats)
    xt = torch.from_numpy(x[share]).requires_grad_(True)
    y = bn(xt, True)
    ((y * torch.from_numpy(g[share])).sum() / nb).backward()
    out = {"bn_y": y.detach(), "bn_dx": xt.grad,
           "bn_dw": bn.weight.grad, "bn_db": bn.bias.grad,
           "bn_buffers": {k: v.clone() for k, v in bn.state_dict().items()
                          if k.startswith("running")}}
    model = CvT(tcfg.cvt_femto(), generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    img = rng.normal(size=(B, 20, 20, 3)).astype(np.float32)
    xi = torch.from_numpy(img[share]).requires_grad_(True)
    region = model.forward_features(xi, bn_train=True)[1]
    gr = rng.normal(size=(B,) + tuple(region.shape[1:])).astype(np.float32)
    loss = (region * torch.from_numpy(gr[share])).sum() / nb
    names, params_ = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, [xi, *params_])
    out.update({"cvt_out": region.detach(), "cvt_dx": grads[0],
                "cvt_grads": dict(zip(names, grads[1:])),
                "cvt_buffers": {k: v.clone() for k, v in
                                model.state_dict().items()
                                if "running" in k}})
    return out


STEPS = 2
SB = 4          # the global per-view batch of the step job


def _step_cfg():
    return tcfg.TrainConfig(
        model=tcfg.cvt_femto(),
        head=tcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=tcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=1),
        crops=tcfg.CropConfig(global_size=32, local_size=20,
                              local_crops_number=2),
        optim=tcfg.OptimConfig(lr=1e-3, epochs=2, warmup_epochs=0,
                               batch_size_per_device=SB,
                               freeze_last_layer_epochs=0),
        dtype=torch.float32, steps_per_epoch=2)


def _step_job(mesh: Mesh, reverse: bool = False) -> dict:
    """STEPS cvt_femto train steps on this process's share of each global
    batch: losses and the state as host tensors."""
    from esvit_tpu_torch.io.checkpoint import state_to_dict
    from esvit_tpu_torch.train.step import EsViTTrainer

    torch.set_num_threads(1)
    trainer = EsViTTrainer(_step_cfg(), total_batch_size=SB, device="cpu",
                           mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    share = _share(mesh, SB, reverse)
    losses = []
    for _ in range(STEPS):
        g = rng.normal(size=(2, SB, 32, 32, 3)).astype(np.float32)
        loc = rng.normal(size=(2, SB, 20, 20, 3)).astype(np.float32)
        batch = tuple(torch.from_numpy(np.ascontiguousarray(
            x[:, share].reshape(-1, *x.shape[2:]))) for x in (g, loc))
        _, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "state": state_to_dict(state)}


def _jobs(mesh, reverse=False):
    return {"forward": _forward_job(mesh, reverse),
            "step": _step_job(mesh, reverse)}


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """(one process, one process on the reversed batch, the two
    processes' results)."""
    return (_jobs(Mesh()), _jobs(Mesh(), reverse=True),
            _spawn(tmp_path_factory.mktemp("bn"), _jobs))


def _within(name, got, want, noise, tol=TOL):
    """|got - want| within ``tol`` of want's max-abs plus 10x ``noise``,
    the difference that reversing the batch makes in one process."""
    got, want, noise = (np.asarray(t, np.float64) for t in (got, want, noise))
    err = np.abs(got - want).max()
    bound = tol * np.abs(want).max() + 10 * np.abs(noise).max()
    assert err <= bound, (name, err, bound)


def test_two_gloo_processes_equal_one_process_forward(gloo_runs):
    one, rev, ranks = gloo_runs
    one, rev = one["forward"], rev["forward"]
    ranks = [r["forward"] for r in ranks]
    world = len(ranks)
    for r, got in enumerate(ranks):
        share = slice(r * B // world, (r + 1) * B // world)
        for key in ("bn_y", "cvt_out"):
            scaled_close(got[key].numpy(), one[key][share].numpy(), what=key)
        for key in ("bn_dx", "cvt_dx"):
            # Each process's dx is the gradient of its own loss, world x
            # the mean loss's.
            scaled_close(got[key].numpy() / world,
                          one[key][share].numpy(), what=key)
        for part in ("bn_buffers", "cvt_buffers"):
            assert set(got[part]) == set(one[part]) and got[part]
            for k, v in one[part].items():
                np.testing.assert_allclose(got[part][k].numpy(), v.numpy(),
                                           rtol=BUF_TOL, atol=BUF_TOL,
                                           err_msg=f"{part} {k}")
    for key in ("bn_dw", "bn_db"):
        mean = sum(r[key] for r in ranks) / world
        scaled_close(mean.numpy(), one[key].numpy(), what=key)
    for k, v in one["cvt_grads"].items():
        mean = sum(r["cvt_grads"][k] for r in ranks) / world
        _within(k, mean, v, rev["cvt_grads"][k] - v)


def test_two_gloo_processes_take_the_one_process_cvt_step(gloo_runs):
    """As tests/test_torch_distributed.py holds the Swin step; the
    student's and the teacher's BatchNorm buffers besides."""
    one, rev, ranks = gloo_runs
    one, rev = one["step"], rev["step"]["state"]
    lr = _step_cfg().optim.lr * SB / 256
    tiny = {n: (v / (1 - 0.999 ** STEPS)).sqrt() < TINY_GRAD
            for n, v in one["state"]["nu"].items()}
    buffers = 0
    for got in (r["step"] for r in ranks):
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-6)
        want, have = one["state"], got["state"]
        for key in ("center", "center_grid"):
            _close(key, have["centers"][key], want["centers"][key])
        for part in ("student", "teacher", "mu", "nu"):
            assert set(have[part]) == set(want[part])
            for name, w in want[part].items():
                if "running" in name:
                    np.testing.assert_allclose(
                        have[part][name].numpy(), w.numpy(), rtol=BUF_TOL,
                        atol=BUF_TOL, err_msg=f"{part} {name}")
                    buffers += 1
                elif tiny.get(name, torch.zeros(())).any():
                    _close(f"{part} {name}", have[part][name], w,
                           tiny[name], lr / 10, ADAM_RATIO_TOL * lr * STEPS)
                else:
                    _within(f"{part} {name}", have[part][name], w,
                            rev[part][name] - w, SCALE_TOL)
    assert buffers == 2 * 2 * 4
    s, t = one["state"]["student"], one["state"]["teacher"]
    name = "stage0.1.layers.0.0.fn.qkv.bn.running_mean"
    assert (s[name] - t[name]).abs().max() > 1e-4
