"""The port's train step against esvit_tpu's EsViTTrainer.train_step.

The JAX trainer's initial state (weights, moments, centers) crosses into
the port through io/jax_params.py; both then take the same fp32 steps on
the same numpy batch (swin_femto, 32px + 24px crops, drop-path off). After
1 and after 3 steps the loss, student, teacher, AdamW moments and centers
must agree within 1e-5. The schedule reaches lr 1e-3 at step 1 and leaves
the last-layer freeze at step 2, so the steps move the weights.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.models.common import DropPath as JDropPath
from esvit_tpu.train.step import EsViTTrainer as JTrainer
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import (_adam_state, state_dict_from_flax,
                                           train_state_from_jax)
from esvit_tpu_torch.models.common import DropPath as TDropPath
from esvit_tpu_torch.train.step import EsViTTrainer as TTrainer

TOL = 1e-5
# Adam's update lr * mu / (sqrt(nu) + eps) is sign-like: it divides by the
# gradient's own magnitude. Where a gradient is below 1e-7 (the key bias,
# whose exact gradient is zero where softmax is shift-invariant), it is
# fp32 rounding noise of sums taken in another order, and the update turns
# that noise into a step of up to lr. Those elements are held to a tenth
# of the step-1 learning rate instead.
TINY_GRAD = 1e-7
TINY_GRAD_TOL = 1e-4
STEPS = 3
TOTAL_BATCH = 256          # base lr = lr * 256 / 256


def _cfgs():
    common = dict(steps_per_epoch=2)
    j = jcfg.TrainConfig(
        model=jcfg.swin_femto(attention_impl="xla", fused_block_stages=(),
                              drop_path_rate=0.0),
        head=jcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=jcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=2),
        optim=jcfg.OptimConfig(lr=1e-3, epochs=4, warmup_epochs=1,
                               freeze_last_layer_epochs=1),
        dtype=jnp.float32, **common)
    t = tcfg.TrainConfig(
        model=tcfg.swin_femto(drop_path_rate=0.0),
        head=tcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=tcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=2),
        optim=tcfg.OptimConfig(lr=1e-3, epochs=4, warmup_epochs=1,
                               freeze_last_layer_epochs=1),
        dtype=torch.float32, **common)
    return j, t


def _batch():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
            rng.normal(size=(8, 24, 24, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def runs():
    return run_both()


def run_both():
    """(JAX states after each step with their losses, port's the same)."""
    jc, tc = _cfgs()
    batch = _batch()
    jt = JTrainer(jc, total_batch_size=TOTAL_BATCH)
    jb = tuple(map(jnp.asarray, batch))
    state = jt.init_state(jax.random.PRNGKey(0), jb)
    step = jax.jit(jt.train_step)
    tt = TTrainer(tc, total_batch_size=TOTAL_BATCH)
    tstate = train_state_from_jax(jax.device_get(state), tt)
    tb = tuple(map(torch.from_numpy, batch))
    jax_hist, port_hist = [], []
    for i in range(STEPS):
        state, m = step(state, jb, jax.random.PRNGKey(i + 1))
        jax_hist.append((jax.device_get(state), float(m["loss"])))
        tstate, tm = tt.train_step(tstate, tb)
        port_hist.append((_snapshot(tstate), float(tm["loss"])))
    return jax_hist, port_hist


def _snapshot(state):
    return {
        "student": {k: v.clone() for k, v in state.student.state_dict().items()},
        "teacher": {k: v.clone() for k, v in state.teacher.state_dict().items()},
        "mu": {k: v.clone() for k, v in state.mu.items()},
        "nu": {k: v.clone() for k, v in state.nu.items()},
        "centers": [c.clone() for c in state.centers],
        "step": state.step, "adam_count": state.adam_count,
    }


def _close(name, got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("after", [1, STEPS])
def test_step_matches_jax(runs, after):
    jax_hist, port_hist = runs
    jstate, jloss = jax_hist[after - 1]
    port, tloss = port_hist[after - 1]
    _close("loss", tloss, jloss)
    assert port["step"] == int(jstate.step) == after
    adam = _adam_state(jstate.opt_state)
    assert port["adam_count"] == int(adam.count)
    for a, b in zip(port["centers"], jstate.centers):
        _close("center", a.numpy(), np.asarray(b))
    # Gradient magnitude per leaf, from the JAX second moment after step 1.
    nu1 = state_dict_from_flax(_adam_state(jax_hist[0][0].opt_state).nu)
    g1 = {k: np.sqrt(v.numpy() / (1 - 0.999)) for k, v in nu1.items()}
    for part, tree in (("student", jstate.student), ("teacher", jstate.teacher),
                       ("mu", adam.mu), ("nu", adam.nu)):
        want = state_dict_from_flax(tree)
        assert set(want) == set(port[part])
        for name, w in want.items():
            got = port[part][name].numpy()
            tiny = g1[name] < TINY_GRAD
            w = w.numpy()
            if part == "nu":       # in squared-gradient units: compare the
                got, w = np.sqrt(got), np.sqrt(w)   # roots, like mu
            _close(f"{part} {name}", got[~tiny], w[~tiny])
            _close(f"{part} {name} (|grad| < {TINY_GRAD})", got[tiny], w[tiny],
                   TINY_GRAD_TOL)


def test_drop_path_matches_jax():
    """The same keep-mask through both DropPaths gives the same output:
    the JAX mask is read off its output, then fed to the port."""
    rate = 0.3
    x = np.random.default_rng(1).normal(size=(16, 5, 4)).astype(np.float32) + 3
    out = np.asarray(JDropPath(rate).apply(
        {}, jnp.asarray(x), deterministic=False,
        rngs={"droppath": jax.random.PRNGKey(7)}))
    keep = out[:, 0, 0] != 0
    assert 0 < keep.sum() < len(keep)
    dp = TDropPath(rate)
    got = dp.apply_mask(torch.from_numpy(x), torch.from_numpy(keep))
    np.testing.assert_array_equal(got.numpy(), out)
    assert dp(torch.from_numpy(x), deterministic=True) is not None
    gen = torch.Generator().manual_seed(0)
    drawn = dp(torch.from_numpy(x), deterministic=False, generator=gen)
    kept = drawn[:, 0, 0] != 0
    np.testing.assert_allclose(drawn[kept].numpy(), x[kept.numpy()] / (1 - rate),
                               rtol=1e-6)


def test_port_imports_without_jax():
    """esvit_tpu_torch imports nothing of JAX: with jax blocked in
    sys.modules every module of the package still imports."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'esvit_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import esvit_tpu_torch\n"
        "for info in pkgutil.walk_packages(esvit_tpu_torch.__path__, 'esvit_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
