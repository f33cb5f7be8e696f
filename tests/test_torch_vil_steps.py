"""Two multi-crop train steps of the port's ViL options against
esvit_tpu's, fp32, as tests/test_torch_vil.py does for the canonical
configuration: sampled neighbour modes (the student's and the teacher's
differ), with and without relative position bias on the sparse stage
(full attention's rpe takes the native grid only, so not the 24 px local
crops). tests/test_torch_vil_attention_steps.py runs the other attention
types through :func:`check_steps`. Loss, centres, student, teacher and
AdamW moments after each step within 1e-5 (gradients below 1e-7 at 1e-4,
tests/test_torch_step.py:31-38).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.train.step import EsViTTrainer as JTrainer
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import (_adam_state, state_dict_from_flax,
                                           train_state_from_jax)
from esvit_tpu_torch.train.step import EsViTTrainer as TTrainer
from tests.test_torch_step import TINY_GRAD, TINY_GRAD_TOL
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
STEPS = 2
RPE_SPARSE = "l1,h2,d16,n1,s1,g1,p4,f2,a0_l2,h2,d32,n1,s0,g1,p2,f2"
# name -> (arch or None for vil_femto, model options, mode, teacher_mode,
# local crops)
CASES = {
    "modes 3 and 6": (None, {}, 3, 6, True),
    "rpe mode 2 and 7": (RPE_SPARSE, {}, 2, 7, True),
}


def _model(pkg, arch, kw):
    if arch is None:
        return pkg.vil_femto(**kw)
    return pkg.vil_from_arch(arch, img_size=32, **kw)


def _cfgs(arch, kw):
    common = dict(steps_per_epoch=2)
    pieces = dict(
        head=dict(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=dict(out_dim=32, warmup_teacher_temp_epochs=2),
        optim=dict(lr=1e-3, epochs=4, warmup_epochs=1,
                   freeze_last_layer_epochs=1))
    j = jcfg.TrainConfig(
        model=_model(jcfg, arch, dict(kw, fused_sc="off")),
        head=jcfg.HeadConfig(**pieces["head"]),
        loss=jcfg.LossConfig(**pieces["loss"]),
        optim=jcfg.OptimConfig(**pieces["optim"]), dtype=jnp.float32,
        **common)
    t = tcfg.TrainConfig(
        model=_model(tcfg, arch, kw), head=tcfg.HeadConfig(**pieces["head"]),
        loss=tcfg.LossConfig(**pieces["loss"]),
        optim=tcfg.OptimConfig(**pieces["optim"]), dtype=torch.float32,
        **common)
    return j, t


def _snapshot(tstate):
    return {"student": {k: v.clone() for k, v in tstate.student.state_dict().items()},
            "teacher": {k: v.clone() for k, v in tstate.teacher.state_dict().items()},
            "mu": {k: v.clone() for k, v in tstate.mu.items()},
            "nu": {k: v.clone() for k, v in tstate.nu.items()},
            "centers": [c.clone() for c in tstate.centers]}


def _want(jstate, part):
    """The port's names for esvit_tpu's ``part``: the nets carry their
    Performer projections (buffers) beside the parameters."""
    if part in ("student", "teacher"):
        extra = getattr(jstate, f"{part}_state") or {}
        return state_dict_from_flax(getattr(jstate, part),
                                    performer=extra.get("performer"))
    return state_dict_from_flax(getattr(_adam_state(jstate.opt_state), part))


@pytest.mark.parametrize("case", list(CASES))
def test_vil_option_steps_match_jax(case):
    check_steps(*CASES[case])


def check_steps(arch, kw, mode, t_mode, local):
    """STEPS steps of both packages from esvit_tpu's initial state, each
    held to the other after every step; ``local``: with local crops."""
    jc, tc = _cfgs(arch, kw)
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(4, 32, 32, 3)).astype(np.float32),)
    if local:
        batch += (rng.normal(size=(4, 24, 24, 3)).astype(np.float32),)
    jt = JTrainer(jc, total_batch_size=256)
    jb = tuple(map(jnp.asarray, batch))
    jstate = jt.init_state(jax.random.PRNGKey(0), jb)
    step = jax.jit(jt.train_step, static_argnames=("mode", "teacher_mode"))
    tt = TTrainer(tc, total_batch_size=256, device="cpu")
    tstate = train_state_from_jax(jax.device_get(jstate), tt)
    tb = tuple(map(torch.from_numpy, batch))
    nu1 = None
    for i in range(STEPS):
        jstate, m = step(jstate, jb, jax.random.PRNGKey(i + 1), mode=mode,
                         teacher_mode=t_mode)
        jstate = jax.device_get(jstate)
        tstate, tm = tt.train_step(tstate, tb, mode=mode,
                                   teacher_mode=t_mode)
        port = _snapshot(tstate)
        if nu1 is None:
            nu1 = {k: np.sqrt(v.numpy() / (1 - 0.999)) < TINY_GRAD
                   for k, v in _want(jstate, "nu").items()}
        np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                                   rtol=TOL, atol=TOL)
        for a, b in zip(port["centers"], jstate.centers):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                       atol=TOL)
        for part in ("student", "teacher", "mu", "nu"):
            want = _want(jstate, part)
            assert set(want) == set(port[part]), part
            for name, w in want.items():
                got, w = port[part][name].numpy(), w.numpy()
                if part == "nu":
                    got, w = np.sqrt(got), np.sqrt(w)
                t = nu1.get(name, np.zeros(w.shape, bool))
                np.testing.assert_allclose(
                    got[~t], w[~t], rtol=TOL, atol=TOL,
                    err_msg=f"step {i + 1} {part} {name}")
                np.testing.assert_allclose(
                    got[t], w[t], rtol=TINY_GRAD_TOL, atol=TINY_GRAD_TOL,
                    err_msg=f"step {i + 1} {part} {name} (tiny grad)")
