"""The learning gate's training trajectory, the port against esvit_tpu.

The gate's nano Swin (esvit_tpu_torch/validate_learning.py) starts from
esvit_tpu's initial state (carried over by io/jax_params.py) and both
trainers take the same 20 steps on the same batches: esvit_tpu's own
MultiCropIterator epoch over ProceduralShapesHard, augmented by JAX. 20
steps at ``steps // 20`` steps per epoch run the gate's whole compressed
schedule (LR warmup, teacher-temperature warmup, the last-layer freeze,
cosine decay). B=4 with the gate's total batch of 64, so the learning
rate is the gate's.

Tolerances. fp32: every step's loss within 1e-5, the centres within
1e-5, and each of student and teacher differs by at most 1e-3 of how far
it moved (global L2 norms). bf16, the gate's dtype: both sides round
activations to 8 bits at points whose sums run in other orders, and
Adam's update, being sign-like, carries that into the weights; every
loss within 5e-2, the centres within 5e-3, and the weights' difference
at most 0.1 of their move.
"""

import numpy as np
import pytest
import torch

STEPS, B, TOTAL_BATCH = 20, 4, 64
TOL = {"fp32": dict(loss=1e-5, center=1e-5, moved=1e-3),
       "bf16": dict(loss=5e-2, center=5e-3, moved=0.1)}


@pytest.fixture(scope="module")
def batches():
    from esvit_tpu.data.datasets import ProceduralShapesHard
    from esvit_tpu.data.loader import MultiCropIterator

    from esvit_tpu_torch import validate_learning as vl

    _, img = vl.build_config(steps=STEPS, batch=B)
    ds = ProceduralShapesHard(n=B * STEPS, size=img, seed=0)
    it = MultiCropIterator(ds, _jax_cfg("fp32", 1).crops, B, epoch=0, seed=0,
                           native_decode=False, num_threads=2)
    out = [tuple(np.array(x) for x in b) for b in it]
    assert len(out) == STEPS
    return out


def _jax_cfg(dtype, steps_per_epoch):
    import jax.numpy as jnp

    from esvit_tpu import config as jcfg

    model = jcfg.SwinConfig(img_size=64, patch_size=4, embed_dim=32,
                            depths=(2, 2, 2), num_heads=(2, 4, 4),
                            window_size=4, drop_path_rate=0.0,
                            attention_impl="xla", fused_block_stages=())
    crops = jcfg.CropConfig(global_size=64, global_scale=(0.4, 1.0),
                            local_size=32, local_scale=(0.3, 0.8),
                            local_crops_number=4)
    return jcfg.TrainConfig(
        model=model,
        head=jcfg.HeadConfig(out_dim=1024, hidden_dim=512, bottleneck_dim=64,
                             norm_last_layer=False),
        loss=jcfg.LossConfig(out_dim=1024, use_dense_prediction=True,
                             warmup_teacher_temp_epochs=5),
        crops=crops,
        optim=jcfg.OptimConfig(epochs=20, warmup_epochs=4, lr=4e-3,
                               batch_size_per_device=B,
                               freeze_last_layer_epochs=1),
        steps_per_epoch=steps_per_epoch,
        dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32, seed=0)


def _global_norm(a, b):
    return sum(((a[k].float() - b[k].float()) ** 2).sum().item()
               for k in a) ** 0.5


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gate_trajectory_matches_esvit_tpu(batches, dtype):
    import jax
    import jax.numpy as jnp

    from esvit_tpu.train.step import EsViTTrainer as JTrainer
    from esvit_tpu_torch import validate_learning as vl
    from esvit_tpu_torch.io.jax_params import (state_dict_from_flax,
                                               train_state_from_jax)
    from esvit_tpu_torch.train.step import EsViTTrainer as TTrainer

    tol = TOL[dtype]
    tc, _ = vl.build_config(steps=STEPS, batch=B)
    if dtype == "fp32":
        tc = tc.replace(dtype=torch.float32)
    jc = _jax_cfg(dtype, tc.steps_per_epoch)
    assert tc.steps_per_epoch == 1 and tc.optim.epochs == STEPS
    jt = JTrainer(jc, total_batch_size=TOTAL_BATCH)
    jstate = jt.init_state(jax.random.PRNGKey(0),
                           tuple(map(jnp.asarray, batches[0])))
    step = jax.jit(jt.train_step)
    tt = TTrainer(tc, total_batch_size=TOTAL_BATCH, device="cpu")
    tstate = train_state_from_jax(jax.device_get(jstate), tt)
    init = {part: {k: v.clone() for k, v in
                   getattr(tstate, part).state_dict().items()}
            for part in ("student", "teacher")}
    for i, b in enumerate(batches):
        jstate, jm = step(jstate, tuple(map(jnp.asarray, b)),
                          jax.random.PRNGKey(i + 1))
        tstate, tm = tt.train_step(tstate, tuple(map(torch.from_numpy, b)))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= tol["loss"], (
            i, float(tm["loss"]), float(jm["loss"]))
    jstate = jax.device_get(jstate)
    for name in ("center", "center_grid"):
        got = getattr(tstate.centers, name).numpy()
        want = np.asarray(getattr(jstate.centers, name))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol["center"],
                                   err_msg=name)
    for part in ("student", "teacher"):
        want = state_dict_from_flax(getattr(jstate, part))
        got = getattr(tstate, part).state_dict()
        moved = _global_norm(want, init[part])
        assert moved > 0, part
        assert _global_norm(got, want) <= tol["moved"] * moved, part
