"""scripts/orbax_to_torch.py: esvit_tpu's orbax checkpoints into the
port's checkpoint.pth, on the CPU.

A femto esvit_tpu train state (the train CLI's flags, a BatchNorm head,
AdamW or LARS), its weights, optimizer state and centers moved off their
initial values, is saved with esvit_tpu's own CheckpointManager; the
script turns the directory into a .pth. On it:
- the port's evals (``load_backbone_variables``) give the teacher
  features that esvit_tpu's evals give on the orbax directory (fp32,
  1e-5);
- the port's resume (``CheckpointManager.restore``) takes the whole
  state: the step, both nets, the optimizer's state and the centers
  equal esvit_tpu's arrays through ``train_state_from_jax``, bit for bit.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu.evals import knn as jknn
from esvit_tpu.io.checkpoint import CheckpointManager as JCheckpointManager
from esvit_tpu.models.registry import build_backbone as jbuild
from esvit_tpu.train import train as jtrain
from esvit_tpu.train.step import EsViTTrainer as JTrainer
from esvit_tpu_torch.evals import knn as tknn
from esvit_tpu_torch.io.checkpoint import CheckpointManager, state_to_dict
from esvit_tpu_torch.io.jax_params import train_state_from_jax
from esvit_tpu_torch.models.registry import build_backbone as tbuild
from esvit_tpu_torch.train import train as ttrain
from esvit_tpu_torch.train.step import EsViTTrainer as TTrainer
from tests.torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_TOL = 1e-5
FLAGS = ["--arch", "swin_femto", "--window_size", "4", "--out_dim", "32",
         "--local_crops_number", "2", "--local_crops_size", "32",
         "--no-bf16", "--use_bn_in_head", "--batch_size_per_device", "2"]


def _script():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(ROOT, "scripts", "orbax_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _moved_state(argv):
    """esvit_tpu's initial state for the CLI flags, every float leaf moved
    by a seeded draw, at step 5."""
    cfg = jtrain.config_from_args(jtrain.get_args_parser().parse_args(argv))
    trainer = JTrainer(cfg, total_batch_size=2)
    crops = (jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 32, 32, 3)))
    state = trainer.init_state(jax.random.PRNGKey(0), crops)
    rng = np.random.default_rng(3)

    def move(x):
        x = np.asarray(x)
        if not np.issubdtype(x.dtype, np.floating):
            return x
        return (x + 0.1 * rng.normal(size=x.shape)).astype(x.dtype)
    state = jax.tree.map(move, jax.device_get(state))
    return cfg, state._replace(step=np.asarray(5, np.int32))


def _same(name, got, want):
    assert set(got) == set(want), name
    for k, v in want.items():
        assert torch.equal(got[k], v), f"{name} {k}"


@pytest.mark.parametrize("optimizer", ["adamw", "lars"])
def test_orbax_checkpoint_becomes_the_ports_pth(tmp_path, optimizer):
    argv = [*FLAGS, "--optimizer", optimizer]
    j_cfg, j_state = _moved_state(argv)
    JCheckpointManager(str(tmp_path / "jax")).save(j_state, epoch=0)
    orbax_dir = str(tmp_path / "jax" / "checkpoint")
    pth = _script().main([*argv, "--checkpoint_dir", orbax_dir,
                          "--output", str(tmp_path / "torch" /
                                          "checkpoint.pth")])

    x = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    t_args = ttrain.get_args_parser().parse_args([*argv, "--device", "cpu"])
    t_cfg = ttrain.config_from_args(t_args)
    j_backbone = jbuild(j_cfg.model)
    j_vars = jknn.load_backbone_variables(j_backbone, j_cfg.model, orbax_dir)
    j_cls, j_fea = jax.jit(lambda v, x: j_backbone.apply(
        v, x, deterministic=True))(j_vars, jnp.asarray(x))
    port = tknn.load_backbone_variables(tbuild(t_cfg.model), t_cfg.model,
                                        pth)
    with torch.no_grad():
        t_cls, t_fea = port.forward_features(torch.from_numpy(x))
    for got, want in ((t_cls, j_cls), (t_fea, j_fea)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FEAT_TOL, atol=FEAT_TOL)

    trainer = TTrainer(t_cfg, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(1))
    assert CheckpointManager(str(tmp_path / "torch")).restore(state) \
        is not None
    got = state_to_dict(state)
    want = state_to_dict(train_state_from_jax(j_state, trainer))
    assert got["step"] == want["step"] == 5
    assert got["optimizer"] == want["optimizer"] == optimizer
    assert got["adam_count"] == want["adam_count"]
    for part in ("student", "teacher", "mu", "nu", "trace", "centers"):
        _same(part, got[part], want[part])
    assert bool(got["trace"]) == (optimizer == "lars")
    np.testing.assert_array_equal(
        got["student"]["head.last_layer.weight_v"].numpy(),
        np.asarray(j_state.student["head"]["last_layer"]["kernel_v"]).T)
    np.testing.assert_array_equal(got["centers"]["center"].numpy(),
                                  np.asarray(j_state.centers.center))
