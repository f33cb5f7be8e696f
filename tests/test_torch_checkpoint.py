"""The port's checkpoints (esvit_tpu_torch/io/checkpoint.py), on the CPU.

- A round trip restores every tensor of the training state bit for bit
  (student, teacher, both AdamW moments, both centers) and the counters,
  into a state drawn from another seed; the file holds host tensors only.
  The same for SGD's and LARS's trace with BatchNorm heads' buffers; a
  file of one optimizer does not restore into another's state.
- The cadence of esvit_tpu's CheckpointManager: checkpoint.pth every save,
  checkpoint{epoch:04d}.pth every ``save_every_epochs`` epochs or with
  ``force_named``.
- A save that fails before its rename leaves the last good file and no
  temporary file.
- The evals load the port's checkpoint by key, as they load the
  reference's .pth.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io import checkpoint as ckpt_lib
from esvit_tpu_torch.io.checkpoint import CheckpointManager
from esvit_tpu_torch.train.step import EsViTTrainer
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def _cfg(dense=True):
    return tcfg.TrainConfig(
        model=tcfg.swin_femto(drop_path_rate=0.0),
        head=tcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=tcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=1,
                             use_dense_prediction=dense),
        crops=tcfg.CropConfig(global_size=32, local_size=16,
                              local_crops_number=2),
        optim=tcfg.OptimConfig(lr=1e-3, epochs=2, warmup_epochs=0,
                               batch_size_per_device=2,
                               freeze_last_layer_epochs=0),
        dtype=torch.float32, steps_per_epoch=2)


def _stepped_state(cfg, seed=0, steps=1):
    trainer = EsViTTrainer(cfg, total_batch_size=2, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        batch = (torch.from_numpy(rng.normal(size=(4, 32, 32, 3))
                                  .astype(np.float32)),
                 torch.from_numpy(rng.normal(size=(4, 16, 16, 3))
                                  .astype(np.float32)))
        trainer.train_step(state, batch, torch.Generator().manual_seed(1))
    return trainer, state


def _tensors(state):
    out = {f"student.{k}": v for k, v in state.student.state_dict().items()}
    out.update({f"teacher.{k}": v
                for k, v in state.teacher.state_dict().items()})
    out.update({f"mu.{k}": v for k, v in state.mu.items()})
    out.update({f"nu.{k}": v for k, v in state.nu.items()})
    out["center"], out["center_grid"] = state.centers
    return out


@pytest.mark.parametrize("dense", [True, False])
def test_round_trip_is_bit_exact(tmp_path, dense):
    cfg = _cfg(dense)
    trainer, state = _stepped_state(cfg, steps=2)
    CheckpointManager(str(tmp_path)).save(state, epoch=0)
    other = trainer.init_state(torch.Generator().manual_seed(5))
    assert not torch.equal(other.student.head.last_layer.weight_v,
                           state.student.head.last_layer.weight_v)
    restored = CheckpointManager(str(tmp_path)).restore(other)
    assert restored is other
    assert (other.step, other.adam_count) == (state.step, state.adam_count) \
        == (2, 2)
    want, got = _tensors(state), _tensors(other)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        assert torch.equal(got[name], w), name
    tree = torch.load(tmp_path / "checkpoint.pth", weights_only=True)
    assert set(tree) == {"step", "adam_count", "student", "teacher",
                         "optimizer", "mu", "nu", "trace", "centers"}
    assert tree["optimizer"] == "adamw" and tree["trace"] == {}
    for part in ("student", "teacher", "mu", "nu"):
        assert all(v.device.type == "cpu" for v in tree[part].values())


@pytest.mark.parametrize("optimizer", ["sgd", "lars"])
def test_trace_round_trip_and_optimizer_mismatch(tmp_path, optimizer):
    cfg = _cfg(True)
    cfg = cfg.replace(head=tcfg.HeadConfig(out_dim=32, hidden_dim=16,
                                           bottleneck_dim=8, use_bn=True),
                      optim=dataclasses.replace(cfg.optim,
                                                optimizer=optimizer))
    trainer, state = _stepped_state(cfg, steps=2)
    assert state.mu == {} and state.trace
    CheckpointManager(str(tmp_path)).save(state, epoch=0)
    other = trainer.init_state(torch.Generator().manual_seed(5))
    CheckpointManager(str(tmp_path)).restore(other)
    for name, t in state.trace.items():
        assert torch.equal(other.trace[name], t), name
    for name, t in state.student.state_dict().items():
        assert torch.equal(other.student.state_dict()[name], t), name
    assert any(k.startswith("head.mlp.1.running") for k in
               other.teacher.state_dict())
    adamw = EsViTTrainer(_cfg(True), total_batch_size=2, device="cpu")
    with pytest.raises(ValueError, match=f"optimizer '{optimizer}'"):
        CheckpointManager(str(tmp_path)).restore(
            adamw.init_state(torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("epoch,every,force,named", [
    (0, 5, False, True),     # 0 % 5 == 0, as esvit_tpu
    (3, 5, False, False),
    (10, 5, False, True),
    (3, 0, False, False),    # 0 disables the numbered keeps
    (3, 5, True, True),      # the NaN guard's debug checkpoint
    (7, 1, False, True),
])
def test_save_cadence_matches_esvit_tpu(tmp_path, epoch, every, force,
                                        named):
    _, state = _stepped_state(_cfg(False))
    mgr = CheckpointManager(str(tmp_path))
    assert not mgr.has_checkpoint()
    paths = mgr.save(state, epoch=epoch, save_every_epochs=every,
                     force_named=force)
    want = ["checkpoint.pth"] + ([f"checkpoint{epoch:04d}.pth"]
                                 if named else [])
    assert [os.path.basename(p) for p in paths] == want
    assert sorted(os.listdir(tmp_path)) == sorted(want)
    assert mgr.has_checkpoint()
    if named:
        assert (tmp_path / want[1]).read_bytes() == \
            (tmp_path / want[0]).read_bytes()


@pytest.mark.parametrize("fail_at", ["torch.save", "os.replace"])
def test_interrupted_save_leaves_the_last_good_file(tmp_path, monkeypatch,
                                                    fail_at):
    trainer, state = _stepped_state(_cfg(False))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, epoch=0, save_every_epochs=1)
    good = {n: (tmp_path / n).read_bytes() for n in os.listdir(tmp_path)}
    trainer.train_step(state, (torch.zeros(4, 32, 32, 3),
                               torch.zeros(4, 16, 16, 3)))

    def fail(*a, **k):
        raise OSError("disk gone")

    target = torch if fail_at == "torch.save" else ckpt_lib.os
    monkeypatch.setattr(target, fail_at.split(".")[1], fail)
    with pytest.raises(OSError, match="disk gone"):
        mgr.save(state, epoch=1, save_every_epochs=1)
    monkeypatch.undo()
    assert {n: (tmp_path / n).read_bytes()
            for n in os.listdir(tmp_path)} == good
    fresh = trainer.init_state(torch.Generator().manual_seed(3))
    assert mgr.restore(fresh).step == 1


def test_restore_without_a_file_and_with_another_model(tmp_path):
    trainer, state = _stepped_state(_cfg(False))
    mgr = CheckpointManager(str(tmp_path / "new"))
    assert mgr.restore(state) is None and not mgr.has_checkpoint()
    mgr.save(state, epoch=0)
    assert mgr.restore(state, "checkpoint0003") is None
    _, dense = _stepped_state(_cfg(True))
    with pytest.raises(RuntimeError, match="head_dense"):
        mgr.restore(dense)


@pytest.mark.parametrize("key", ["teacher", "student"])
def test_evals_load_the_ports_checkpoint(tmp_path, key):
    from esvit_tpu_torch.evals.knn import load_backbone_variables
    from esvit_tpu_torch.models.registry import build_backbone

    cfg = _cfg(True)
    _, state = _stepped_state(cfg, steps=2)
    path = CheckpointManager(str(tmp_path)).save(state, epoch=0)[0]
    backbone = build_backbone(cfg.model,
                              generator=torch.Generator().manual_seed(9))
    backbone = load_backbone_variables(backbone, cfg.model, path, key)
    model = getattr(state, key)
    want = model.backbone.state_dict()
    got = backbone.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    x = torch.randn(2, 32, 32, 3)
    with torch.no_grad():
        np.testing.assert_array_equal(
            backbone.forward_features(x)[0].numpy(),
            model.backbone.forward_features(x)[0].numpy())
