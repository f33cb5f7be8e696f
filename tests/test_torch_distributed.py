"""The port's data parallelism on the CPU (gloo): parallel/mesh.py,
launch.py, the train step over processes and the evals' sharded
extraction.

- ``resolve_distributed_env`` equals esvit_tpu/launch.py's for SLURM,
  OpenMPI and torch-style environments, and adds the local rank.
- ``strided_shard``, ``pad_shard`` and ``merge_strided_shards`` equal
  esvit_tpu/evals/extract.py's.
- Two processes with half of a batch each take the same 2 steps (fp32,
  DDINO) as one process with the whole batch: the loss, both centers, the
  student, the teacher and both AdamW moments agree within 1e-6 of each
  tensor's scale (the sums over the batch are taken in another order).
  The weights also carry Adam's ratio: each update, lr * m / (sqrt(v) +
  eps), is a ratio of sums of the gradients, so it carries their relative
  rounding error (up to ~1e-5 for small sums taken in another order), and
  a tensor that starts at zero (a bias) has the updates' own size as its
  scale. So each weight may also differ by 1e-5 of the steps' summed
  learning rates; and weights whose gradient is below 1e-7 (the key
  bias: its exact gradient is 0, so it is rounding noise, which Adam's
  sign-like update scales up to the learning rate) are held at a tenth of
  the learning rate, as tests/test_torch_step.py:31-40 holds them.
- A two-process extraction returns, on each process, what one process
  returns.
- The CLI under ``--distributed`` with two gloo processes: both exit 0,
  rank 0 alone logs and checkpoints.
The processes are spawned; every join and subprocess has a timeout, so a
hung collective fails the test.
"""

import multiprocessing
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch import launch
from esvit_tpu_torch.evals import extract as textract
from esvit_tpu_torch.parallel.mesh import Mesh, make_mesh
from tests.torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180
B = 4          # the global per-view batch of the step test
STEPS = 2
SCALE_TOL = 1e-6
TINY_GRAD = 1e-7
ADAM_RATIO_TOL = 1e-5

_ENV_KEYS = ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_STEP_NODELIST",
             "SLURM_NODELIST", "SLURM_LOCALID", "OMPI_COMM_WORLD_SIZE",
             "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK",
             "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.mark.parametrize("env,local_rank", [
    ({"SLURM_PROCID": "3", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
      "SLURM_STEP_NODELIST": "node[01-02],node07", "MASTER_PORT": "2222"}, 1),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "1", "SLURM_NODELIST": "gpu5"}, 0),
    ({"OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "2",
      "OMPI_COMM_WORLD_LOCAL_RANK": "2", "MASTER_ADDR": "10.0.0.1"}, 2),
    ({"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1",
      "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500"}, 1),
    ({"WORLD_SIZE": "1", "RANK": "0"}, 0),
    ({}, None),
], ids=["slurm", "slurm-one", "openmpi", "torch", "torch-one", "none"])
def test_resolve_distributed_env_matches_esvit_tpu(monkeypatch, env,
                                                   local_rank):
    from esvit_tpu import launch as jlaunch

    for k in _ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = launch.resolve_distributed_env(), \
        jlaunch.resolve_distributed_env()
    if want is None:
        assert got is None
        with pytest.raises(RuntimeError, match="WORLD_SIZE and RANK"):
            launch.initialize_distributed(device="cpu")
        return
    assert got.pop("local_rank") == local_rank
    assert got == want


@pytest.mark.parametrize("n,pc", [(10, 1), (10, 3), (7, 4), (3, 5)])
def test_shards_match_esvit_tpu(n, pc):
    from esvit_tpu.evals import extract as jextract

    per = -(-n // pc)
    shards = []
    for pi in range(pc):
        got = textract.strided_shard(n, pi, pc)
        np.testing.assert_array_equal(got, jextract.strided_shard(n, pi, pc))
        x = (got[:, None] * np.ones((1, 3))).astype(np.float32)
        padded = textract.pad_shard(x, per, fill=-1)
        np.testing.assert_array_equal(padded,
                                      jextract.pad_shard(x, per, fill=-1))
        shards.append(padded)
    shards = np.stack(shards)
    merged = textract.merge_strided_shards(shards, n)
    np.testing.assert_array_equal(merged,
                                  jextract.merge_strided_shards(shards, n))
    np.testing.assert_array_equal(merged[:, 0], np.arange(n))


def test_mesh_without_a_group_and_its_refusals():
    mesh = make_mesh()
    assert (mesh.world, mesh.rank) == (1, 0)
    assert (mesh.data, mesh.model, mesh.data_index, mesh.model_index) == \
        (1, 1, 0, 0)
    t = [torch.ones(3), torch.tensor(2.0)]
    for over in ("world", "data", "model"):
        assert mesh.all_reduce_mean(t, over=over)[1] is t[1]
    assert mesh.model_sum(t)[1] is t[1]
    assert mesh.all_gather(np.arange(3)).shape == (1, 3)
    # One process makes no model axis of 2.
    with pytest.raises(ValueError, match="does not divide the 1 processes"):
        make_mesh(tcfg.MeshConfig(model=2))
    with pytest.raises(ValueError, match="2 != 1 processes"):
        make_mesh(tcfg.MeshConfig(data=2))


def _cfg():
    return tcfg.TrainConfig(
        model=tcfg.swin_femto(drop_path_rate=0.0),
        head=tcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=tcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=1),
        crops=tcfg.CropConfig(global_size=32, local_size=16,
                              local_crops_number=2),
        optim=tcfg.OptimConfig(lr=1e-3, epochs=2, warmup_epochs=0,
                               batch_size_per_device=B,
                               freeze_last_layer_epochs=0),
        dtype=torch.float32, steps_per_epoch=2)


def _steps(mesh: Mesh) -> dict:
    """STEPS steps on this process's share of each global batch; returns
    the losses and the state as host tensors."""
    from esvit_tpu_torch.io.checkpoint import state_to_dict
    from esvit_tpu_torch.train.step import EsViTTrainer

    torch.set_num_threads(1)
    trainer = EsViTTrainer(_cfg(), total_batch_size=B, device="cpu",
                           mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    share = slice(mesh.rank * B // mesh.world,
                  (mesh.rank + 1) * B // mesh.world)
    losses = []
    for _ in range(STEPS):
        # View-major rows: (views, B, ...) -> this process's samples.
        g = rng.normal(size=(2, B, 32, 32, 3)).astype(np.float32)
        loc = rng.normal(size=(2, B, 16, 16, 3)).astype(np.float32)
        batch = tuple(torch.from_numpy(np.ascontiguousarray(
            x[:, share].reshape(-1, *x.shape[2:]))) for x in (g, loc))
        _, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "state": state_to_dict(state)}


def _worker(rank, world, store, out, job):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        torch.save(job(make_mesh()), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, job, world=2):
    """job(mesh) in `world` gloo processes; their results by rank."""
    ctx = multiprocessing.get_context("spawn")
    out = str(tmp_path / "result")
    procs = [ctx.Process(target=_worker,
                         args=(r, world, str(tmp_path / "store"), out, job))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT)
        assert [p.exitcode for p in procs] == [0] * world, \
            [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    return [torch.load(f"{out}.{r}", weights_only=False)
            for r in range(world)]


def _close(name, got, want, tiny=None, tiny_tol=0.0, atol=1e-12):
    """|got - want| within SCALE_TOL of want's max-abs (plus ``atol``);
    elements marked ``tiny`` within ``tiny_tol``."""
    tiny = torch.zeros_like(want, dtype=torch.bool) if tiny is None else tiny
    scale = want.abs().max().item()
    err = (got - want).abs()
    assert err[~tiny].max().item() <= SCALE_TOL * scale + atol, (
        name, err[~tiny].max().item(), scale)
    assert (err[tiny] <= tiny_tol).all(), (name, err[tiny].max().item())


def test_two_gloo_processes_take_the_one_process_step(tmp_path):
    one = _steps(Mesh())
    ranks = _spawn(tmp_path, _steps)
    lr = _cfg().optim.lr * B / 256          # constant: no warmup, 2 steps
    tiny_tol = lr / 10
    adam_tol = ADAM_RATIO_TOL * lr * STEPS
    # The gradient's root mean square over the steps, from nu.
    tiny = {n: (v / (1 - 0.999 ** STEPS)).sqrt() < TINY_GRAD
            for n, v in one["state"]["nu"].items()}
    for got in ranks:
        np.testing.assert_allclose(got["losses"], one["losses"],
                                   rtol=SCALE_TOL)
        want, have = one["state"], got["state"]
        assert have["step"] == want["step"] == STEPS
        for key in ("center", "center_grid"):
            _close(key, have["centers"][key], want["centers"][key])
        for part in ("student", "teacher", "mu", "nu"):
            assert set(have[part]) == set(want[part])
            for name, w in want[part].items():
                if not w.is_floating_point():
                    assert torch.equal(have[part][name], w), name
                elif part in ("student", "teacher"):
                    _close(f"{part} {name}", have[part][name], w,
                           tiny.get(name), tiny_tol, adam_tol)
                else:
                    _close(f"{part} {name}", have[part][name], w)
    # The processes hold one replica: their states are equal bit for bit.
    for name, w in ranks[0]["state"]["student"].items():
        assert torch.equal(ranks[1]["state"]["student"][name], w), name


class _Toy:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return np.full((2, 2, 3), i, np.float32), i % 4


def _extract(mesh):
    del mesh
    return textract.extract_dataset_features(
        lambda x: x.reshape(len(x), -1)[:, :3] * 2.0, _Toy(), lambda a: a,
        batch_size=4, num_threads=2)


def test_two_process_extraction_equals_one_process(tmp_path):
    want = _extract(None)
    np.testing.assert_array_equal(want[0][:, 0], 2.0 * np.arange(11))
    for got in _spawn(tmp_path, _extract):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_over_two_gloo_processes(tmp_path):
    from tests.test_torch_entry import FEMTO, _png_folder

    data = _png_folder(tmp_path / "data", 8)
    out = tmp_path / "out"
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT,
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "esvit_tpu_torch.train.train", *FEMTO,
             "--batch_size_per_device", "1", "--distributed",
             "--data_kind", "folder", "--data_path", data,
             "--output_dir", str(out), "--epochs", "1", "--saveckp_freq",
             "1"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        texts = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    assert [p.returncode for p in procs] == [0, 0], texts
    for rank, text in enumerate(texts):
        assert f"torch.distributed: process {rank}/2, gloo on cpu" in text
    assert "checkpoint: checkpoint.pth, checkpoint0000.pth at step 4" \
        in texts[0]
    assert "checkpoint:" not in texts[1]
    assert sorted(os.listdir(out)) == ["checkpoint.pth",
                                       "checkpoint0000.pth", "log.txt"]
    assert len((out / "log.txt").read_text().splitlines()) == 1
    tree = torch.load(out / "checkpoint.pth", weights_only=True)
    assert tree["step"] == 4
