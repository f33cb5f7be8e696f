"""The DINO head's tensor parallelism (parallel/mesh.py's model axis) on
the CPU, against esvit_tpu's (data, model) mesh and the port's own one
process.

In one process, the model ranks are threads that exchange tensors
through a barrier (``_ThreadMesh``: the same collectives, summed in rank
order):
- rank r sits at (r // model, r % model) and holds the rows of the last
  layer that esvit_tpu's ``param_sharding`` puts on device r of its
  ``reshape(data, model)`` mesh;
- ``is_head_shard`` names exactly the tensors the heads build split;
- the heads built at model 1, 2 and 4 reassemble into the one-process
  head, weights and logits;
- a checkpoint saved at model 2 is the model-1 file, and a whole file
  restores at model 1, 2 and 4;
- ``train_state_from_jax`` gives each rank its rows of esvit_tpu's
  arrays;
- the clip's and LARS's norms are the whole tensors';
- every loss variant (DINO with and without mixup, DDINO, the streamed
  DDINO; fp32 and bf16) over the model axis equals the one-process loss,
  its gradients and its centers; the trap: ``model_sum``'s backward is
  the identity, where a summing backward gives ``model`` times the
  gradient;
- a train step over two model ranks equals the one-process step.
Spawned gloo processes (every join has a timeout):
- 4 processes at data=2 x model=2 take esvit_tpu's step under its
  (2, 2) mesh on 4 devices, on the same weights and batch (fp32);
- 2 processes at data=1 x model=2 take the port's one-process step with
  the streamed loss, BatchNorm heads and LARS;
- a SIGTERM on one model rank only: both ranks save and exit 0;
- the CLI with ``--distributed --mesh_model 2`` over two processes
  writes one whole checkpoint.pth, which a ``--mesh_model 1`` run
  resumes.
"""

import dataclasses
import multiprocessing
import os
import subprocess
import sys
import threading
from typing import Any

import numpy as np
import pytest
import torch
import torch.distributed as dist

from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch import losses as tlosses
from esvit_tpu_torch.io.checkpoint import (CheckpointManager, load_state_dict,
                                           state_to_dict)
from esvit_tpu_torch.models.esvit import EsViTModel
from esvit_tpu_torch.parallel.mesh import Mesh, is_head_shard, make_mesh
from esvit_tpu_torch.train import optim as toptim
from esvit_tpu_torch.train.step import EsViTTrainer
from tests.torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180
# The one-process references are the same sums taken in another order.
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5        # of each gradient's max-abs
BF16_GRAD_TOL = 1e-2   # a gradient rounded to bf16 at its leaf: 1 ulp
# The step tolerances of tests/test_torch_step.py: 1e-5, and where a
# gradient is below 1e-7 (rounding noise that Adam's sign-like update
# turns into a step of up to lr) a tenth of the learning rate.
STEP_TOL = 1e-5
TINY_GRAD = 1e-7


# ---------------------------------------------------------------------------
# Model ranks as threads.


class _Comm:
    """What ``n`` threads hand each other: each puts its tensor, and all
    read every rank's, between two barriers."""

    def __init__(self, n):
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=TIMEOUT)

    def exchange(self, index, t):
        self.slots[index] = t.clone()
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts


@dataclasses.dataclass(frozen=True)
class _ThreadMesh(Mesh):
    """One model group of threads (data = 1): the world and the model
    group are the threads, the data group is each thread alone."""

    comm: Any = dataclasses.field(default=None, compare=False, repr=False)

    def _reduce_(self, flat, over, op):
        if over == "data" or self.model == 1:
            return
        stacked = torch.stack(self.comm.exchange(self.model_index, flat))
        flat.copy_(stacked.sum(0) if op == dist.ReduceOp.SUM
                   else stacked.amax(0))

    def _broadcast_(self, buf, m):
        buf.copy_(self.comm.exchange(self.model_index, buf)[m])


def _on_threads(model, fn):
    """[fn(mesh) for each model rank], the ranks running at once."""
    comm = _Comm(model)
    out, errors = [None] * model, []

    def run(i):
        try:
            out[i] = fn(_ThreadMesh(world=model, rank=i, distributed=True,
                                    model=model, comm=comm))
        except BaseException as e:           # noqa: BLE001 - re-raised below
            errors.append(e)
            comm.barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(model)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errors:
        raise errors[0]
    return out


def _scale_close(name, got, want, tol):
    scale = want.abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale + 1e-12, (name, err, scale)


# ---------------------------------------------------------------------------
# The grid and the head.


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2), (2, 1), (1, 4),
                                        (3, 2)])
def test_grid_matches_esvit_tpu_mesh(data, model):
    """Rank r's (data, model) indices are device r's place in esvit_tpu's
    ``reshape(data, model)``, and its rows of the last layer are the
    columns esvit_tpu's param_sharding puts on that device."""
    import jax

    from esvit_tpu import config as jcfg
    from esvit_tpu.parallel import mesh as jmesh

    n = data * model
    devices = jax.devices()[:n]
    mesh = jmesh.make_mesh(jcfg.MeshConfig(data=data, model=model),
                           devices=devices)
    K, D = 8 * model, 3
    kernel_v = np.arange(D * K, dtype=np.float32).reshape(D, K)
    scale_g = np.arange(K, dtype=np.float32)
    tree = {"head": {"last_layer": {"kernel_v": kernel_v,
                                    "scale_g": scale_g}}}
    placed = jax.device_put(tree, jmesh.param_sharding(mesh, tree))
    v = placed["head"]["last_layer"]["kernel_v"]
    g = placed["head"]["last_layer"]["scale_g"]
    for r in range(n):
        port = Mesh(world=n, rank=r, distributed=True, model=model)
        d, m = np.argwhere(mesh.devices == devices[r])[0]
        assert (port.data, port.model) == (data, model)
        assert (port.data_index, port.model_index) == (d, m)
        on_r = {s.device: np.asarray(s.data) for s in v.addressable_shards}
        rows = port.rows(torch.from_numpy(kernel_v.T.copy()))
        np.testing.assert_array_equal(rows.numpy(), on_r[devices[r]].T)
        on_r = {s.device: np.asarray(s.data) for s in g.addressable_shards}
        np.testing.assert_array_equal(
            port.rows(torch.from_numpy(scale_g)).numpy(), on_r[devices[r]])


def _model_cfg():
    return tcfg.swin_femto(drop_path_rate=0.0)


HEAD = tcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8)


@pytest.mark.parametrize("model", [1, 2, 4])
def test_head_split_reassembles(model):
    """The heads of each model rank, drawn from one seed, are the
    one-process heads' rows, every other weight the same, and their
    logits that slice of the one-process logits."""
    def build(index, count):
        return EsViTModel(_model_cfg(), HEAD, generator=torch.Generator()
                          .manual_seed(0), head_shard=(index, count))

    whole = build(0, 1)
    ranks = [build(m, model) for m in range(model)]
    want = whole.state_dict()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        w_cls, w_reg, *_ = whole((x,), batch_size=1)
        outs = [r((x,), batch_size=1) for r in ranks]
    for name, w in want.items():
        got = [r.state_dict()[name] for r in ranks]
        if is_head_shard(name):
            assert all(t.shape[0] == w.shape[0] // model for t in got)
            assert torch.equal(torch.cat(got), w), name
        else:
            assert all(torch.equal(t, w) for t in got), name
    for k, want_k in ((0, w_cls), (1, w_reg)):
        got = torch.cat([o[k] for o in outs], dim=-1)
        np.testing.assert_allclose(got.numpy(), want_k.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("head,dense", [
    (HEAD, True), (dataclasses.replace(HEAD, use_bn=True), True),
    (dataclasses.replace(HEAD, nlayers=1), False)])
def test_is_head_shard_names_exactly_the_split_parameters(head, dense):
    """``is_head_shard`` (which step, optim, checkpoint and the weight
    bridge read) is true for exactly the tensors that the heads build
    split (``head_shard`` with count > 1), parameters and buffers."""
    def build(count):
        return EsViTModel(_model_cfg(), head, use_dense_prediction=dense,
                          generator=torch.Generator().manual_seed(0),
                          head_shard=(count - 1, count)).state_dict()

    whole, split = build(1), build(2)
    assert set(whole) == set(split)
    built = {k for k in whole if split[k].shape != whole[k].shape}
    assert built == {k for k in whole if is_head_shard(k)}
    assert len(built) == (4 if dense else 2)


# ---------------------------------------------------------------------------
# Checkpoints and the weight bridge.


def _train_cfg(**kw):
    return tcfg.TrainConfig(
        model=_model_cfg(), head=HEAD,
        loss=tcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=1),
        crops=tcfg.CropConfig(global_size=32, local_size=16,
                              local_crops_number=2),
        optim=tcfg.OptimConfig(lr=1e-3, epochs=2, warmup_epochs=0,
                               batch_size_per_device=2,
                               freeze_last_layer_epochs=0, **kw),
        dtype=torch.float32, steps_per_epoch=2)


def _moved_whole_tree(cfg):
    """A one-process state's whole tree with every float tensor moved by
    a seeded draw (moments, centers and all)."""
    state = EsViTTrainer(cfg, device="cpu").init_state(
        torch.Generator().manual_seed(0))
    tree = state_to_dict(state)
    gen = torch.Generator().manual_seed(1)
    for part in ("student", "teacher", "mu", "nu", "trace", "centers"):
        for k, v in tree[part].items():
            if v.is_floating_point():
                v.add_(torch.randn(v.shape, generator=gen).abs() * 0.1)
    tree["step"], tree["adam_count"] = 7, 7
    return tree


def _same_tree(got, want):
    assert (got["step"], got["adam_count"], got["optimizer"]) == \
        (want["step"], want["adam_count"], want["optimizer"])
    for part in ("student", "teacher", "mu", "nu", "trace", "centers"):
        assert set(got[part]) == set(want[part]), part
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)


def test_checkpoint_saved_at_model_2_is_the_model_1_file(tmp_path):
    """From one seed, two model ranks write the file one process writes:
    rank 0 writes it, rank 1 only gathers."""
    cfg = _train_cfg()
    one = EsViTTrainer(cfg, device="cpu").init_state(
        torch.Generator().manual_seed(0))
    CheckpointManager(str(tmp_path / "one")).save(one, epoch=0)

    def save(mesh):
        state = EsViTTrainer(cfg, device="cpu", mesh=mesh).init_state(
            torch.Generator().manual_seed(0))
        return CheckpointManager(str(tmp_path / "two")).save(
            state, epoch=0, mesh=mesh)

    paths = _on_threads(2, save)
    assert paths[0] == [str(tmp_path / "two" / "checkpoint.pth")]
    assert paths[1] == []
    load = lambda d: torch.load(d / "checkpoint.pth", weights_only=True)
    _same_tree(load(tmp_path / "two"), load(tmp_path / "one"))


@pytest.mark.parametrize("model", [1, 2, 4])
def test_whole_checkpoint_restores_at_any_grid(tmp_path, model):
    """A whole file restores at model 1, 2 and 4: each rank holds its rows
    of the head, its optimizer state and the centers, the rest whole, and
    the ranks gather back the file."""
    cfg = _train_cfg()
    tree = _moved_whole_tree(cfg)
    torch.save(tree, tmp_path / "checkpoint.pth")

    def restore(mesh):
        state = EsViTTrainer(cfg, device="cpu", mesh=mesh).init_state(
            torch.Generator().manual_seed(5))
        CheckpointManager(str(tmp_path)).restore(state, mesh=mesh)
        rows = {k: v for k, v in state.student.state_dict().items()
                if is_head_shard(k)}
        return rows, state.centers.center, state_to_dict(state, mesh)

    for m, (rows, center, gathered) in enumerate(_on_threads(model, restore)):
        n = 32 // model
        for k, v in rows.items():
            assert torch.equal(v, tree["student"][k][m * n:(m + 1) * n]), k
        assert torch.equal(center, tree["centers"]["center"][m * n:
                                                            (m + 1) * n])
        _same_tree(gathered, tree)


def _jax_state(optimizer):
    """esvit_tpu's femto train state with seeded values in every float
    leaf (its structure by jax.eval_shape: no init is run)."""
    import jax
    import jax.numpy as jnp

    from esvit_tpu import config as jcfg
    from esvit_tpu.train.step import EsViTTrainer as JTrainer

    cfg = jcfg.TrainConfig(
        model=jcfg.swin_femto(attention_impl="xla", fused_block_stages=()),
        head=jcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=jcfg.LossConfig(out_dim=32),
        optim=jcfg.OptimConfig(optimizer=optimizer), dtype=jnp.float32)
    crops = (jax.ShapeDtypeStruct((2, 32, 32, 3), jnp.float32),)
    trainer = JTrainer(cfg, total_batch_size=2)
    like = jax.eval_shape(
        lambda x: trainer.init_state(jax.random.PRNGKey(0), x), crops)
    rng = np.random.default_rng(2)
    return jax.tree.map(
        lambda s: (rng.normal(size=s.shape).astype(s.dtype)
                   if np.issubdtype(s.dtype, np.floating)
                   else np.zeros(s.shape, s.dtype)), like)


@pytest.mark.parametrize("optimizer", ["adamw", "lars"])
def test_jax_params_give_each_rank_its_rows(optimizer):
    """train_state_from_jax on a rank of model 2: its rows of kernel_v and
    scale_g, of their moments or trace and of the centers; every other
    tensor whole, as at model 1."""
    from esvit_tpu_torch.io.jax_params import train_state_from_jax

    j_state = _jax_state(optimizer)
    cfg = _train_cfg(optimizer=optimizer)
    whole = state_to_dict(train_state_from_jax(
        j_state, EsViTTrainer(cfg, device="cpu")))
    kv = np.asarray(j_state.student["head_dense"]["last_layer"]["kernel_v"])
    for m in range(2):
        mesh = Mesh(world=2, rank=m, distributed=True, model=2)
        part = state_to_dict(train_state_from_jax(
            j_state, EsViTTrainer(cfg, device="cpu", mesh=mesh)))
        rows = slice(16 * m, 16 * (m + 1))
        np.testing.assert_array_equal(
            part["student"]["head_dense.last_layer.weight_v"].numpy(),
            kv[:, rows].T)
        for name in ("student", "teacher", "mu", "nu", "trace", "centers"):
            assert set(part[name]) == set(whole[name])
            for k, w in whole[name].items():
                want = w[rows] if is_head_shard(k) or name == "centers" else w
                assert torch.equal(part[name][k], want), (name, k)
        moments = part["trace"] if optimizer == "lars" else part["mu"]
        assert moments["head.last_layer.weight_g"].shape == (16, 1)


# ---------------------------------------------------------------------------
# Norms over the whole tensor.


def _grads_and_params(seed):
    gen = torch.Generator().manual_seed(seed)
    shapes = {"backbone.w": (5, 3), "head.last_layer.weight_v": (8, 3),
              "head.last_layer.weight_g": (8, 1), "backbone.b": (5,)}
    make = lambda: {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    return make(), make(), make()


@pytest.mark.parametrize("optimizer", ["adamw", "lars"])
def test_clip_and_lars_norms_are_the_whole_tensors(optimizer):
    """The per-parameter clip (and LARS's trust ratio) on two ranks' rows
    of the last layer equal them on the whole tensors: the shards' rows
    of the result are the whole result's."""
    grads, params, state = _grads_and_params(3)
    names = list(grads)
    sharded = [is_head_shard(n) for n in names]

    def run(mesh):
        cut = ((lambda d: {k: (mesh.rows(v) if is_head_shard(k) else v)
                           .clone() for k, v in d.items()})
               if mesh is not None else
               (lambda d: {k: v.clone() for k, v in d.items()}))
        g, p, s = cut(grads), cut(params), cut(state)
        teacher = cut(params)
        common = dict(lr=0.5, wd=0.1, ema_m=0.9, clip=1.0,
                      decay_mask=[True] * 4, ll_mask=[False] * 4,
                      frozen=False, sharded=sharded, mesh=mesh)
        if optimizer == "adamw":
            nu = {k: v.abs() for k, v in cut(state).items()}
            toptim.fused_adamw_ema_apply(
                [g[n] for n in names], [p[n] for n in names],
                [s[n] for n in names], [nu[n] for n in names],
                [teacher[n] for n in names], count=3, **common)
        else:
            toptim.sgd_lars_ema_apply(
                "lars", [g[n] for n in names], [p[n] for n in names],
                [s[n] for n in names], [teacher[n] for n in names], **common)
        return p, s, teacher

    want = run(None)
    clipped = [torch.clamp(1.0 / (v.norm() + 1e-6), max=1.0).item()
               for v in grads.values()]
    assert min(clipped) < 1.0        # the clip acts on some tensors
    ranks = _on_threads(2, run)
    for i in range(3):
        for k in names:
            got = (torch.cat([r[i][k] for r in ranks]) if is_head_shard(k)
                   else ranks[0][i][k])
            np.testing.assert_allclose(got.numpy(), want[i][k].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# The losses over the model axis.

B, NCROPS, NT, NL, K, D, C = 2, 4, 4, 1, 16, 6, 5
S = 2 * NT + (NCROPS - 2) * NL
T_TEMP = 0.05


def _loss_inputs(variant, dtype):
    rng = np.random.default_rng(11)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32))
    if variant == "streamed":
        return {"s_cls_z": t(NCROPS * B, D).to(dtype),
                "s_reg_z": t(B, S, D).to(dtype), "s_fea": t(B, S, C),
                "t_cls_z": t(2 * B, D).to(dtype),
                "t_reg_z": t(B, 2 * NT, D).to(dtype), "t_fea": t(B, 2 * NT, C),
                "w_s": t(K, D), "w_t": t(K, D), "w_s_dense": t(K, D),
                "w_t_dense": t(K, D), "center": t(K, scale=0.1),
                "center_grid": t(K, scale=0.1)}
    x = {"s_cls": t(NCROPS * B, K, scale=3).to(dtype),
         "t_cls": t(2 * B, K).to(dtype), "center": t(K, scale=0.1)}
    if variant == "dino_mixup":
        mix = rng.random((NCROPS, B, B)).astype(np.float32)
        x["targets"] = torch.from_numpy(mix / mix.sum(-1, keepdims=True))
    if variant == "ddino":
        x.update(s_reg=t(B, S, K, scale=3).to(dtype), s_fea=t(B, S, C),
                 t_reg=t(B, 2 * NT, K).to(dtype), t_fea=t(B, 2 * NT, C),
                 center_grid=t(K, scale=0.1))
    return x


# The leaves that carry a gradient, and those of them split over K.
_GRAD_LEAVES = {"dino": ("s_cls",), "dino_mixup": ("s_cls",),
                "ddino": ("s_cls", "s_reg"),
                "streamed": ("s_cls_z", "s_reg_z", "w_s", "w_s_dense")}
_K_LEAVES = {"s_cls", "s_reg", "t_cls", "t_reg", "w_s", "w_t", "w_s_dense",
             "w_t_dense"}
_K_ROWS = {"w_s", "w_t", "w_s_dense", "w_t_dense", "center", "center_grid"}


def _run_loss(variant, x, mesh):
    """(loss, {leaf: grad}, centers) of this rank's K-slice of ``x``."""
    model = 1 if mesh is None else mesh.model
    index = 0 if mesh is None else mesh.model_index
    n = K // model

    def cut(k, v):
        if k in _K_ROWS:
            return v[index * n:(index + 1) * n]
        if k in _K_LEAVES:
            return v[..., index * n:(index + 1) * n]
        return v
    x = {k: cut(k, v).clone().requires_grad_(k in _GRAD_LEAVES[variant])
         for k, v in x.items()}
    centers = tlosses.DinoCenters(x["center"], x.get("center_grid",
                                                     x["center"]))
    if variant == "streamed":
        loss, new = tlosses.ddino_loss_streamed(
            x["s_cls_z"], x["s_reg_z"], x["s_fea"], x["t_cls_z"],
            x["t_reg_z"], x["t_fea"], x["w_s"], centers, T_TEMP,
            ncrops=NCROPS, batch_size=B, npatch=(NT, NL), t_npatch=NT,
            w_t=x["w_t"], w_s_dense=x["w_s_dense"], w_t_dense=x["w_t_dense"],
            n_chunks=2, mesh=mesh)
    elif variant == "ddino":
        loss, new = tlosses.ddino_loss(
            (x["s_cls"], x["s_reg"], x["s_fea"], (NT, NL)),
            (x["t_cls"], x["t_reg"], x["t_fea"], (NT,)), centers, T_TEMP,
            ncrops=NCROPS, batch_size=B, mesh=mesh)
    else:
        loss, center = tlosses.dino_loss(
            x["s_cls"], x["t_cls"], x["center"], T_TEMP, ncrops=NCROPS,
            mesh=mesh, targets_mixup=x.get("targets"))
        new = (center,)
    loss.backward()
    return (loss.detach(), {k: x[k].grad for k in _GRAD_LEAVES[variant]},
            [c.detach() for c in new])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("variant", ["dino", "dino_mixup", "ddino",
                                     "streamed"])
def test_loss_over_the_model_axis_is_the_whole_loss(variant, dtype):
    """Two model ranks, each with its K-slice of the logits (or of the
    last layers) and of the centers: the loss of each equals the
    one-process loss, bit for bit between them; each slice's gradient is
    the slice of the one-process gradient; the replicated bottlenecks'
    gradients summed over the ranks are the one-process ones; the
    centers are their slices of the one-process centers."""
    x = _loss_inputs(variant, dtype)
    want_loss, want_grads, want_centers = _run_loss(variant, x, None)
    ranks = _on_threads(2, lambda mesh: _run_loss(variant, x, mesh))
    assert torch.equal(ranks[0][0], ranks[1][0])
    np.testing.assert_allclose(ranks[0][0].item(), want_loss.item(),
                               rtol=LOSS_TOL)
    tol = GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
    for k, want in want_grads.items():
        parts = [r[1][k] for r in ranks]
        if k in _K_ROWS:
            got = torch.cat(parts)
        elif k in _K_LEAVES:
            got = torch.cat(parts, dim=-1)
        else:                                   # replicated: summed
            got = parts[0].float() + parts[1].float()
        _scale_close(k, got, want, tol)
    for got, want in zip(zip(*[r[2] for r in ranks]), want_centers):
        np.testing.assert_allclose(torch.cat(got).numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_model_sum_backward_is_the_identity():
    """The trap: every model rank computes the same loss from the summed
    statistic, so its gradient reaches each rank's own term once. A
    summing backward (torch.distributed.nn's all-reduce) gives each rank
    ``model`` times it."""
    class _SummingBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, mesh, x):
            ctx.mesh = mesh
            return mesh._flat_reduce([x], "model", dist.ReduceOp.SUM)[0]

        @staticmethod
        def backward(ctx, g):
            return None, ctx.mesh._flat_reduce([g], "model",
                                               dist.ReduceOp.SUM)[0]

    values = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, -1.0]),
              torch.tensor([0.5, 0.5]), torch.tensor([-2.0, 4.0])]
    total = sum(values)                     # dL/dx_m = 2 * total for all m

    def run(mesh, summing):
        x = values[mesh.model_index].clone().requires_grad_(True)
        y = (_SummingBackward.apply(mesh, x) if summing
             else mesh.model_sum([x])[0])
        (y * y).sum().backward()
        return x.grad

    for g in _on_threads(4, lambda mesh: run(mesh, False)):
        assert torch.equal(g, 2 * total)
    for g in _on_threads(4, lambda mesh: run(mesh, True)):
        assert torch.equal(g, 4 * 2 * total)
    tops = _on_threads(2, lambda mesh: mesh.model_max(
        [values[mesh.model_index].clone().requires_grad_(True)])[0])
    for m in tops:                          # model_max takes no gradient
        assert torch.equal(m, torch.maximum(values[0], values[1]))
        assert not m.requires_grad


# ---------------------------------------------------------------------------
# Train steps.


def _batch(step, B=2):
    """The batch of ``step``: 2 global and 2 local views of B images."""
    rng = np.random.default_rng(100 + step)
    return (torch.from_numpy(rng.normal(size=(2 * B, 32, 32, 3)).astype(
                np.float32)),
            torch.from_numpy(rng.normal(size=(2 * B, 16, 16, 3)).astype(
                np.float32)))


def _result(state, losses, mesh):
    """The losses, the whole state and this rank's own student tensors."""
    return {"losses": losses, "state": state_to_dict(state, mesh),
            "local": {k: v.detach().clone()
                      for k, v in state.student.state_dict().items()}}


def _steps(cfg, mesh, steps=2):
    """``steps`` steps from seed 0 on every rank's same batches (data=1)."""
    torch.set_num_threads(1)
    trainer = EsViTTrainer(cfg, total_batch_size=2, device="cpu", mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    losses = []
    for i in range(steps):
        _, m = trainer.train_step(state, _batch(i))
        losses.append(float(m["loss"]))
    return _result(state, losses, mesh)


def _check_steps(got, want, tiny_tol):
    """Losses, every tensor of the whole state and the centers against
    one process's (STEP_TOL; weights whose gradient is below TINY_GRAD
    within ``tiny_tol``)."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=STEP_TOL)
    g, w = got["state"], want["state"]
    steps = len(want["losses"])
    tiny = {n: (v / (1 - 0.999 ** steps)).sqrt() < TINY_GRAD
            for n, v in w["nu"].items()}
    for part in ("student", "teacher", "mu", "nu", "trace", "centers"):
        assert set(g[part]) == set(w[part]), part
        for k, v in w[part].items():
            a, b = g[part][k].numpy(), v.numpy()
            if part == "nu":
                a, b = np.sqrt(a), np.sqrt(b)
            small = (tiny[k].numpy() if k in tiny and part != "centers"
                     else np.zeros(b.shape, bool))
            np.testing.assert_allclose(a[~small], b[~small], rtol=STEP_TOL,
                                       atol=STEP_TOL, err_msg=f"{part} {k}")
            np.testing.assert_allclose(a[small], b[small], atol=tiny_tol,
                                       err_msg=f"{part} {k} (tiny grad)")


def _same_replicas(ranks):
    """Every replicated parameter is identical on every model rank."""
    for name, w in ranks[0]["local"].items():
        if not is_head_shard(name):
            for r in ranks[1:]:
                assert torch.equal(r["local"][name], w), name


@pytest.mark.parametrize("optimizer", ["adamw", "lars"])
def test_step_on_two_model_ranks_is_the_one_process_step(optimizer):
    cfg = _train_cfg(optimizer=optimizer)
    want = _steps(cfg, None)
    ranks = _on_threads(2, lambda mesh: _steps(cfg, mesh))
    for got in ranks:
        _check_steps(got, want, 1e-4)
    _same_replicas(ranks)


def _worker(rank, world, store, out, job, model):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        torch.save(job(make_mesh(tcfg.MeshConfig(model=model))),
                   f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, job, world, model):
    """job(mesh) in ``world`` gloo processes on a grid of ``model``; their
    results by rank."""
    ctx = multiprocessing.get_context("spawn")
    out = str(tmp_path / "result")
    procs = [ctx.Process(target=_worker,
                         args=(r, world, str(tmp_path / "store"), out, job,
                               model)) for r in range(world)]
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


def _bn_streamed_cfg():
    cfg = _train_cfg(optimizer="lars")
    return cfg.replace(
        head=dataclasses.replace(HEAD, use_bn=True),
        loss=dataclasses.replace(cfg.loss, streamed=True, stream_chunks=2))


def _bn_streamed_job(mesh):
    return _steps(_bn_streamed_cfg(), mesh)


def test_two_gloo_model_ranks_take_the_one_process_step(tmp_path):
    """data=1 x model=2 over gloo, the streamed loss, BatchNorm heads and
    LARS: the one-process steps, the replicas identical."""
    want = _steps(_bn_streamed_cfg(), None)
    ranks = _spawn(tmp_path, _bn_streamed_job, 2, 2)
    for got in ranks:
        _check_steps(got, want, 1e-4)
    _same_replicas(ranks)


# The data=2 x model=2 step against esvit_tpu's: test_torch_step.py's
# femto configuration with lr > 0 from step 0 and the last layer free.
JAX_TOTAL_BATCH = 256
JAX_B = 4                     # the global per-view batch


def _jax_pair_cfgs():
    import jax.numpy as jnp

    from esvit_tpu import config as jcfg
    common = dict(steps_per_epoch=2)
    j = jcfg.TrainConfig(
        model=jcfg.swin_femto(attention_impl="xla", fused_block_stages=(),
                              drop_path_rate=0.0),
        head=jcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=jcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=2),
        optim=jcfg.OptimConfig(lr=1e-3, epochs=4, warmup_epochs=0,
                               freeze_last_layer_epochs=0),
        dtype=jnp.float32, **common)
    t = tcfg.TrainConfig(
        model=tcfg.swin_femto(drop_path_rate=0.0), head=HEAD,
        loss=tcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=2),
        optim=tcfg.OptimConfig(lr=1e-3, epochs=4, warmup_epochs=0,
                               freeze_last_layer_epochs=0),
        mesh=tcfg.MeshConfig(data=2, model=2), dtype=torch.float32, **common)
    return j, t


def _jax_batch(step):
    rng = np.random.default_rng(200 + step)
    return (rng.normal(size=(2, JAX_B, 32, 32, 3)).astype(np.float32),
            rng.normal(size=(2, JAX_B, 24, 24, 3)).astype(np.float32))


class _JaxGridJob:
    """The port's ``steps`` steps on this rank's data share of each
    global batch, from the whole state at ``path`` (a picklable job)."""

    def __init__(self, path, steps):
        self.path, self.steps = path, steps

    def __call__(self, mesh):
        torch.set_num_threads(1)
        _, cfg = _jax_pair_cfgs()
        trainer = EsViTTrainer(cfg, total_batch_size=JAX_TOTAL_BATCH,
                               device="cpu", mesh=mesh)
        state = trainer.init_state(torch.Generator().manual_seed(9))
        load_state_dict(state, torch.load(self.path, weights_only=True),
                        mesh)
        n = JAX_B // mesh.data
        rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
        losses = []
        for i in range(self.steps):
            batch = tuple(torch.from_numpy(np.ascontiguousarray(
                x[:, rows].reshape(-1, *x.shape[2:]))) for x in _jax_batch(i))
            _, m = trainer.train_step(state, batch)
            losses.append(float(m["loss"]))
        return _result(state, losses, mesh)


def test_four_gloo_processes_take_esvit_tpus_data2_model2_step(tmp_path):
    """esvit_tpu's step under its data=2 x model=2 mesh on 4 devices (the
    shardings of tests/test_train_step.py:136-155) and the port's on 4
    gloo processes, from the same weights (train_state_from_jax) and
    batches: the losses, the whole states and the centers agree, and the
    replicas are identical on every model rank."""
    import jax
    import jax.numpy as jnp

    from esvit_tpu import config as jcfg
    from esvit_tpu.parallel import mesh as jmesh
    from esvit_tpu.train.step import EsViTTrainer as JTrainer
    from esvit_tpu_torch.io.jax_params import (_adam_state,
                                               state_dict_from_flax,
                                               train_state_from_jax)
    steps = 2
    jc, tc = _jax_pair_cfgs()
    jt = JTrainer(jc, total_batch_size=JAX_TOTAL_BATCH)
    flat = [tuple(jnp.asarray(x.reshape(-1, *x.shape[2:])) for x in
                  _jax_batch(i)) for i in range(steps)]
    state = jt.init_state(jax.random.PRNGKey(0), flat[0])
    whole = state_to_dict(train_state_from_jax(
        jax.device_get(state), EsViTTrainer(tc.replace(mesh=tcfg.MeshConfig()),
                                            device="cpu")))
    torch.save(whole, tmp_path / "init.pth")

    mesh = jmesh.make_mesh(jcfg.MeshConfig(data=2, model=2),
                           devices=jax.devices()[:4])
    p_shard = jmesh.param_sharding(mesh, state.student)
    state = state._replace(
        student=jax.device_put(state.student, p_shard),
        teacher=jax.device_put(state.teacher, p_shard),
        centers=jax.device_put(state.centers, jmesh.replicated(mesh)))
    step = jax.jit(jt.train_step)
    j_losses, nu1 = [], None
    for i in range(steps):
        batch = tuple(jax.device_put(b, jmesh.batch_sharding(mesh))
                      for b in flat[i])
        state, m = step(state, batch, jax.random.PRNGKey(i + 1))
        j_losses.append(float(m["loss"]))
        if nu1 is None:
            nu1 = state_dict_from_flax(jax.device_get(
                _adam_state(state.opt_state).nu))
    want = state_to_dict(train_state_from_jax(
        jax.device_get(state), EsViTTrainer(
            tc.replace(mesh=tcfg.MeshConfig()), device="cpu")))

    ranks = _spawn(tmp_path, _JaxGridJob(str(tmp_path / "init.pth"), steps),
                   4, 2)
    g1 = {k: np.sqrt(v.numpy() / (1 - 0.999)) for k, v in nu1.items()}
    for got in ranks:
        np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-5)
        assert got["state"]["step"] == steps
        for part in ("student", "teacher", "mu", "nu", "centers"):
            assert set(got["state"][part]) == set(want[part])
            for k, w in want[part].items():
                a, b = got["state"][part][k].numpy(), w.numpy()
                if part == "nu":
                    a, b = np.sqrt(a), np.sqrt(b)
                tiny = (g1[k] < TINY_GRAD if part != "centers"
                        else np.zeros(b.shape, bool))
                np.testing.assert_allclose(a[~tiny], b[~tiny], rtol=STEP_TOL,
                                           atol=STEP_TOL,
                                           err_msg=f"{part} {k}")
                np.testing.assert_allclose(a[tiny], b[tiny], atol=1e-4,
                                           err_msg=f"{part} {k} (tiny)")
    for d in range(2):
        _same_replicas(ranks[2 * d:2 * d + 2])


class _PreemptJob:
    """train() on the grid, with a SIGTERM raised on model rank 1 only,
    right after its first step: how each rank's run ended and at which
    step."""

    def __init__(self, out_dir):
        self.out_dir = out_dir

    def __call__(self, mesh):
        import signal

        from esvit_tpu_torch.train import train as ttrain

        torch.set_num_threads(1)
        step = EsViTTrainer.train_step

        def train_step(trainer, state, *a, **kw):
            out = step(trainer, state, *a, **kw)
            if mesh.model_index == 1 and state.step == 1:
                signal.raise_signal(signal.SIGTERM)
            return out

        EsViTTrainer.train_step = train_step
        cfg = _train_cfg().replace(output_dir=self.out_dir,
                                   mesh=tcfg.MeshConfig(model=2))
        try:
            state, _ = ttrain.train(cfg, max_steps=4, device="cpu",
                                    resume=False)
        except SystemExit as e:
            return {"exit": e.code}
        return {"exit": None, "step": state.step}


def test_sigterm_on_one_model_rank_checkpoints_on_every_rank(tmp_path):
    """A SIGTERM that reaches one model rank only: both ranks agree on it
    at the step boundary, save together (the save gathers the head over
    the model group) and exit 0, and the file is whole at step 1."""
    out = tmp_path / "out"
    ranks = _spawn(tmp_path, _PreemptJob(str(out)), 2, 2)
    assert ranks == [{"exit": 0}, {"exit": 0}]
    tree = torch.load(out / "checkpoint.pth", weights_only=True)
    assert tree["step"] == 1
    assert tree["student"]["head.last_layer.weight_v"].shape == (32, 8)
    assert tree["centers"]["center"].shape == (32,)


def test_cli_over_a_model_axis_writes_a_whole_checkpoint(tmp_path):
    """``--distributed --mesh_model 2`` over two gloo processes: both exit
    0, rank 0 alone writes one whole checkpoint.pth (the one-process
    layout), and a ``--mesh_model 1`` run resumes from it."""
    from tests.test_torch_distributed import _free_port
    from tests.test_torch_entry import FEMTO, _png_folder

    from esvit_tpu_torch.train import train as ttrain

    data = _png_folder(tmp_path / "data", 2)      # one step an epoch
    out = tmp_path / "out"
    port = str(_free_port())
    args = [*FEMTO, "--data_kind", "folder", "--data_path", data,
            "--output_dir", str(out), "--saveckp_freq", "0"]
    procs = []
    for rank in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT,
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "esvit_tpu_torch.train.train", *args,
             "--distributed", "--mesh_model", "2", "--epochs", "1"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        texts = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    assert [p.returncode for p in procs] == [0, 0], texts
    assert "checkpoint: checkpoint.pth at step 1" in texts[0], texts[0]
    assert "checkpoint:" not in texts[1]
    tree = torch.load(out / "checkpoint.pth", weights_only=True)
    assert tree["student"]["head.last_layer.weight_v"].shape == (32, 256)
    assert tree["centers"]["center"].shape == (32,)
    state, history = ttrain.train(
        ttrain.config_from_args(ttrain.get_args_parser().parse_args(
            [*args, "--epochs", "2"])),
        data_kind="folder", data_kwargs={"root": data}, max_steps=2,
        device="cpu")
    assert [h["step"] for h in history] == [2]
    assert state.step == 2
