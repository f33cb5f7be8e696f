"""The port's pre-training entry point (esvit_tpu_torch/train/train.py),
on the CPU at femto size.

- The CLI: ``config_from_args(get_args_parser().parse_args(argv))`` equals
  esvit_tpu's field by field (every field the port keeps), for several
  argv sets; the parsers have the same flags and defaults (the port adds
  ``--device``); the options that once were refused (SGD, LARS,
  BatchNorm heads, frozen layers, ``--mesh_model`` > 1) give esvit_tpu's
  config and pass ``check_supported`` (the model axis where it divides
  the world).
- Resume: 2 epochs, then 1 more from the checkpoint, equal 3 epochs at
  once bit for bit (drop-path 0: the step's random draws are not
  checkpointed, as in esvit_tpu); ``init_from`` loads a checkpoint as the
  initialisation and a local checkpoint wins over it.
- The CLI in a subprocess: SIGTERM after the first step's log line gives
  exit 0 and a checkpoint at the step it names, which a rerun resumes
  from; a NaN loss gives exit 1 and the named debug checkpoint.
- The evals' CLIs on a checkpoint that ``train()`` wrote.
- No module of the port, and not chip_smoke.py, imports JAX or esvit_tpu
  (their import statements, read by ``ast``).
Every subprocess has a timeout.
"""

import ast
import dataclasses
import json
import math
import os
import queue
import signal
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from esvit_tpu.train import train as jtrain
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.data.datasets import SyntheticImages
from esvit_tpu_torch.io.checkpoint import CheckpointManager
from esvit_tpu_torch.train import train as ttrain
from tests.torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The CLI at femto size: 224 px global crops (the CLI has no flag for
# them), two 32 px local crops, no dense head, fp32.
FEMTO = ["--arch", "swin_femto", "--window_size", "4", "--device", "cpu",
         "--out_dim", "32", "--batch_size_per_device", "2",
         "--local_crops_number", "2", "--local_crops_size", "32",
         "--no-bf16", "--no-use_dense_prediction", "--warmup_epochs", "0",
         "--freeze_last_layer", "0"]
TIMEOUT = 240


def _same(port, ref, path="cfg"):
    """Every field of the port's config equals the same-named field of
    esvit_tpu's (dtypes by name; nested dataclasses field by field)."""
    if dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            assert hasattr(ref, f.name), f"{path}.{f.name}"
            _same(getattr(port, f.name), getattr(ref, f.name),
                  f"{path}.{f.name}")
    elif isinstance(port, torch.dtype):
        assert str(port).removeprefix("torch.") == jnp.dtype(ref).name, path
    elif (isinstance(port, tuple) and port
          and dataclasses.is_dataclass(port[0])):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _same(a, b, f"{path}[{i}]")
    else:
        assert port == ref, (path, port, ref)


@pytest.mark.parametrize("argv", [
    [],
    ["--no-bf16"],
    ["--global_crops_scale", "0.25", "1.0", "--local_crops_scale", "0.05",
     "0.25", "--local_crops_number", "6", "--local_crops_size", "112"],
    ["--epochs", "100", "--warmup_epochs", "5", "--lr", "1e-3", "--min_lr",
     "2e-6", "--weight_decay", "0.05", "--weight_decay_end", "0.2",
     "--momentum_teacher", "0.99", "--warmup_teacher_temp", "0.03",
     "--warmup_teacher_temp_epochs", "10", "--teacher_temp", "0.05",
     "--freeze_last_layer", "2", "--clip_grad", "0"],
    ["--arch", "vil_tiny"],
    ["--arch", "swin_small", "--window_size", "14", "--out_dim", "4096",
     "--norm_last_layer", "--no-use_dense_prediction", "--seed", "3",
     "--saveckp_freq", "10", "--batch_size_per_device", "64",
     "--output_dir", "/elsewhere"],
    ["--use_mixup", "--num_mixup_views", "3", "--mixup", "0.5", "--cutmix",
     "0.7", "--mixup_prob", "0.9", "--mixup_switch_prob", "0.3",
     "--smoothing", "0.1"],
    ["--arch", "cvt_tiny"],
    ["--arch", "deit_small", "--no-bf16"],
    ["--arch", "vit_base", "--window_size", "14"],
], ids=["defaults", "no-bf16", "crops", "schedules", "vil_tiny", "misc",
        "mixup", "cvt_tiny", "deit_small", "vit_base"])
def test_cli_config_matches_esvit_tpu(argv):
    port = ttrain.config_from_args(ttrain.get_args_parser().parse_args(argv))
    ref = jtrain.config_from_args(jtrain.get_args_parser().parse_args(argv))
    _same(port, ref)
    tcfg.check_supported(port)


def test_cli_flags_and_defaults_match_esvit_tpu():
    def flags(parser):
        return {a.dest: (a.option_strings, a.default, a.choices, a.nargs)
                for a in parser._actions if a.dest != "help"}

    port = flags(ttrain.get_args_parser())
    ref = flags(jtrain.get_args_parser())
    assert port.pop("device") == (["--device"], "cuda", None, None)
    assert port == ref


@pytest.mark.parametrize("argv,item", [
    (["--use_bn_in_head"], "item 11"),
    (["--optimizer", "sgd"], "item 11"),
    (["--optimizer", "lars"], "item 11"),
    (["--arch", "cvt_tiny", "--optimizer", "sgd"], "item 11"),
    (["--frozen_layers", "patch_embed"], "item 12"),
    (["--mesh_model", "2"], "item 12"),
])
def test_unported_options_are_refused(tmp_path, argv, item):
    """Every flag of this list was once refused (ROADMAP queue 1 ``item``)
    and is ported now: its config equals esvit_tpu's and check_supported
    admits it (no training run here); the model axis where it divides
    the world, and a world it does not divide is refused before any
    setup."""
    port = ttrain.config_from_args(ttrain.get_args_parser().parse_args(argv))
    ref = jtrain.config_from_args(jtrain.get_args_parser().parse_args(argv))
    _same(port, ref)
    tcfg.check_supported(port)
    if "--mesh_model" in argv:
        assert port.mesh.model == 2
        tcfg.check_supported(port, world=2)
        with pytest.raises(ValueError, match="does not divide"):
            ttrain.main([*FEMTO, "--output_dir", str(tmp_path), *argv])
        assert not os.path.exists(tmp_path / "checkpoint.pth")


@pytest.mark.parametrize("kind", ["composite_tsv", "openimages_tsv"])
def test_cli_kinds_without_path_flags_are_refused_clearly(tmp_path, kind):
    """esvit_tpu's CLI passes these kinds no paths (a TypeError there);
    the port's CLI says to call train() with data_kwargs, before any
    setup."""
    with pytest.raises(ValueError, match=r"train\(cfg, data_kind="):
        ttrain.main([*FEMTO, "--output_dir", str(tmp_path), "--data_kind",
                     kind])
    assert not os.path.exists(tmp_path / "checkpoint.pth")


@pytest.mark.parametrize("argv,want", [
    (["--data_kind", "folder", "--data_path", "/d"], {"root": "/d"}),
    (["--data_kind", "zip", "--data_path", "/d.zip", "--zip_map_file",
      "/m.txt"], {"zip_path": "/d.zip", "map_file": "/m.txt"}),
    (["--data_kind", "tsv", "--data_path", "/d.tsv"], {"tsv_path": "/d.tsv"}),
    (["--data_kind", "synthetic"], {}),
])
def test_cli_data_kwargs_match_esvit_tpu(argv, want):
    """The CLI's build_dataset arguments per --data_kind, as esvit_tpu's
    main maps them (esvit_tpu/train/train.py:366-373)."""
    args = ttrain.get_args_parser().parse_args(argv)
    assert ttrain.data_kwargs_from_args(args) == want


def _jpeg_items(n, seed=0, png=(5,)):
    """n (name, bytes, label) items of 64 x 48 JPEGs (a PNG at ``png``)."""
    import io

    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        arr = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        b = io.BytesIO()
        fmt, ext = ("PNG", "png") if i in png else ("JPEG", "jpg")
        Image.fromarray(arr).save(b, fmt)
        items.append((f"c{i % 2}/{i}.{ext}", b.getvalue(), i % 2))
    return items


@pytest.mark.parametrize("argv", [
    ["--data_kind", "zip"],
    ["--data_kind", "tsv", "--host_aug", "--use_mixup", "--num_mixup_views",
     "2"],
], ids=["zip", "tsv-host_aug-mixup"])
def test_cli_trains_from_a_store(tmp_path, capsys, argv):
    """The CLI on the CPU at femto size, fed from a zip or TSV of JPEGs
    (and a PNG), 2 steps: finite losses in log.txt, a checkpoint at the
    last step."""
    from esvit_tpu_torch.data import stores

    items = _jpeg_items(8)
    stores.write_zip(items, str(tmp_path / "d.zip"), str(tmp_path / "m.txt"))
    stores.write_tsv(items, str(tmp_path / "d.tsv"))
    path = {"zip": ["--data_path", str(tmp_path / "d.zip"),
                    "--zip_map_file", str(tmp_path / "m.txt")],
            "tsv": ["--data_path", str(tmp_path / "d.tsv")]}[argv[1]]
    out = tmp_path / "out"
    ttrain.main([*FEMTO, "--output_dir", str(out), "--epochs", "1",
                 "--max_steps", "2", *path, *argv])
    log = [json.loads(line) for line in open(out / "log.txt")]
    assert len(log) == 1 and math.isfinite(log[0]["train_loss"])
    tree = torch.load(out / "checkpoint.pth", weights_only=True)
    assert tree["step"] == 2


def _cfg(out, epochs=3, **kw):
    return tcfg.TrainConfig(
        model=tcfg.swin_femto(drop_path_rate=0.0),
        head=tcfg.HeadConfig(out_dim=32, hidden_dim=16, bottleneck_dim=8),
        loss=tcfg.LossConfig(out_dim=32, warmup_teacher_temp_epochs=1),
        crops=tcfg.CropConfig(global_size=32, local_size=16,
                              local_crops_number=2),
        optim=tcfg.OptimConfig(lr=1e-3, epochs=epochs, warmup_epochs=1,
                               batch_size_per_device=2,
                               freeze_last_layer_epochs=1),
        dtype=torch.float32, steps_per_epoch=2, output_dir=str(out),
        save_every_epochs=1, **kw)


def _state_tensors(state):
    out = {f"s.{k}": v for k, v in state.student.state_dict().items()}
    out.update({f"t.{k}": v for k, v in state.teacher.state_dict().items()})
    out.update({f"mu.{k}": v for k, v in state.mu.items()})
    out.update({f"nu.{k}": v for k, v in state.nu.items()})
    out["center"], out["center_grid"] = state.centers
    return out


@pytest.mark.parametrize("feed", ["dataset", "synthetic_device"])
def test_resumed_run_equals_unbroken_run(tmp_path, capsys, feed):
    """2 epochs, a restart, 1 more epoch == 3 epochs, bit for bit."""
    kw = (dict(dataset=SyntheticImages(n=4, size=40)) if feed == "dataset"
          else dict(data_kind="synthetic_device"))
    whole, whole_hist = ttrain.train(_cfg(tmp_path / "a"), device="cpu", **kw)
    assert whole.step == 6
    part, _ = ttrain.train(_cfg(tmp_path / "b"), max_steps=4, device="cpu",
                           **kw)
    assert part.step == 4
    assert sorted(os.listdir(tmp_path / "b")) == [
        "checkpoint.pth", "checkpoint0000.pth", "checkpoint0001.pth",
        "log.txt"]
    capsys.readouterr()
    resumed, hist = ttrain.train(_cfg(tmp_path / "b"), device="cpu", **kw)
    assert "resumed from step 4" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [5, 6]
    assert [h["loss"] for h in hist] == [h["loss"] for h in whole_hist[4:]]
    want, got = _state_tensors(whole), _state_tensors(resumed)
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    assert (resumed.step, resumed.adam_count) == (6, 6)
    logs = [json.loads(line) for line in
            (tmp_path / "b" / "log.txt").read_text().splitlines()]
    assert [r["epoch"] for r in logs] == [0, 1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in logs)


def test_init_from_then_the_local_checkpoint_wins(tmp_path, capsys):
    ds = SyntheticImages(n=4, size=40)
    first, _ = ttrain.train(_cfg(tmp_path / "a", epochs=1), dataset=ds,
                            device="cpu")
    init = str(tmp_path / "a" / "checkpoint.pth")
    capsys.readouterr()
    state, hist = ttrain.train(_cfg(tmp_path / "b"), dataset=ds,
                               init_from=init, max_steps=3, device="cpu")
    out = capsys.readouterr().out
    assert f"initialized from {init} (step 2)" in out
    assert "resumed" not in out
    assert [h["step"] for h in hist] == [3]
    # b now holds its own checkpoint at step 3: it wins over init_from.
    state, hist = ttrain.train(_cfg(tmp_path / "b"), dataset=ds,
                               init_from=init, max_steps=4, device="cpu")
    out = capsys.readouterr().out
    assert "initialized from" in out and "resumed from step 3" in out
    assert [h["step"] for h in hist] == [4]
    missing = str(tmp_path / "none" / "checkpoint.pth")
    ttrain.train(_cfg(tmp_path / "c", epochs=0), dataset=ds,
                 init_from=missing, device="cpu")
    assert f"WARNING: init_from {missing} not found" in \
        capsys.readouterr().out


def test_profile_dir_and_git_line(tmp_path, capsys):
    ttrain.train(_cfg(tmp_path / "a", epochs=1), max_steps=1, device="cpu",
                 profile_dir=str(tmp_path / "prof"))
    out = capsys.readouterr().out
    assert out.startswith("git: ")
    trace = (tmp_path / "prof" / "trace.json").read_text()
    for span in ("esvit/teacher_forward", "esvit/student_forward",
                 "esvit/backward", "esvit/optimizer"):
        assert span in trace


def _png_folder(root, n, classes=2, size=40, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        d = root / f"c{i % classes}"
        d.mkdir(parents=True, exist_ok=True)
        arr = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        Image.fromarray(arr).save(d / f"{i}.png")
    return str(root)


def _cli(args, env_extra=None, **kw):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT,
               **(env_extra or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "esvit_tpu_torch.train.train", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, **kw)


def _lines(proc):
    """A queue of proc's output lines, read by a daemon thread."""
    q = queue.Queue()

    def read():
        for line in proc.stdout:
            q.put(line)
        q.put(None)

    threading.Thread(target=read, daemon=True).start()
    return q


def _wait_for(q, prefix, seen, timeout=TIMEOUT):
    while True:
        line = q.get(timeout=timeout)
        if line is None:
            raise AssertionError("exited before a line starting with "
                                 f"{prefix!r}:\n{''.join(seen)}")
        seen.append(line)
        if line.startswith(prefix):
            return


def _drain(q, proc, seen, timeout=TIMEOUT):
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    while (line := q.get(timeout=30)) is not None:
        seen.append(line)
    return "".join(seen)


def test_sigterm_checkpoints_exits_0_and_a_rerun_resumes(tmp_path):
    data = _png_folder(tmp_path / "data", 8)
    out = str(tmp_path / "out")
    args = [*FEMTO, "--data_kind", "folder", "--data_path", data,
            "--output_dir", out]
    proc = _cli([*args, "--epochs", "1000"])
    q, seen = _lines(proc), []
    try:
        _wait_for(q, "Epoch: [0/1000] [0]", seen)
        proc.send_signal(signal.SIGTERM)
        text = _drain(q, proc, seen)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, text
    assert "SIGTERM received" in text
    step = int(text.split("checkpointed at step ")[1].split(";")[0])
    tree = torch.load(os.path.join(out, "checkpoint.pth"), weights_only=True)
    assert tree["step"] == tree["adam_count"] == step >= 1
    rerun = subprocess.run(
        [sys.executable, "-m", "esvit_tpu_torch.train.train", *args,
         "--epochs", "1000", "--max_steps", str(step + 1)],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=TIMEOUT)
    assert rerun.returncode == 0, rerun.stdout + rerun.stderr
    assert f"resumed from step {step}" in rerun.stdout
    tree = torch.load(os.path.join(out, "checkpoint.pth"), weights_only=True)
    assert tree["step"] == step + 1


def test_nan_loss_saves_the_debug_checkpoint_and_exits_1(tmp_path):
    out = tmp_path / "out"
    data = _png_folder(tmp_path / "data", 8)
    proc = subprocess.run(
        [sys.executable, "-m", "esvit_tpu_torch.train.train", *FEMTO,
         "--data_kind", "folder", "--data_path", data, "--output_dir",
         str(out), "--epochs", "3", "--lr", "1e35", "--clip_grad", "0"],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=TIMEOUT)
    text = proc.stdout + proc.stderr
    assert proc.returncode == 1, text
    assert "Loss is nan, stopping training" in text
    step = int(text.split("checkpoint: checkpoint.pth, checkpoint0000.pth "
                          "at step ")[1].split(",")[0])
    assert sorted(os.listdir(out)) == ["checkpoint.pth",
                                       "checkpoint0000.pth"]
    tree = torch.load(out / "checkpoint0000.pth", weights_only=True)
    assert tree["step"] == step
    assert not all(torch.isfinite(v).all()
                   for v in tree["student"].values())


def test_eval_clis_on_a_checkpoint_train_wrote(tmp_path):
    from esvit_tpu_torch.data.datasets import ImageFolder
    from esvit_tpu_torch.evals import knn, linear
    from esvit_tpu_torch.models.registry import build_backbone

    state, _ = ttrain.train(_cfg(tmp_path / "run", epochs=1),
                            dataset=SyntheticImages(n=4, size=40),
                            device="cpu")
    ckpt = str(tmp_path / "run" / "checkpoint.pth")
    train_dir = _png_folder(tmp_path / "train", 12, classes=3, seed=1)
    val_dir = _png_folder(tmp_path / "val", 6, classes=3, seed=2)
    common = ["--arch", "swin_femto", "--window_size", "4", "--device", "cpu",
              "--pretrained", ckpt, "--train_path", train_dir, "--val_path",
              val_dir, "--output_dir", str(tmp_path / "eval")]
    got = knn.main([*common, "--batch_size", "4", "--nb_knn", "3"])
    backbone = build_backbone(tcfg.swin_femto())
    backbone.load_state_dict(state.teacher.backbone.state_dict())
    want = knn.run_knn_eval(backbone, ImageFolder(train_dir),
                            ImageFolder(val_dir), ks=(3,), batch_size=4,
                            device="cpu")
    assert got == want
    top1, top5 = linear.main([*common, "--epochs", "2", "--batch_size", "4",
                              "--cached_features"])
    assert 0.0 <= top1 <= 100.0 and 0.0 <= top5 <= 100.0
    assert "linear_top1" in (tmp_path / "eval" / "log.txt").read_text()


# The CLI at femto size for the BatchNorm family and for DeiT: 224 px
# global crops, two 32 px locals, B=2, the dense head, fp32.
SMALL = ["--device", "cpu", "--out_dim", "32", "--batch_size_per_device",
         "2", "--local_crops_number", "2", "--local_crops_size", "32",
         "--no-bf16", "--warmup_epochs", "0", "--freeze_last_layer", "0",
         "--data_kind", "synthetic"]


def _bn_buffers(sd):
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def test_cli_cvt_femto_trains_resumes_and_evaluates(tmp_path, capsys):
    """--arch cvt_femto: 2 steps write the student's and the teacher's
    BatchNorm buffers (moved from 0 / 1, and each net's own); the
    checkpoint restores them bit for bit into a state drawn from another
    seed; a rerun resumes from step 2; the k-NN and linear CLIs read the
    run's checkpoint."""
    from esvit_tpu_torch.evals import knn, linear
    from esvit_tpu_torch.train.step import EsViTTrainer

    out = tmp_path / "out"
    args = ["--arch", "cvt_femto", *SMALL, "--output_dir", str(out),
            "--epochs", "1"]
    ttrain.main([*args, "--max_steps", "2"])
    tree = torch.load(out / "checkpoint.pth", weights_only=True)
    assert tree["step"] == 2
    student, teacher = (_bn_buffers(tree[k]) for k in ("student", "teacher"))
    assert len(student) == len(teacher) == 4
    for k, v in student.items():
        init = 0.0 if k.endswith("mean") else 1.0
        assert (v - init).abs().min() > 0 and (teacher[k] - init).abs().min() > 0
        assert not torch.equal(v, teacher[k]), k

    cfg = ttrain.config_from_args(ttrain.get_args_parser().parse_args(args))
    state = EsViTTrainer(cfg, device="cpu").init_state(
        torch.Generator().manual_seed(1))
    CheckpointManager(str(out)).restore(state)
    for name, sd in (("student", state.student.state_dict()),
                     ("teacher", state.teacher.state_dict())):
        for k, v in _bn_buffers(tree[name]).items():
            assert torch.equal(sd[k], v), (name, k)

    capsys.readouterr()
    ttrain.main([*args, "--max_steps", "3"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert torch.load(out / "checkpoint.pth", weights_only=True)["step"] == 3

    train_dir = _png_folder(tmp_path / "train", 12, classes=3, seed=1)
    val_dir = _png_folder(tmp_path / "val", 6, classes=3, seed=2)
    common = ["--arch", "cvt_femto", "--device", "cpu", "--pretrained",
              str(out / "checkpoint.pth"), "--train_path", train_dir,
              "--val_path", val_dir, "--output_dir", str(tmp_path / "eval")]
    got = knn.main([*common, "--batch_size", "4", "--nb_knn", "3"])
    assert 0.0 <= got[3][0] <= 100.0
    top1, _ = linear.main([*common, "--epochs", "2", "--batch_size", "4",
                           "--cached_features"])
    assert 0.0 <= top1 <= 100.0


def test_cli_deit_tiny_trains(tmp_path):
    """--arch deit_tiny at full width, 2 steps: finite losses in log.txt
    and a checkpoint with the reference's ViT names."""
    out = tmp_path / "out"
    ttrain.main(["--arch", "deit_tiny", *SMALL, "--output_dir", str(out),
                 "--epochs", "1", "--max_steps", "2"])
    log = [json.loads(line) for line in open(out / "log.txt")]
    assert len(log) == 1 and math.isfinite(log[0]["train_loss"])
    tree = torch.load(out / "checkpoint.pth", weights_only=True)
    assert tree["step"] == 2
    assert tree["teacher"]["pos_embed"].shape == (1, 197, 192)
    assert "blocks.11.mlp.fc2.weight" in tree["student"]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax_and_no_esvit_tpu():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "esvit_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert any(f.endswith("launch.py") for f in files)
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax",
                               "esvit_tpu"), (f, name)
