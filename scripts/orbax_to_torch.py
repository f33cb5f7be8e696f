"""Convert an esvit_tpu orbax checkpoint into esvit_tpu_torch's checkpoint.pth.

esvit_tpu saves its training state with orbax (esvit_tpu/io/checkpoint.py:
a directory per checkpoint); esvit_tpu_torch reads ``torch.save`` files
(esvit_tpu_torch/io/checkpoint.py). Reading orbax takes jax, orbax and
tensorstore, so this script runs where the JAX package is installed, on
the CPU, and writes the whole state (student, teacher, the optimizer's
state, both DINO centers and the step) as the port's own file. The port
reads that file unchanged: ``--pretrained`` of its evals (``teacher`` or
``student``), ``--pretrained_weights_ckpt`` of its train CLI, or resume,
with the file as ``checkpoint.pth`` in ``--output_dir``, at any
``--mesh_model``.

    python scripts/orbax_to_torch.py --checkpoint_dir out/checkpoint \\
        --output out_torch/checkpoint.pth --arch swin_tiny --out_dim 65536

The remaining flags are the training run's (the train CLI's: ``--arch``,
``--window_size``, ``--out_dim``, ``--use_bn_in_head``,
``--norm_last_layer``, ``--use_dense_prediction``, ``--optimizer``,
...): they rebuild the state's structure, which orbax restores into
(esvit_tpu's ``CheckpointManager.restore`` on the abstract state, no
weights drawn). The conversion is ``train_state_from_jax`` then
``state_to_dict`` (esvit_tpu_torch/io).
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from esvit_tpu.io.checkpoint import CheckpointManager  # noqa: E402
from esvit_tpu.train import train as jtrain  # noqa: E402
from esvit_tpu.train.step import EsViTTrainer as JTrainer  # noqa: E402
from esvit_tpu_torch.io.checkpoint import state_to_dict  # noqa: E402
from esvit_tpu_torch.io.jax_params import train_state_from_jax  # noqa: E402
from esvit_tpu_torch.train import train as ttrain  # noqa: E402
from esvit_tpu_torch.train.step import EsViTTrainer as TTrainer  # noqa: E402


def get_args_parser():
    """The port's train CLI flags, plus where to read and write."""
    p = ttrain.get_args_parser()
    p.description = ("Convert an esvit_tpu orbax checkpoint directory into "
                     "esvit_tpu_torch's checkpoint.pth")
    p.add_argument("--checkpoint_dir", required=True,
                   help="esvit_tpu's orbax checkpoint directory (e.g. "
                        "<output_dir>/checkpoint or checkpoint0010)")
    p.add_argument("--output", required=True,
                   help="the .pth file to write")
    return p


def restore_jax_state(args):
    """esvit_tpu's TrainState of the orbax directory, as host arrays."""
    cfg = jtrain.config_from_args(args)
    trainer = JTrainer(cfg, total_batch_size=cfg.optim.batch_size_per_device)
    c = cfg.crops
    crops = (jax.ShapeDtypeStruct((2, c.global_size, c.global_size, 3),
                                  jnp.float32),)
    if c.local_crops_number:
        crops += (jax.ShapeDtypeStruct(
            (c.local_crops_number, c.local_size, c.local_size, 3),
            jnp.float32),)
    like = jax.eval_shape(
        lambda x: trainer.init_state(jax.random.PRNGKey(0), x), crops)
    path = os.path.abspath(args.checkpoint_dir)
    state = CheckpointManager(os.path.dirname(path)).restore(
        like, os.path.basename(path))
    if state is None:
        raise SystemExit(f"no orbax checkpoint directory at {path}")
    return jax.device_get(state)


def main(argv=None) -> str:
    args = get_args_parser().parse_args(argv)
    jax_state = restore_jax_state(args)
    trainer = TTrainer(ttrain.config_from_args(args), device="cpu")
    tree = state_to_dict(train_state_from_jax(jax_state, trainer))
    out = os.path.abspath(args.output)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, out)
    print(f"wrote {out}: step {tree['step']}, optimizer {tree['optimizer']}, "
          f"{len(tree['student'])} student tensors", flush=True)
    return out


if __name__ == "__main__":
    main()
