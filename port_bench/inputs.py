"""Weights and crops made from ``--seed`` on the device.

Both sides take the same tensors: the benchmark loads the weights into the
program's state and hands the same values, made again from the seed, to
the reference. Every stream has its own generator on the device, seeded
from (seed, stream, ...) through numpy's ``SeedSequence``, so any whole
number is a seed and the same seed gives the same tensors on one device.

Weights come from one draw over every parameter at once: a unit normal
truncated to [-2, 2] (two redraws of what falls outside, then a clamp),
then per parameter a scale and an offset laid out in one call: 0.02 for
matrices and tables (the port's ``trunc_normal_``), 0.02 around 1 for
1-D gains, 0.02 around 0 for biases (random, so that the check reaches
them), and 1 for the weight norm's gains ``weight_g``.

Stochastic depth's draws come from the seed too: for each checked step,
each crop group and each backbone block, two rows of uniforms, one for
the attention branch and one for the MLP branch, one a crop of the group.
A side keeps a crop's branch where its uniform lies under 1 - the block's
rate (reference/swin.py ``drop_path_rates``).
"""

from __future__ import annotations

import numpy as np
import torch

WEIGHTS, CROPS, DROPS = 0, 1, 2


def stream_seed(seed: int, *keys: int) -> int:
    words = [int(k) for k in (seed, *keys)]
    if min(words) < 0:
        raise ValueError(f"seeds are whole numbers >= 0, not {words}")
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def generator(device, seed: int, *keys: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *keys))


def _scale_offset(name: str, shape: tuple) -> tuple[float, float]:
    if name.endswith("weight_g"):
        return 0.0, 1.0
    if len(shape) == 1:
        return (0.02, 0.0) if name.endswith("bias") else (0.02, 1.0)
    return 0.02, 0.0


def make_weights(spec: list[tuple[str, tuple]], seed: int, device
                 ) -> dict[str, torch.Tensor]:
    """name -> float32 tensor for every (name, shape) of ``spec``."""
    gen = generator(device, seed, WEIGHTS)
    sizes = [int(np.prod(shape)) for _, shape in spec]
    total = sum(sizes)
    x = torch.randn(total, generator=gen, device=device)
    for _ in range(2):
        x = torch.where(x.abs() > 2.0,
                        torch.randn(total, generator=gen, device=device), x)
    x.clamp_(-2.0, 2.0)
    so = torch.tensor([_scale_offset(n, s) for n, s in spec],
                      dtype=torch.float32, device=device)
    counts = torch.tensor(sizes, device=device)
    x.mul_(torch.repeat_interleave(so[:, 0], counts, output_size=total))
    x.add_(torch.repeat_interleave(so[:, 1], counts, output_size=total))
    return {n: t.view(shape) for (n, shape), t in
            zip(spec, torch.split(x, sizes))}


def make_crops(traffic: dict, seed: int, index: int, rank: int, device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch ``index`` of process ``rank``: (global views (2B, S, S, 3),
    local views (L*B, s, s, 3)), NHWC float32, view-major rows."""
    gen = generator(device, seed, CROPS, index, rank)
    b = traffic["batch_per_card"]
    S, s = traffic["global_size"], traffic["local_size"]
    g = torch.randn((traffic["global_crops"] * b, S, S, 3), generator=gen,
                    device=device)
    loc = torch.randn((traffic["local_crops"] * b, s, s, 3), generator=gen,
                      device=device)
    return g, loc


def make_drop_draws(config: dict, traffic: dict, seed: int, step: int,
                    rank: int, device) -> list[torch.Tensor]:
    """Step ``step`` of process ``rank``: per crop group (globals, locals)
    a (blocks, 2, crops) float32 tensor of uniforms in [0, 1), the crops
    in the group's view-major row order."""
    gen = generator(device, seed, DROPS, step, rank)
    blocks = sum(config["model"]["depths"])
    b = traffic["batch_per_card"]
    return [torch.rand((blocks, 2, views * b), generator=gen, device=device)
            for views in (traffic["global_crops"], traffic["local_crops"])
            if views]
