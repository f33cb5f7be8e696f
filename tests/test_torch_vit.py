"""The port's ViT/DeiT backbone and train step against esvit_tpu.

Same weights (the JAX init, carried over by io/jax_params.py) and the
same numpy inputs through both packages, fp32. A two-block ViT of width
32 with DeiT's 224 px / patch-16 geometry: its 14x14 position grid is
resampled to 6x6 at 96 px and 7x7 at 112 px (scale sqrt(npatch / N)),
``forward_selfattention``, ``forward_return_n_last_blocks`` with and
without ``avgpool``, a reference-named state dict made with numpy
through esvit_tpu's importer and the port's loader, and a 2-step train
step. Tolerance 1e-5 relative to each output's scale (fp32 sums in
another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.io import torch_import
from esvit_tpu.models.vit import VisionTransformer as JViT
from esvit_tpu.ops.resample import torch_interpolate_scale as jax_resample
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import state_dict_from_flax
from esvit_tpu_torch.io.torch_checkpoint import load_backbone_checkpoint
from esvit_tpu_torch.models.registry import build_backbone
from esvit_tpu_torch.models.vit import VisionTransformer as TViT
from esvit_tpu_torch.ops.resample import torch_interpolate_scale
from tests.test_torch_cvt import (check_step, drop_path_draws, run_steps,
                                  scaled_close)
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
STEPS = 2


def _cfg(pkg, **kw):
    return pkg.ViTConfig(embed_dim=32, depth=2, num_heads=2, **kw)




@pytest.fixture(scope="module")
def jax_model():
    model = JViT(_cfg(jcfg))
    params = jax.jit(lambda r: model.init(
        {"params": r}, jnp.zeros((1, 224, 224, 3))))(jax.random.PRNGKey(0))
    return model, jax.tree.map(np.asarray, params["params"])


def _port(params):
    model = TViT(_cfg(tcfg))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def _x(size, n=2, seed=0):
    return np.random.default_rng(seed + size).normal(
        size=(n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("n", [6, 7])
def test_pos_embed_resample_matches_jax(n):
    """14 -> 6 (96 px) and 14 -> 7 (112 px): values and gradient."""
    scale = math.sqrt(n * n / 196)
    rng = np.random.default_rng(n)
    x = (0.02 * rng.normal(size=(1, 14, 14, 8))).astype(np.float32)
    w = rng.normal(size=(1, n, n, 8)).astype(np.float32)
    want = np.asarray(jax_resample(jnp.asarray(x), scale))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(
        jax_resample(a, scale) * w))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = torch_interpolate_scale(xt, scale)
    (got * torch.from_numpy(w)).sum().backward()
    assert got.shape == want.shape == (1, n, n, 8)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL * 0.02)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("size", [224, 112, 96])
def test_forward_features_matches_jax(jax_model, size):
    model, params = jax_model
    x = _x(size)
    j_cls, j_patch = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        t_cls, t_patch = _port(params).forward_features(torch.from_numpy(x))
    assert t_patch.shape == (2, (size // 16) ** 2, 32)
    scaled_close(t_patch.numpy(), j_patch, what="patch tokens")
    scaled_close(t_cls.numpy(), j_cls, what="cls")


@pytest.mark.parametrize("n", [1, 2])
def test_forward_selfattention_matches_jax(jax_model, n):
    model, params = jax_model
    x = _x(96, seed=n)
    want = model.apply({"params": params}, jnp.asarray(x), n,
                       method=JViT.forward_selfattention)
    with torch.no_grad():
        got = _port(params).forward_selfattention(torch.from_numpy(x), n)
    if n == 1:
        got, want = [got], [want]
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (2, 2, 37, 37)
        scaled_close(a.numpy(), b)


@pytest.mark.parametrize("avgpool", [False, True])
@pytest.mark.parametrize("n", [1, 2])
def test_n_last_blocks_matches_jax(jax_model, n, avgpool):
    model, params = jax_model
    x = _x(112, seed=10 * n + avgpool)
    want = model.apply({"params": params}, jnp.asarray(x), n, avgpool,
                       method=JViT.forward_return_n_last_blocks)
    with torch.no_grad():
        got = _port(params).forward_return_n_last_blocks(
            torch.from_numpy(x), n, avgpool=avgpool)
    assert got.shape == (2, 32 * (n + avgpool))
    scaled_close(got.numpy(), want)


def test_state_dict_round_trip(jax_model):
    """flax -> the port's state dict (the reference's names) ->
    torch_import -> the same flax params."""
    _, params = jax_model
    sd = _port(params).state_dict()
    assert {"cls_token", "pos_embed", "patch_embed.proj.weight",
            "blocks.1.norm1.weight", "blocks.1.attn.qkv.weight",
            "blocks.1.attn.proj.bias", "blocks.1.norm2.bias",
            "blocks.1.mlp.fc1.weight", "blocks.1.mlp.fc2.weight",
            "norm.weight"} <= set(sd)
    assert len(sd) == 6 + 2 * 12
    assert sd["patch_embed.proj.weight"].shape == (32, 3, 16, 16)
    assert sd["pos_embed"].shape == (1, 197, 32)
    back = torch_import.import_vit_backbone({k: v.numpy()
                                             for k, v in sd.items()})
    jax.tree.map(np.testing.assert_array_equal, back["params"], params)


def test_reference_checkpoint_loads_as_in_jax(jax_model, tmp_path):
    """A reference-named .pth (vision_transformer.py's names, made with
    numpy, with DINO head entries) through esvit_tpu's import_vit_backbone
    into JAX and through the port's load_backbone_checkpoint (strict):
    the same features at 96 px."""
    model, params = jax_model
    rng = np.random.default_rng(3)
    sd = {k: (v.numpy() + rng.normal(0, 0.05, v.shape)).astype(np.float32)
          for k, v in _port(params).state_dict().items()}
    sd["head.last_layer.weight_v"] = np.ones((4, 32), np.float32)
    torch.save({"teacher": {f"module.{k}": torch.from_numpy(v)
                            for k, v in sd.items()}},
               tmp_path / "ref.pth")
    imported = torch_import.import_vit_backbone(sd)
    x = _x(96, seed=4)
    want = model.apply(imported, jnp.asarray(x))[1]
    port = load_backbone_checkpoint(TViT(_cfg(tcfg)), str(tmp_path /
                                                         "ref.pth"))
    with torch.no_grad():
        got = port.forward_features(torch.from_numpy(x))[1]
    scaled_close(got.numpy(), want)


@pytest.mark.parametrize("preset", ["deit_tiny", "deit_small", "vit_base"])
def test_presets_have_jax_shapes(preset):
    """Every parameter of the preset's backbone has the name and shape
    that the bridge gives JAX's (jax.eval_shape, no weights drawn)."""
    v = jax.eval_shape(lambda: JViT(jcfg.get_model_config(preset)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3))))
    want = state_dict_from_flax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), v["params"]))
    got = TViT(tcfg.get_model_config(preset)).state_dict()
    assert {k: tuple(x.shape) for k, x in got.items()} == \
        {k: tuple(x.shape) for k, x in want.items()}


def test_vit_is_built_and_admitted():
    assert isinstance(build_backbone(tcfg.deit_small()), TViT)
    tcfg.check_supported(tcfg.deit_small_multicrop())
    tcfg.check_supported(tcfg.TrainConfig(
        model=tcfg.deit_small(attn_drop_rate=0.1, drop_rate=0.1)))
    tp = tcfg.deit_small_multicrop(mesh=tcfg.MeshConfig(model=2))
    tcfg.check_supported(tp, world=2)
    with pytest.raises(ValueError, match="does not divide the 1 processes"):
        tcfg.check_supported(tp, world=1)


def test_vit_block_draws_one_drop_path_twice():
    from esvit_tpu_torch.models.vit import Block

    blk = Block(_cfg(tcfg), 0.3, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1024, 5, 32, generator=torch.Generator().manual_seed(1))
    drop_path_draws(blk, x, 0.3)


@pytest.fixture(scope="module")
def vit_steps():
    return run_steps(_cfg(jcfg, img_size=64), _cfg(tcfg, img_size=64),
                     (64, 32))


@pytest.mark.parametrize("after", [1, STEPS])
def test_vit_step_matches_jax(vit_steps, after):
    """64 px globals (native 4x4 grid) and 32 px locals (the position
    table resampled to 2x2)."""
    jax_hist, port_hist = vit_steps
    assert check_step(jax_hist, port_hist, after) == 0
