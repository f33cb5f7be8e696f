"""The port's ResNet (esvit_tpu_torch/models/resnet.py) against
esvit_tpu's on bridged weights, fp32 on the CPU.

- ResNet-50's parameter count and every tensor's name and shape through
  the weight bridge (torchvision's names: conv1, bn1, layer{i}.{j}.conv{k},
  downsample.0/.1); the bridge round trip reproduces each JAX leaf.
- ``forward_features`` at 32 and 64 px on running statistics within 1e-5
  of the largest |feature|; on batch statistics each block on esvit_tpu's
  input to it within 5e-5 (both sides' fp32 statistics, see BLOCK_TOL),
  and every running buffer after that pass within 1e-5.
- One bottleneck on batch statistics: output and gradients within 1e-5.
- The region tokens: the final grid, 2*49 + 8*9 = 170 per image at
  224/96 as Swin-T's; ``forward_return_n_last_blocks`` is the pooled
  feature.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.models.resnet import ResNet as JResNet
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import state_dict_from_flax
from esvit_tpu_torch.models.registry import build_backbone
from esvit_tpu_torch.models.resnet import ResNet as TResNet
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture(scope="module")
def bridged():
    """JAX ResNet-50's variables (random init) and the port's model with
    them loaded."""
    jm = JResNet(jcfg.ResNetConfig(depth=50))
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((2, 32, 32, 3)),
                                  bn_train=False))(jax.random.PRNGKey(0))
    v = jax.device_get(v)
    # Running statistics away from their (0, 1) start, so the running
    # mode is held on non-trivial buffers.
    rng = np.random.default_rng(1)
    v["batch_stats"] = jax.tree.map(
        lambda a: (a + rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    tm = TResNet(tcfg.ResNetConfig(depth=50))
    tm.load_state_dict(state_dict_from_flax(v["params"], v["batch_stats"]))
    return jm, v, tm


def test_parameter_count_and_names(bridged):
    jm, v, tm = bridged
    n_jax = sum(x.size for x in jax.tree.leaves(v["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax == 23508032
    names = set(tm.state_dict())
    for k in ("conv1.weight", "bn1.running_var", "layer1.0.conv1.weight",
              "layer1.0.bn3.bias", "layer1.0.downsample.0.weight",
              "layer1.0.downsample.1.running_mean", "layer4.2.conv3.weight",
              "layer3.5.bn2.weight"):
        assert k in names, k
    assert "layer1.1.downsample.0.weight" not in names
    assert tuple(tm.state_dict()["layer2.0.conv2.weight"].shape) == \
        (128, 128, 3, 3)
    assert isinstance(build_backbone(tcfg.ResNetConfig(depth=50)), TResNet)


def test_bridge_round_trip(bridged):
    """Each port tensor is its JAX leaf: conv kernels HWIO -> OIHW,
    BatchNorm scale/bias/mean/var -> weight/bias/running_*."""
    _, v, tm = bridged
    sd = tm.state_dict()
    stem = v["params"]["stem"]
    np.testing.assert_array_equal(
        sd["conv1.weight"].numpy(),
        np.asarray(stem["conv"]["kernel"]).transpose(3, 2, 0, 1))
    down = v["batch_stats"]["layer3_block0"]["down"]["bn"]
    np.testing.assert_array_equal(sd["layer3.0.downsample.1.running_var"],
                                  np.asarray(down["var"]))
    cb = v["params"]["layer2_block1"]["cb3"]
    np.testing.assert_array_equal(sd["layer2.1.bn3.weight"],
                                  np.asarray(cb["bn"]["scale"]))
    np.testing.assert_array_equal(
        sd["layer2.1.conv3.weight"].numpy(),
        np.asarray(cb["conv"]["kernel"]).transpose(3, 2, 0, 1))
    n_leaves = len(jax.tree.leaves(v["params"])) + len(
        jax.tree.leaves(v["batch_stats"]))
    assert len(sd) == n_leaves


def _close(got, want, name, tol=TOL):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=name)


def _jax_blocks(m, x):
    """The input of the stem and of each bottleneck, and the last output,
    in batch-statistics mode."""
    import flax.linen as nn

    outs = [x]
    x = jax.nn.relu(m.stem(x, True))
    outs.append(nn.max_pool(x, (3, 3), strides=(2, 2),
                            padding=[(1, 1), (1, 1)]))
    for blk in m.blocks:
        outs.append(blk(outs[-1], True))
    return outs


@pytest.mark.parametrize("size", [32, 64])
def test_forward_on_running_statistics_matches_esvit_tpu(bridged, size):
    """bn_train=False: the whole network within 1e-5, the buffers
    untouched."""
    jm, v, tm = bridged
    x = np.random.default_rng(size).normal(size=(4, size, size, 3)).astype(
        np.float32)
    jcls, jreg = jax.jit(lambda v, x: jm.apply(
        v, x, method=jm.forward_features))(v, jnp.asarray(x))
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    with torch.no_grad():
        cls, reg = tm.forward_features(torch.from_numpy(x), bn_train=False)
    side = size // 32
    assert tuple(reg.shape) == (4, side * side, 2048)
    _close(cls.numpy(), np.asarray(jcls), "cls")
    _close(reg.numpy(), np.asarray(jreg), "region")
    assert all(torch.equal(t, before[k]) for k, t in tm.state_dict().items())


# Batch statistics are E[x^2] - E[x]^2 in fp32 on both sides (flax's
# fast variance, models/batchnorm.py); after a ReLU the conv outputs have
# mean^2 / var up to ~10, so each side's own rounding of the statistics
# moves a block's output by up to ~2e-5 of its largest value (1.8e-5
# measured, layer1.0 at 64 px). Each block is therefore held on esvit_tpu's
# input to it, at BLOCK_TOL; chained through the 16 blocks these
# roundings reach ~5e-4 at 64 px.
BLOCK_TOL = 5e-5


@pytest.mark.parametrize("size", [32, 64])
def test_forward_on_batch_statistics_matches_esvit_tpu(bridged, size):
    """bn_train=True: the stem and each bottleneck on esvit_tpu's input to
    it, within BLOCK_TOL of its largest output; then every running buffer
    after that pass within 1e-5 of esvit_tpu's updated one."""
    import torch.nn.functional as F

    jm, v, tm = bridged
    x = np.random.default_rng(size).normal(size=(4, size, size, 3)).astype(
        np.float32)
    outs, upd = jax.jit(lambda v, x: jm.apply(
        v, x, method=_jax_blocks, mutable=["batch_stats"]))(v, jnp.asarray(x))
    outs = [np.array(o) for o in outs]
    model = TResNet(tcfg.ResNetConfig(depth=50))
    model.load_state_dict(tm.state_dict())
    blocks = [b for layer in model.layers() for b in layer]
    with torch.no_grad():
        y = F.relu(model.bn1(model.conv1(torch.from_numpy(outs[0])), True))
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        _close(y.numpy(), outs[1], "stem", BLOCK_TOL)
        for i, blk in enumerate(blocks):
            y = blk(torch.from_numpy(outs[i + 1]), True)
            _close(y.numpy(), outs[i + 2], f"block {i}", BLOCK_TOL)
    assert outs[-1].shape[1:3] == (size // 32, size // 32)
    want = state_dict_from_flax(v["params"], jax.device_get(
        upd["batch_stats"]))
    got = model.state_dict()
    buffers = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert len(buffers) == 2 * 53
    for k in buffers:
        _close(got[k].numpy(), want[k].numpy(), k)
        assert not torch.equal(got[k], tm.state_dict()[k]), k


def test_bottleneck_gradients_on_batch_statistics_match_esvit_tpu():
    """One bottleneck with its downsample and stride (layer2.0's shape,
    narrower input) in batch-statistics mode: the output, the input's
    gradient and every parameter's within 1e-5 of esvit_tpu's."""
    from esvit_tpu.models.resnet import Bottleneck as JBottleneck
    from esvit_tpu_torch.models.resnet import Bottleneck as TBottleneck

    rng = np.random.default_rng(0)
    x = np.abs(rng.normal(size=(4, 16, 16, 256))).astype(np.float32)
    w_out = rng.normal(size=(4, 8, 8, 256)).astype(np.float32)
    jb = JBottleneck(64, strides=2, downsample=True)
    v = jax.device_get(jb.init(jax.random.PRNGKey(0), jnp.asarray(x), True))

    def f(params, x):
        y, _ = jb.apply({"params": params, "batch_stats": v["batch_stats"]},
                        x, True, mutable=["batch_stats"])
        return jnp.sum(y * w_out), y

    (_, jy), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    tb = TBottleneck(256, 64, 2, True)
    wrap = lambda tree: {"layer2_block0": tree}
    sd = state_dict_from_flax(wrap(v["params"]), wrap(v["batch_stats"]))
    tb.load_state_dict({k.removeprefix("layer2.0."): t for k, t in sd.items()})
    xt = torch.from_numpy(x).requires_grad_()
    y = tb(xt, True)
    (y * torch.from_numpy(w_out)).sum().backward()
    _close(y.detach().numpy(), np.asarray(jy), "output")
    _close(xt.grad.numpy(), np.asarray(gx), "d input")
    grads = state_dict_from_flax(wrap(jax.device_get(gp)))
    for name, p in tb.named_parameters():
        _close(p.grad.numpy(), grads[f"layer2.0.{name}"].numpy(), name)


def test_region_tokens_and_pooled_eval_feature():
    """170 region tokens per image at 224/96 (2*49 + 8*9), the mean of the
    grid as the cls feature, and the pooled feature as the probe's input
    whatever the block count."""
    model = TResNet(tcfg.ResNetConfig(depth=50),
                    generator=torch.Generator().manual_seed(0)).eval()
    tokens = 0
    with torch.no_grad():
        for size, views in ((224, 2), (96, 8)):
            x = torch.randn(1, size, size, 3)
            cls, reg = model.forward_features(x)
            tokens += views * reg.shape[1]
            torch.testing.assert_close(cls, reg.mean(dim=1))
            for n in (1, 4):
                torch.testing.assert_close(
                    model.forward_return_n_last_blocks(x, n), cls)
    assert tokens == 170
