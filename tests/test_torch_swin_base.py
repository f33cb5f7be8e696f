"""Swin-B in the port on the CPU: the widths of EsViT's best published model
(C 128 / 256 / 512 / 1024, 4-32 heads, head dim 32) at W=14.

- the Swin-B W=14 multi-crop step's derived launches (B=8, 2x224 +
  8x96), through the helpers chip_smoke.py holds the card's counts with:
  66 forward / 44 backward block-fused launches on the kernel route (46 /
  24 at N=196, 2 / 2 at N=145, 18 / 18 at N=37; 54 / 36 at C=512) and
  the packed pair's 4 / 2 at stage 3 (N=49); 50 / 26 packed launches on
  fused_block_stages=() (46 / 24 at N=196); none on the plain route;
- one Swin block at C=512, 16 heads, M=2048 on one window of 49 and one
  of 196 tokens: the port's block-fused function (fused_swin_block_plain,
  what the card's kernels compute) against esvit_tpu's SwinBlock on its
  XLA route, fp32: the output, dx and every parameter gradient within
  1e-4 (esvit_tpu's block-fused kernel in interpret mode takes ~12 s a
  case at this width on one worker, so the XLA block stands in for it;
  tests/test_torch_swin_w14.py holds the plain function to that kernel
  at N=196 and C=32);
- ``forward_features`` of Swin-B at its published widths with depths
  (2, 2, 2, 2), W=14, one image at 224 px and one at 96 px, on the port's
  default (fused) and packed routes against esvit_tpu's XLA route, fp32,
  1e-4; weights drawn at flax's shapes and carried over by
  io/jax_params.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from esvit_tpu import config as jcfg
from esvit_tpu.models.swin import SwinBlock as JBlock
from esvit_tpu.models.swin import SwinTransformer as JSwin
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import state_dict_from_flax
from esvit_tpu_torch.models import common as tcommon
from esvit_tpu_torch.models import swin as tswin
from esvit_tpu_torch.models.swin import SwinTransformer as TSwin
from esvit_tpu_torch.ops import fused_block as tfb
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-4
DEPTHS = (2, 2, 2, 2)


def _no_draw(t, std=0.02, generator=None):
    return t.zero_()


@pytest.fixture
def cheap_init(monkeypatch):
    """Builds models without drawing weights: the step's probes (the
    counts read the routes, which depend on shapes alone) and models whose
    weights are loaded next."""
    monkeypatch.setattr(tcommon, "trunc_normal_", _no_draw)
    monkeypatch.setattr(tswin, "trunc_normal_", _no_draw)


ROUTES = {
    "kernel": {},
    "packed": dict(fused_block_stages=()),
    "plain": dict(fused_block_stages=(), attention_impl="xla"),
}
# Per step: (block-fused, packed pair) launches, and the splits.
WANT = {
    "kernel": ({"fwd": 66, "bwd": 44}, {"fwd": 4, "bwd": 2}),
    "packed": ({"fwd": 0, "bwd": 0}, {"fwd": 50, "bwd": 26}),
    "plain": ({"fwd": 0, "bwd": 0}, {"fwd": 0, "bwd": 0}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_swin_b_w14_step_launches_as_derived(cheap_init, route):
    cfg = tcfg.swin_tiny_multicrop(8).replace(
        model=tcfg.swin_base(window_size=14, **ROUTES[route]))
    want = chip_smoke._derived_launches(cfg, 1)
    assert (want["fused_block"], want["window_attention"]) == WANT[route]
    assert want["pallas_window_attention"] == {"fwd": 0}
    assert want["sliding_chunk"] == {"fwd": 0, "bwd": 0}
    packed = chip_smoke._packed_n_split(cfg)
    if route == "kernel":
        assert chip_smoke._fused_n_split(cfg) == {
            "fwd": {196: 46, 145: 2, 37: 18},
            "bwd": {196: 24, 145: 2, 37: 18}}
        assert chip_smoke._fused_n_split(cfg, by="C") == {
            "fwd": {128: 6, 256: 6, 512: 54},
            "bwd": {128: 4, 256: 4, 512: 36}}
        assert packed == {"fwd": {49: 4}, "bwd": {49: 2}}
    elif route == "packed":
        assert packed == {"fwd": {196: 46, 49: 4}, "bwd": {196: 24, 49: 2}}
    else:
        assert packed == {"fwd": {}, "bwd": {}}


def _flax_draws(tree, seed, scale):
    """Seeded numpy values at a flax tree's shapes: LayerNorm scales near
    1, every other leaf a normal draw times ``scale`` (0.02 for biases and
    the relative-position tables)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "scale":
            return (1 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        s = scale if names[-1] == "kernel" else 0.02
        return (s * rng.normal(size=leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.mark.parametrize("ws", [7, 14])
def test_fused_block_plain_matches_jax_block_at_c512(ws):
    C, nH, N = 512, 16, ws * ws
    rng = np.random.default_rng(ws)
    x = (0.5 * rng.normal(size=(1, N, C))).astype(np.float32)
    dout = rng.normal(size=x.shape).astype(np.float32)
    block = JBlock(dim=C, num_heads=nH, window_size=ws, shift_size=0,
                   attention_impl="xla")
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(0),
                            jnp.zeros(x.shape))["params"]
    params = _flax_draws(shapes, ws, C ** -0.5)

    @jax.jit
    def f(p, x):
        # the block returns (output, attention probabilities or None)
        out, vjp = jax.vjp(lambda p, x: block.apply({"params": p}, x)[0],
                           p, x)
        return out, vjp(jnp.asarray(dout))

    j_out, (j_dp, j_dx) = f(params, jnp.asarray(x))

    tblock = tswin.SwinBlock(C, nH, ws, 0)
    tblock.load_state_dict(state_dict_from_flax(params), strict=True)
    xt = torch.tensor(x, requires_grad=True)
    out = tblock.fused(xt, tblock.attn.rel_bias(), N, 1, None, None, True,
                       None)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_dx), rtol=TOL,
                               atol=TOL)
    want = state_dict_from_flax(jax.tree.map(np.asarray, j_dp))
    got = dict(tblock.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        w = w.numpy()
        s = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(got[name].grad.numpy() / s, w / s,
                                   rtol=TOL, atol=TOL, err_msg=name)
    assert tfb.supports(N, C, nH, 4 * C)


@pytest.fixture(scope="module")
def swin_b():
    """esvit_tpu's Swin-B (W=14, depths 2-2-2-2) on its XLA route: seeded
    draws at flax's shapes, its jitted forward_features at 224 and 96 px."""
    model = JSwin(dataclasses.replace(
        jcfg.swin_base(window_size=14, attention_impl="xla",
                       fused_block_stages=()), depths=DEPTHS))
    x = {size: np.random.default_rng(size).normal(
        size=(1, size, size, 3)).astype(np.float32) for size in (224, 96)}
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 96, 96, 3)))["params"]
    params = _flax_draws(shapes, 0, 0.02)
    fwd = jax.jit(lambda p, x: model.apply({"params": p}, x))
    out = {size: jax.tree.map(np.asarray, fwd(params, jnp.asarray(v)))
           for size, v in x.items()}
    return state_dict_from_flax(params), x, out


@pytest.mark.parametrize("route", ["kernel", "packed"])
@pytest.mark.parametrize("size", [224, 96])
def test_swin_b_forward_features_matches_jax(monkeypatch, cheap_init, swin_b,
                                             route, size):
    """Stages 0-2 take the block-fused function (the kernel route: N=196,
    the 96 px augmented 145 and 37, C up to 512) or the packed pair's
    (N=196 at stages 0-2, the 96 px stage 0 padded); stage 3 (C=1024, 32
    heads) the packed pair at N=49 or, at 96 px, the plain sub-window
    path."""
    sd, x, ref = swin_b
    model = TSwin(dataclasses.replace(
        tcfg.swin_base(window_size=14, **ROUTES[route]), depths=DEPTHS))
    model.load_state_dict(sd, strict=True)
    fused = []
    real = tfb.fused_swin_block_plain

    def record(*a, **kw):
        fused.append((a[0].shape[-1], kw["N"]))
        return real(*a, **kw)
    monkeypatch.setattr(tfb, "fused_swin_block_plain", record)
    with torch.no_grad():
        cls, region = model.forward_features(torch.from_numpy(x[size]))
    want_cls, want_region = ref[size]
    assert region.shape == (1, (size // 32) ** 2, 1024)
    np.testing.assert_allclose(region.numpy(), want_region, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(cls.numpy(), want_cls, rtol=TOL, atol=TOL)
    assert len(fused) == model.fused_block_calls(size)
    if route == "kernel":
        assert fused == ([(128, 196)] * 2 + [(256, 196)] * 2
                         + [(512, 196)] * 2 if size == 224 else
                         [(128, 196)] * 2 + [(256, 145)] * 2
                         + [(512, 37)] * 2)
