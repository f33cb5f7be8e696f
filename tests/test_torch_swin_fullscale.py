"""The port's Swin-T (swin_tiny, W=7) against esvit_tpu's at full size.

The reference's own full-size check (tests/test_parity_swin_fullscale.py)
needs the original torch EsViT; this one holds the port to esvit_tpu
instead. esvit_tpu's swin_tiny is initialised from a fixed key and carried
over by io/jax_params.py; batch 1, fp32. JAX runs its XLA route
(attention_impl='xla', fused_block_stages=()); the port runs each of its
routes on the CPU, where every kernel wrapper takes its plain version:
the plain route (attention_impl='xla', no fused stages), the
window-attention route ('packed', no fused stages), the qkv-layout route
('pallas', no fused stages) and the default route (stages 0-2 block-fused,
the 96 px stage 2 as the augmented window of 37 tokens). Full size covers
what femto sizes miss: the 13x13 bias tables, the real shift masks, stage
3's single window at 224 px and the 96 px sub-window and augmented
routes. Tolerance: 1e-4 absolute and relative (fp32 sums in another order
across 24 blocks; outputs up to ~4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.models.swin import SwinTransformer as JSwin
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import state_dict_from_flax
from esvit_tpu_torch.models.swin import SwinTransformer as TSwin

TOL = 1e-4
ROUTES = {
    "plain": dict(attention_impl="xla", fused_block_stages=()),
    "window_attention": dict(attention_impl="packed", fused_block_stages=()),
    "qkv_layout": dict(attention_impl="pallas", fused_block_stages=()),
    "default": {},
}


def _x(size):
    return np.random.default_rng(size).normal(
        size=(1, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    """esvit_tpu's params and outputs: forward_features at 224 and 96 px,
    forward_return_n_last_blocks(x, 4) at 224 px."""
    model = JSwin(jcfg.swin_tiny(attention_impl="xla", fused_block_stages=()))
    params = jax.jit(lambda r: model.init({"params": r}, jnp.asarray(_x(96))))(
        jax.random.PRNGKey(0))["params"]
    fwd = jax.jit(lambda p, x: model.apply({"params": p}, x))
    out = {str(size): fwd(params, jnp.asarray(_x(size)))
           for size in (224, 96)}
    out["n_last"] = jax.jit(lambda p, x: model.apply(
        {"params": p}, x, 4, method=model.forward_return_n_last_blocks))(
        params, jnp.asarray(_x(224)))
    sd = state_dict_from_flax(jax.tree.map(np.asarray, params))
    return sd, jax.tree.map(np.asarray, out)


def _port(sd, route):
    model = TSwin(tcfg.swin_tiny(**ROUTES[route]))
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("size", [224, 96])
def test_forward_features_matches_jax(reference, route, size):
    sd, ref = reference
    with torch.no_grad():
        cls, region = _port(sd, route).forward_features(
            torch.from_numpy(_x(size)))
    assert region.shape == (1, (size // 32) ** 2, 768)
    want_cls, want_region = ref[str(size)]
    np.testing.assert_allclose(region.numpy(), want_region, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(cls.numpy(), want_cls, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("route", ["plain", "default"])
def test_n_last_blocks_matches_jax(reference, route):
    sd, ref = reference
    with torch.no_grad():
        got = _port(sd, route).forward_return_n_last_blocks(
            torch.from_numpy(_x(224)), 4)
    # The last two blocks of stage 2 (384) and the two of stage 3 (768).
    assert got.shape == ref["n_last"].shape == (1, 2 * 384 + 2 * 768)
    np.testing.assert_allclose(got.numpy(), ref["n_last"], rtol=TOL, atol=TOL)
