"""The port's other ViL attentions, relative position bias and the ViL
probe against esvit_tpu, on the CPU.

Same weights (esvit_tpu's init, carried by io/jax_params.py, the
Performer's projection from its ``performer`` collection) and the same
numpy inputs through both packages, fp32, tolerance 1e-5 on outputs and
gradients (JAX's by ``jax.grad``):
- the modules: Performer, Linformer (and its refusal of another sequence
  length), SRFormer, both SE layers, full attention with rpe (and its
  refusal of another grid);
- ``MsViT`` features for every ``attn_type`` and for ``a0`` stages, its
  ``forward_return_n_last_blocks``, the weight bridge's round trip
  through esvit_tpu's importer for each;
- the ViL linear probe's features against esvit_tpu's
  ``extract_probe_features``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.data import datasets as jdata
from esvit_tpu.evals import linear as jlinear
from esvit_tpu.io import torch_import
from esvit_tpu.models import vil_layers as jl
from esvit_tpu.models.vil import MsViT as JViL
from esvit_tpu.models.vil import ViLFullAttention as JFull
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.data import datasets as tdata
from esvit_tpu_torch.evals import linear as tlinear
from esvit_tpu_torch.io.jax_params import state_dict_from_flax
from esvit_tpu_torch.models import vil_layers as tl
from esvit_tpu_torch.models.vil import MsViT as TViL
from esvit_tpu_torch.models.vil import ViLFullAttention as TFull
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
DIM, HEADS = 16, 2


def _port_state(variables):
    v = jax.device_get(variables)
    return state_dict_from_flax(v["params"], performer=v.get("performer"))


def _check_module(jmod, tmod, x, call, jcall=None):
    """Output, input gradient and every parameter gradient of ``tmod``
    against ``jmod`` (init from PRNGKey(0) on x) under the same weights;
    ``call`` is the extra arguments after x."""
    jcall = call if jcall is None else jcall
    variables = jax.jit(lambda r: jmod.init(r, jnp.asarray(x), *jcall))(
        jax.random.PRNGKey(0))
    tmod.load_state_dict(_port_state(variables), strict=True)
    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(p, x):
        out = jmod.apply({"params": p, **rest}, x, *jcall)
        return jnp.sum(out * w), out

    (_, want), (g_p, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = tmod(xt, *call)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=TOL,
                               atol=TOL)
    want_g = state_dict_from_flax(jax.device_get(g_p))
    got_g = dict(tmod.named_parameters())
    assert set(want_g) == set(got_g)
    for name, g in want_g.items():
        np.testing.assert_allclose(got_g[name].grad.numpy(), g.numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)
    return variables


def _tokens(n, dim=DIM, seed=0):
    return np.random.default_rng(seed).normal(size=(2, n, dim)).astype(
        np.float32)


@pytest.mark.parametrize("nb_features", [4, 20])
def test_performer_matches_jax(nb_features):
    """With the bridged projection (one block and a partial second block
    of orthogonal rows at head dim 8); the buffer is the collection's."""
    tmod = tl.PerformerAttention(DIM, HEADS, nb_features=nb_features)
    v = _check_module(jl.PerformerAttention(DIM, HEADS,
                                            nb_features=nb_features),
                      tmod, _tokens(17), ())
    np.testing.assert_array_equal(
        tmod.fast_attention.projection_matrix.numpy(),
        np.asarray(v["performer"]["projection"]))
    assert "fast_attention.projection_matrix" in tmod.state_dict()


def test_performer_projection_law_and_redraw():
    """The port's own draw: (m, d), block rows orthogonal, row norms
    chi-distributed; a redraw replaces every net's buffer."""
    p = tl.orthogonal_gaussian(20, 8, torch.Generator().manual_seed(0))
    assert p.shape == (20, 8)
    unit = p / p.norm(dim=1, keepdim=True)
    torch.testing.assert_close(unit[:8] @ unit[:8].T, torch.eye(8),
                               rtol=0, atol=1e-5)
    model = TViL(tcfg.vil_femto(attn_type="performer"))
    before = model.state_dict()["layer1.1.attn.fast_attention.projection_matrix"].clone()
    tl.redraw_performer_projection(model, torch.Generator().manual_seed(5))
    after = model.state_dict()["layer1.1.attn.fast_attention.projection_matrix"]
    assert not torch.equal(before, after)


@pytest.mark.parametrize("share_kv", [False, True])
def test_linformer_matches_jax_and_refuses_other_lengths(share_kv):
    kw = dict(num_feats=8, num_heads=HEADS, share_kv=share_kv)
    jmod = jl.LinformerAttention(DIM, 17, **kw)
    tmod = tl.LinformerAttention(DIM, 17, **kw)
    v = _check_module(jmod, tmod, _tokens(17), ())
    with pytest.raises(AssertionError, match="seq_len=17"):
        jmod.apply(v, jnp.asarray(_tokens(10)))
    with pytest.raises(ValueError, match="seq_len=17"):
        tmod(torch.from_numpy(_tokens(10)))


@pytest.mark.parametrize("nx,ny,nglo", [(4, 4, 1), (5, 6, 0)])
def test_srformer_matches_jax(nx, ny, nglo):
    _check_module(jl.SRAttention(DIM, rratio=2, num_heads=HEADS),
                  tl.SRAttention(DIM, rratio=2, num_heads=HEADS),
                  _tokens(nglo + nx * ny), (nx, ny))


def test_se_seq_matches_jax():
    _check_module(jl.SELayerSeq(32), tl.SELayerSeq(32), _tokens(9, 32), ())


def test_se_eca_matches_jax():
    _check_module(jl.SELayerECA(32), tl.SELayerECA(32), _tokens(9, 32), ())


@pytest.mark.parametrize("nglo", [1, 0])
def test_full_attention_rpe_matches_jax(nglo):
    kw = dict(rpe=True, wx=3, wy=4, nglo=nglo)
    jmod = JFull(DIM, HEADS, **kw)
    tmod = TFull(DIM, HEADS, **kw)
    v = _check_module(jmod, tmod, _tokens(nglo + 12), (3, 4))
    with pytest.raises(AssertionError, match="native grid"):
        jmod.apply(v, jnp.asarray(_tokens(nglo + 9)), 3, 3)
    with pytest.raises(ValueError, match="native grid"):
        tmod(torch.from_numpy(_tokens(nglo + 9)), 3, 3)


# --- the backbone --------------------------------------------------------

FEMTO_A0 = "l1,h2,d16,n1,s1,g1,p4,f2,a0_l2,h2,d32,n1,s0,g1,p2,f2,a0"
TWO_DEEP = "l1,h2,d16,n2,s1,g1,p4,f2_l2,h2,d32,n2,s0,g0,p2,f2"
MODELS = {
    "performer": ("femto", dict(attn_type="performer")),
    "linformer": ("femto", dict(attn_type="linformer")),
    "srformer": ("femto", dict(attn_type="srformer")),
    "longformer a0": (FEMTO_A0, {}),
    "longformerhand two deep": (TWO_DEEP, dict(attn_type="longformerhand")),
}


def _cfg(pkg, name, **extra):
    arch, kw = MODELS[name]
    kw = {**kw, **extra}
    if arch == "femto":
        return pkg.vil_femto(**kw)
    return pkg.vil_from_arch(arch, img_size=32, **kw)


@pytest.fixture(scope="module")
def models():
    x = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    out = {}
    for name in MODELS:
        jmodel = JViL(_cfg(jcfg, name, fused_sc="off"))
        v = jax.jit(lambda r: jmodel.init(r, jnp.asarray(x)))(
            jax.random.PRNGKey(0))
        port = TViL(_cfg(tcfg, name))
        port.load_state_dict(_port_state(v), strict=True)
        out[name] = (jmodel, v, port)
    return x, out


@pytest.mark.parametrize("name", list(MODELS))
def test_features_match_jax(models, name):
    x, nets = models
    jmodel, v, port = nets[name]
    want = jax.jit(jmodel.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = port.forward_features(torch.from_numpy(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("name,n", [("longformer a0", 2),
                                    ("longformerhand two deep", 3),
                                    ("performer", 1)])
def test_n_last_blocks_match_jax(models, name, n):
    """Token means of the last n blocks; the final norm on the last
    stage's blocks only."""
    x, nets = models
    jmodel, v, port = nets[name]
    want = jax.jit(lambda v, x: jmodel.apply(
        v, x, n, method=jmodel.forward_return_n_last_blocks))(
        v, jnp.asarray(x))
    with torch.no_grad():
        got = port.forward_return_n_last_blocks(torch.from_numpy(x), n)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_state_dict_round_trip(models, name):
    """The port's state_dict (reference names) -> esvit_tpu's importer ->
    the same flax params; a Performer's buffers equal the collection."""
    _, nets = models
    _, v, port = nets[name]
    sd = port.state_dict()
    back = torch_import.import_esvit_model(
        {k: t.numpy() for k, t in sd.items()}, "vil")["params"]["backbone"]
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.device_get(v["params"]))
    buffers = {k for k in sd if k.endswith("projection_matrix")}
    if name == "performer":
        want = jax.device_get(v["performer"])
        assert buffers == {"layer1.1.attn.fast_attention.projection_matrix"}
        np.testing.assert_array_equal(
            sd["layer1.1.attn.fast_attention.projection_matrix"].numpy(),
            want["stage0_attn0"]["attn"]["projection"])
    else:
        assert not buffers
    if name == "longformer a0":
        assert "layer1.1.attn.local_relative_position_bias_table" in sd
        assert "layer2.1.attn.g2g_relative_position_bias" in sd
        assert not any("pos_embed" in k for k in sd)


def test_vil_probe_features_match_jax():
    """Centre-crop n-last-blocks features of a ViL backbone."""
    cfg = dict(img_size=32)
    jmodel = JViL(jcfg.vil_femto(fused_sc="off", **cfg))
    v = jax.jit(lambda r: jmodel.init(r, jnp.zeros((1, 32, 32, 3))))(
        jax.random.PRNGKey(0))
    port = TViL(tcfg.vil_femto(**cfg))
    port.load_state_dict(_port_state(v), strict=True)
    j_f, j_l = jlinear.extract_probe_features(
        jmodel, v, jdata.SyntheticImages(n=8, size=48, num_classes=3,
                                         seed=1),
        n_last_blocks=2, batch_size=8, size=32)
    t_f, t_l = tlinear.extract_probe_features(
        port, tdata.SyntheticImages(n=8, size=48, num_classes=3, seed=1),
        n_last_blocks=2, batch_size=8, size=32, device="cpu")
    assert t_f.shape == (8, tlinear.feature_dim_for(tcfg.vil_femto(), 2))
    np.testing.assert_array_equal(t_l, j_l)
    np.testing.assert_allclose(t_f, j_f, rtol=TOL, atol=TOL)
