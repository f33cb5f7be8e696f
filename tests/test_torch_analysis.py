"""The port's analysis tools and their CLI against esvit_tpu's.

Attention maps of a femto Swin (32 px, W=4) and of a narrow two-block
DeiT (64 px) on the same weights (drawn with numpy at flax's shapes,
carried over by io/jax_params.py): the last block's and every block's, fp32, 1e-5
relative to the largest probability. The numpy helpers (entropy, head
order, threshold masks, region matching) against esvit_tpu's on the
same arrays; the flip protocol on a flip-equivariant stand-in backbone.
The CLI: one reference-layout .pth written from the port's femto Swin,
both packages' ``measure_entropy`` and ``measure_correspondence`` on one
folder of PNGs, their log.txt records within 1e-4; the ``vis_*``
commands write their PNGs. esvit_tpu's backbones run their ``apply``
under ``jax.jit`` (``_JitApply``, one program per module and call, shared
by the CLI's own backbone): the same computation, compiled once where it
would otherwise run op by op.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch import nn

from esvit_tpu import config as jcfg
from esvit_tpu.analysis import attention as jattn
from esvit_tpu.analysis import cli as jcli
from esvit_tpu.analysis import correspondence as jcorr
from esvit_tpu.models.registry import build_backbone as jbuild
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.analysis import attention as tattn
from esvit_tpu_torch.analysis import cli as tcli
from esvit_tpu_torch.analysis import correspondence as tcorr
from esvit_tpu_torch.io.jax_params import state_dict_from_flax
from esvit_tpu_torch.models.registry import build_backbone as tbuild
from tests.test_torch_aux_attention import _variables
from tests.torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
CLI_TOL = 1e-4
MODELS = {
    "swin_femto": (lambda pkg: pkg.swin_femto(), 32),
    "deit_tiny": (lambda pkg: pkg.ViTConfig(**{
        **vars(pkg.deit_tiny()), "depth": 2, "embed_dim": 48,
        "img_size": 64}), 64),
}


_PROGRAMS = {}


class _JitApply:
    """An esvit_tpu backbone whose ``apply`` runs under ``jax.jit``: one
    program per (module, method, static arguments), kept in ``_PROGRAMS``
    so equal modules (the CLI builds its own) share it."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return getattr(self._module, name)

    def apply(self, variables, x, *args, method=None, **kw):
        m = self._module
        key = (m, getattr(method, "__name__", None), args,
               tuple(sorted(kw.items())))
        if key not in _PROGRAMS:
            _PROGRAMS[key] = jax.jit(lambda v, a: m.apply(
                v, a, *args, method=method, **kw))
        return _PROGRAMS[key](variables, x)


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """(name, JAX backbone, its variables, the port's, a numpy batch)."""
    make, size = MODELS[request.param]
    jb = _JitApply(jbuild(make(jcfg)))
    # 6 images: the CLI's batch, so the CLI's forwards find their
    # programs compiled.
    x = np.random.default_rng(1).normal(size=(6, size, size, 3)).astype(
        np.float32)
    v = _variables(jb._module, x, std=0.05, deterministic=True)
    tb = tbuild(make(tcfg))
    tb.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, v["params"])), strict=True)
    return request.param, jb, v, tb, x


def _scaled_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("n", [1, 2])
def test_attention_maps(pair, n):
    _, jb, v, tb, x = pair
    want = jattn.attention_maps(jb, v, jnp.asarray(x), n)
    got = tattn.attention_maps(tb, torch.from_numpy(x), n=n)
    if n == 1:
        want, got = [want], [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _scaled_close(g.numpy(), w, TOL)


@pytest.mark.parametrize("what", ["entropy", "order", "threshold", "match"])
def test_numpy_helpers(what):
    rng = np.random.default_rng(3)
    a = rng.dirichlet(np.ones(9), size=(2, 3, 9))           # (B, nH, N, N)
    if what == "entropy":
        np.testing.assert_array_equal(tattn.attention_entropy(a),
                                      jattn.attention_entropy(a))
    elif what == "order":
        np.testing.assert_array_equal(tattn.head_entropy_order(a),
                                      jattn.head_entropy_order(a))
    elif what == "threshold":
        for mass in (0.3, 0.6, 0.95):
            np.testing.assert_array_equal(
                tattn.threshold_mask(a[0, 0, 0], mass),
                jattn.threshold_mask(a[0, 0, 0], mass))
    else:
        fa, fb = rng.normal(size=(2, 16, 8)).astype(np.float32)
        for g, w in zip(tcorr.match_regions(fa, fb),
                        jcorr.match_regions(fa, fb)):
            np.testing.assert_array_equal(g, w)


class _PatchMeans(nn.Module):
    """Region features = patch mean colours over a 4x4 grid: exactly
    flip-equivariant."""

    def __init__(self):
        super().__init__()
        self.unused = nn.Parameter(torch.zeros(1))

    def forward_features(self, x):
        B, H, W, C = x.shape
        fea = x.reshape(B, 4, H // 4, 4, W // 4, C).mean(dim=(2, 4))
        return None, fea.reshape(B, 16, C)


def test_flip_protocol():
    imgs = np.random.default_rng(2).uniform(size=(2, 16, 16, 3)).astype(
        np.float32)
    assert tcorr.correspondence_accuracy(_PatchMeans(), imgs) == (100.0, 0.0)


def test_correspondence_accuracy_matches_jax(pair):
    _, jb, v, tb, x = pair
    want = jcorr.correspondence_accuracy(jb, v, x)
    got = tcorr.correspondence_accuracy(tb, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=CLI_TOL)


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """A folder of 6 PNGs in two classes and a reference-layout .pth of a
    seeded femto Swin ('module.' prefix, a head)."""
    root = tmp_path_factory.mktemp("analysis")
    rng = np.random.default_rng(0)
    for i in range(6):
        d = root / "imgs" / f"class{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
                        ).save(d / f"{i}.png")
    model = tbuild(tcfg.swin_femto(), generator=torch.Generator().manual_seed(5))
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    sd["module.head.mlp.0.weight"] = torch.zeros(8, 32)
    path = root / "checkpoint.pth"
    torch.save({"teacher": sd, "student": sd}, path)
    return str(root), str(root / "imgs"), str(path)


def _cli_args(command, data, ckpt, out):
    return [command, "--arch", "swin_femto", "--window_size", "4",
            "--pretrained", ckpt, "--data_path", data, "--image_size", "32",
            "--num_images", "6", "--output_dir", out]


@pytest.mark.parametrize("command", ["measure_entropy",
                                     "measure_correspondence"])
def test_cli_records_match_jax(cli_inputs, command, monkeypatch):
    root, data, ckpt = cli_inputs
    monkeypatch.setattr(jcli, "build_backbone",
                        lambda cfg: _JitApply(jbuild(cfg)))
    records = []
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        out = f"{root}/{command}_{name}"
        main(_cli_args(command, data, ckpt, out) + extra)
        with open(f"{out}/log.txt") as f:
            records.append(json.loads(f.read().splitlines()[-1]))
    want, got = records
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=CLI_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("command,stem", [("vis_attention", "attn"),
                                          ("vis_correspondence", "corr")])
def test_cli_plots(cli_inputs, command, stem, tmp_path):
    pytest.importorskip("matplotlib")
    _, data, ckpt = cli_inputs
    tcli.main(_cli_args(command, data, ckpt, str(tmp_path)) +
              ["--num_images", "2", "--device", "cpu"])
    for i in range(2):
        assert (tmp_path / f"{stem}_{i}.png").stat().st_size > 0
