"""The port's FLOP count, full-model .pth import and lazy imports.

- ``utils/flops.py`` on a femto Swin at 32 px: the count of the plain
  route's products equals a hand count of 2*M*N*K over them, and is at
  most XLA's ``forward_cost`` of esvit_tpu's forward (XLA counts the
  elementwise work too: the products are 0.668 of its count here); the
  parameter counts agree.
- ``load_esvit_checkpoint``: a femto EsViTModel state with the
  ``module.`` prefix and the static buffers a released checkpoint holds,
  through esvit_tpu's ``import_esvit_model`` + flax apply and through the
  port's loader: the head and dense-head logits within 1e-4 relative (as
  the Swin parity tests); without the dense head the file's
  ``head_dense`` is left out. ``verify_state_matches`` names the same
  missing, unexpected and reshaped entries as ``verify_tree_matches``.
- Every module of the package imports with ``yaml`` and ``matplotlib``
  unavailable.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvit_tpu import config as jcfg
from esvit_tpu.io import torch_import
from esvit_tpu.models.esvit import EsViTModel as JEsViT
from esvit_tpu.models.registry import build_backbone as jbuild
from esvit_tpu.utils import flops as jflops
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch.io.jax_params import state_dict_from_flax
from esvit_tpu_torch.io.torch_checkpoint import (load_esvit_checkpoint,
                                                 verify_state_matches)
from esvit_tpu_torch.models.esvit import EsViTModel as TEsViT
from esvit_tpu_torch.models.registry import build_backbone as tbuild
from esvit_tpu_torch.utils import flops as tflops
from tests.test_torch_aux_attention import _variables
from tests.torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAD = dict(out_dim=32, hidden_dim=16, bottleneck_dim=8)
TOL = 1e-4


def _femto_gemm_flops() -> int:
    """2*M*N*K over swin_femto's products at 32 px, batch 1: the 4x4 patch
    conv (64 tokens, 48 -> 16), per block qkv, q k^T and p v over windows
    of 16 tokens, proj, fc1 and fc2 (stage 0: 64 tokens of 16; stage 1: 16
    of 32), the patch merging's reduction (16 tokens, 64 -> 32)."""
    f = 2 * 64 * 48 * 16
    for L, C, N in ((64, 16, 16), (16, 32, 16)):
        f += 2 * (2 * L * C * 3 * C + 2 * 2 * L * N * C + 2 * L * C * C
                  + 2 * 2 * L * C * 4 * C)
    return f + 2 * 16 * 64 * 32


def test_forward_cost_counts_the_products():
    port = tbuild(tcfg.swin_femto())
    got = tflops.forward_cost(port, (1, 32, 32, 3))
    assert got["flops"] == _femto_gemm_flops()
    assert got["bytes_accessed"] is None
    jb = jbuild(jcfg.swin_femto(attention_impl="xla", fused_block_stages=()))
    v = _variables(jb, np.zeros((1, 32, 32, 3), np.float32), std=0.02,
                   deterministic=True)
    want = jflops.forward_cost(jb, v, (1, 32, 32, 3))
    assert got["params"] == want["params"] == tflops.param_count(port)
    assert got["flops"] <= want["flops"]
    assert 0.6 < got["flops"] / want["flops"] < 0.7


def test_summarize():
    s = tflops.summarize(tbuild(tcfg.swin_femto()), image_size=32)
    assert s == (f"params: {35416 / 1e6:.2f}M  fwd GFLOPs@32: "
                 f"{_femto_gemm_flops() / 1e9:.2f}  bytes: not counted")


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """A femto EsViTModel's flax params and a released-layout .pth of them
    ('module.' prefix, index and mask buffers, step counts)."""
    crops = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    jm = JEsViT(jcfg.swin_femto(attention_impl="xla", fused_block_stages=(),
                                drop_path_rate=0.0),
                jcfg.HeadConfig(**HEAD), use_dense_prediction=True)
    params = _variables(jm, (crops,), std=0.05)["params"]
    sd = {f"module.{k}": v for k, v in state_dict_from_flax(params).items()}
    sd["module.layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(
        16, 16, dtype=torch.long)
    sd["module.layers.0.blocks.1.attn_mask"] = torch.zeros(4, 16, 16)
    path = tmp_path_factory.mktemp("released") / "checkpoint.pth"
    torch.save({"teacher": sd, "student": sd, "epoch": 1}, path)
    return jm, str(path), crops


def test_load_esvit_checkpoint_matches_import(released):
    jm, path, crops = released
    jsd = torch_import.load_torch_checkpoint(path)
    variables = jax.tree.map(jnp.asarray, torch_import.import_esvit_model(
        jsd, "swin"))
    want = jax.jit(jm.apply)(variables, (jnp.asarray(crops),))
    port = TEsViT(tcfg.swin_femto(drop_path_rate=0.0),
                  tcfg.HeadConfig(**HEAD), use_dense_prediction=True)
    load_esvit_checkpoint(port, path)
    with torch.no_grad():
        got = port((torch.from_numpy(crops),))
    for i in (0, 1):                         # cls and region logits
        w = np.asarray(want[i])
        np.testing.assert_allclose(got[i].numpy() / np.abs(w).max(),
                                   w / np.abs(w).max(), rtol=0, atol=TOL)


def test_load_esvit_checkpoint_without_dense_head(released):
    _, path, _ = released
    port = TEsViT(tcfg.swin_femto(), tcfg.HeadConfig(**HEAD),
                  use_dense_prediction=False)
    load_esvit_checkpoint(port, path, key="student",
                          use_dense_prediction=False)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_esvit_checkpoint(port, path)


def test_verify_state_matches_names_what_verify_tree_matches_does():
    model = TEsViT(tcfg.swin_femto(), tcfg.HeadConfig(**HEAD),
                   use_dense_prediction=False)
    ref = model.state_dict()
    assert verify_state_matches(ref, ref) == []
    bad = dict(ref)
    del bad["norm.weight"]
    bad["extra.weight"] = torch.zeros(3)
    bad["head.mlp.0.bias"] = torch.zeros(5)
    got = verify_state_matches(bad, ref)
    assert got == ["norm.weight: missing from import",
                   "extra.weight: unexpected in import",
                   "head.mlp.0.bias: shape (5,) != expected (16,)"]
    jref = {"norm": {"weight": np.zeros(2)}, "head": {"b": np.zeros(16)}}
    jbad = {"extra": {"weight": np.zeros(3)}, "head": {"b": np.zeros(5)}}
    kinds = [line.split(": ", 1)[1].split(" (")[0] for line in
             torch_import.verify_tree_matches(jbad, jref)]
    assert sorted(kinds) == sorted(line.split(": ", 1)[1].split(" (")[0]
                                   for line in got)


def test_modules_import_without_yaml_and_matplotlib():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import esvit_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    esvit_tpu_torch.__path__, 'esvit_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'esvit_tpu_torch.analysis.cli' in names\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'esvit_tpu.'))\n"
        "               for m in sys.modules)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 50
