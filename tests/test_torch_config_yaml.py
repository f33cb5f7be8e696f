"""The port's reference-YAML reader against esvit_tpu's.

Reference-format YACS YAMLs written into tmp_path, with ``BASE:``
includes (one level, two levels, a list), for the Swin, CvT and ViL
model names: both packages' configs hold the same value in every field
the port's dataclass has (esvit_tpu's has a few TPU-only knobs more).
"""

import dataclasses
import textwrap

import pytest

from esvit_tpu import config_yaml as jyaml
from esvit_tpu_torch import config_yaml as tyaml
from tests.torch_threads import one_intra_op_thread  # noqa: F401

FILES = {
    "swin_base.yaml": """
        MODEL:
          NAME: swin_transformer
          SPEC:
            DIM_EMBED: 96
            DEPTHS: [2, 2, 6, 2]
            NUM_HEADS: [3, 6, 12, 24]
        TRAIN:
          IMAGE_SIZE: [224, 224]
        """,
    "swin_w14.yaml": """
        BASE: ['swin_base.yaml']
        MODEL:
          SPEC:
            WINDOW_SIZE: 14
            DROP_PATH_RATE: 0.2
            USE_APE: True
        """,
    "swin_small_w14.yaml": """
        BASE: ['swin_w14.yaml']
        MODEL:
          SPEC:
            DEPTHS: [2, 2, 18, 2]
        TRAIN:
          IMAGE_SIZE: [192, 192]
        """,
    "cvt.yaml": """
        MODEL:
          NAME: cvt_v4_transformer
          SPEC:
            NUM_STAGES: 3
            PATCH_SIZE: [7, 3, 3]
            PATCH_STRIDE: [4, 2, 2]
            PATCH_PADDING: [2, 1, 1]
            DIM_EMBED: [64, 192, 384]
            DEPTH: [1, 2, 10]
            NUM_HEADS: [1, 3, 6]
            MLP_RATIO: 4.0
            QKV_BIAS: [True, True, True]
            DROP_PATH_RATE: 0.1
            WINDOW_SIZE: [7, 7, 7]
            SHIFT: [False, True, False]
        """,
    "vil_common.yaml": """
        MODEL:
          NAME: msvit
          SPEC:
            DROP: 0.0
            DROP_PATH: 0.1
        """,
    "vil_extra.yaml": """
        TRAIN:
          IMAGE_SIZE: [224, 224]
        """,
    "vil_tiny.yaml": """
        BASE: ['vil_common.yaml', 'vil_extra.yaml']
        MODEL:
          SPEC:
            MSVIT:
              ARCH: 'l1,h1,d48,n1,s1,g1,p4,f7,a0_l2,h3,d96,n2,s1,g1,p2,f7,a0_l3,h3,d192,n8,s0,g1,p2,f7,a0_l4,h6,d384,n1,s0,g0,p2,f7,a0'
              ATTN_TYPE: longformerhand
              LN_EPS: 1e-5
        """,
}


@pytest.fixture(scope="module")
def yaml_dir(tmp_path_factory):
    pytest.importorskip("yaml")
    root = tmp_path_factory.mktemp("yaml")
    for name, text in FILES.items():
        (root / name).write_text(textwrap.dedent(text))
    return root


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", ["swin_base.yaml", "swin_w14.yaml",
                                  "swin_small_w14.yaml", "cvt.yaml",
                                  "vil_tiny.yaml"])
def test_yaml_matches_jax(yaml_dir, name):
    got = _fields(tyaml.load_reference_yaml(str(yaml_dir / name)))
    want = _fields(jyaml.load_reference_yaml(str(yaml_dir / name)))
    assert got == {k: want[k] for k in got}


def test_base_chain_resolves(yaml_dir):
    cfg = tyaml.load_reference_yaml(str(yaml_dir / "swin_small_w14.yaml"))
    assert (cfg.depths, cfg.window_size, cfg.ape, cfg.img_size,
            cfg.embed_dim) == ((2, 2, 18, 2), 14, True, 192, 96)


def test_unknown_model_name():
    with pytest.raises(ValueError, match="unsupported MODEL.NAME"):
        tyaml.model_config_from_tree({"MODEL": {"NAME": "resnet"}})
