"""Two multi-crop train steps of the port's other ViL attention types
against esvit_tpu's, fp32, through tests/test_torch_vil_steps.py's
``check_steps``: Performer (its projection carried in each net's
buffers, never moved by the teacher's EMA), Linformer and SRFormer.
Linformer runs on the global crops alone: its sequence length is fixed
at the native grid, and esvit_tpu cannot run it on the local crops
either.
"""

import pytest

from tests.test_torch_vil_steps import check_steps
from tests.torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("attn_type,local", [("performer", True),
                                             ("linformer", False),
                                             ("srformer", True)])
def test_attention_type_steps_match_jax(attn_type, local):
    check_steps(None, dict(attn_type=attn_type), 0, 0, local)
