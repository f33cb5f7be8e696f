"""The port's ViL sliding-chunk attention against esvit_tpu's for the
options beside the neighbour mode, on the CPU: ``exact`` +-1, relative
position bias (the local table, ``g2l`` / ``g2g``, with and without global
tokens, at sampled modes), pooled keys ('mean' / 'fc', with and without
rpe and its cross-window table), ``only_glo`` and ``share_w``. Output,
input gradient and every parameter gradient from the same weights, fp32,
1e-5, as tests/test_torch_vil_modes.py checks the modes. Only ``share_w``
keeps the kernel route: every other option is one that
ops/sliding_chunk.py ``supports`` refuses.
"""

import pytest

from tests.test_torch_vil_modes import check_attention
from tests.torch_threads import one_intra_op_thread  # noqa: F401

CASES = {
    "exact -1": (dict(exact=-1), 0),
    "exact -1 mode 3": (dict(exact=-1), 3),
    "exact 1": (dict(exact=1), 0),
    "rpe": (dict(rpe=True), 0),
    "rpe mode 6": (dict(rpe=True), 6),
    "rpe mode -1": (dict(rpe=True), -1),
    "rpe nglo 0 mode 2": (dict(rpe=True, nglo=0), 2),
    "pooled mean": (dict(add_pooled=True, pool_method="mean"), 0),
    "pooled fc": (dict(add_pooled=True, pool_method="fc"), 0),
    "pooled mean rpe": (dict(add_pooled=True, pool_method="mean", rpe=True),
                        0),
    "pooled fc rpe mode 4": (dict(add_pooled=True, pool_method="fc",
                                  rpe=True), 4),
    "only_glo": (dict(only_glo=True, nglo=2), 0),
    "share_w": (dict(share_w=True), 0),
    "share_w rpe nglo 2": (dict(share_w=True, rpe=True, nglo=2), 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_attention_option_matches_jax(case):
    kw, mode = CASES[case]
    check_attention(kw, mode, kernel=case == "share_w")
