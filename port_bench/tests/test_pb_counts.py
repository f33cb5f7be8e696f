"""The step's products count and the fused-block bound against counts by
hand at femto size."""

from __future__ import annotations

import math

import pytest

from port_bench import counts
from port_bench.tests import femto


def _backbone(m, S, n):
    """(products of the backbone's forward on n images of S px, of its
    patch embedding, its final tokens per image and width)."""
    p = m["patch_size"]
    H, C = S // p, m["embed_dim"]
    embed = 2 * n * H * H * 3 * p * p * C
    total = embed
    res0 = m["img_size"] // p
    for s, depth in enumerate(m["depths"]):
        ws = min(m["window_size"], res0 // 2 ** s)
        Tp = n * (math.ceil(H / ws) * ws) ** 2
        T, N = n * H * H, ws * ws
        block = (2 * Tp * C * 3 * C + 2 * 2 * Tp * N * C + 2 * Tp * C * C
                 + 2 * 2 * T * C * 4 * C)
        total += depth * block
        if s < len(m["depths"]) - 1:
            H = math.ceil(H / 2)
            total += 2 * n * H * H * 4 * C * 2 * C
            C *= 2
    return total, embed, H * H, C


def _hand_count(cell):
    m, h, tr = cell.config["model"], cell.config["head"], cell.traffic
    b = tr["batch_per_card"]
    g_views, l_views = tr["global_crops"], tr["local_crops"]
    fg, eg, ng, C = _backbone(m, tr["global_size"], g_views * b)
    fl, el, nl, _ = _backbone(m, tr["local_size"], l_views * b)
    row = 2 * (C * h["hidden_dim"] + h["hidden_dim"] ** 2
               + h["hidden_dim"] * h["bottleneck_dim"]
               + h["bottleneck_dim"] * h["out_dim"])
    heads = 1 + tr["region_task"]
    t_rows = g_views * b * (1 + tr["region_task"] * ng)
    s_rows = ((g_views + l_views) * b
              + tr["region_task"] * b * (g_views * ng + l_views * nl))
    teacher = fg + t_rows * row
    student = fg + fl + s_rows * row
    sim = 0
    if tr["region_task"]:
        views = [ng] * g_views + [nl] * l_views
        sim = sum(2 * b * n * ng * C for iq in range(g_views)
                  for v, n in enumerate(views) if v != iq)
    assert heads in (1, 2)
    # backward: both products of every student product but the patch
    # embedding's input gradient; the matching's similarity has none
    return teacher + student + sim + 2 * student - eg - el


@pytest.mark.parametrize("region_task", [True, False])
def test_step_flops_against_a_hand_count(region_task):
    cell = femto.cell(region_task=region_task)
    assert counts.step_flops(cell.config, cell.traffic) == \
        _hand_count(cell)


def test_fused_block_work_by_hand():
    """One stage, one block, globals only: a 28 px crop (7x7 tokens) at
    W=4 pads to 8x8, 4 windows of 16; C=16, two heads, MLP 64, float32
    rows."""
    cell = femto.cell()
    cell.config["model"].update(depths=[1], num_heads=[2],
                                fused_block_stages=[0], window_size=4,
                                img_size=32)
    tr = cell.traffic
    tr.update(global_size=28, local_crops=0, batch_per_card=1)
    T, C, F, N, nW = 2 * 64, 16, 64, 16, 4
    # two LayerNorms, q/k/v/proj with biases, the (2, N, N) bias, the MLP
    params = 4 * (4 * C + 4 * C * C + 4 * C + 2 * N * N + 2 * C * F + F + C)
    tables = 4 * nW * N                      # the pad mask (unshifted)
    fwd_f = 2 * T * (4 * C * C + 2 * C * F) + 4 * T * N * C
    want_bytes = 2 * (2 * T * C * 4 + params + tables) \
        + (3 * T * C * 4 + 2 * params + tables)
    # the teacher's and the student's forward, the student's backward:
    # two products of each forward product, no recompute
    want_flops = 2 * fwd_f + 2 * fwd_f
    nbytes, flops = counts.fused_block_work(cell.config, tr)
    assert (nbytes, flops) == (want_bytes, want_flops)
    assert counts.fused_block_bound_s(cell.config, tr) == max(
        want_bytes / counts.HBM_BYTES_PER_S,
        want_flops / counts.BF16_FLOP_PER_S)


def test_augmented_window_counts_one_window_of_the_real_tokens_and_one():
    """A 12 px crop at stage 0 (3x3 tokens, W=4): one padded window, the
    augmented route's 10 tokens, its pad table of 10."""
    cell = femto.cell()
    cell.config["model"].update(depths=[1], num_heads=[2],
                                fused_block_stages=[0])
    tr = cell.traffic
    tr.update(global_size=12, local_crops=0, batch_per_card=1)
    (call,) = list(counts._stage_calls(cell.config, tr))
    assert (call["N"], call["nW"], call["T"]) == (10, 1, 20)
    assert call["augmented"] and call["pad"] and not call["region"]
