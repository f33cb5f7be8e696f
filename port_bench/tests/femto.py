"""A femto cell for the CPU tests: the benchmark's own configuration and
traffic files with the widths cut to swin_femto's, a few images, and a
stochastic-depth rate high enough that the checked steps drop branches."""

from __future__ import annotations

import copy

from port_bench import spec

CONFIG, TRAFFIC = "swin_t_w7", "ddino.b32"
# Limits for the float32 program at this size: the reference and the
# port's plain route agree to rounding there (test_pb_reference.py).
FP32_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-3,
               "teacher_change_gap": 1e-2}


def cell(dtype: str = "float32", region_task: bool = True,
         chips: int = 1, limits: dict | None = None) -> spec.Cell:
    config = copy.deepcopy(spec.load_json(spec.HERE / "configs"
                                          / f"{CONFIG}.json"))
    config["model"].update(img_size=32, embed_dim=16, depths=[2, 2],
                           num_heads=[2, 2], window_size=4,
                           fused_block_stages=[0, 1], drop_path_rate=0.3)
    config["head"].update(out_dim=64, hidden_dim=32, bottleneck_dim=16)
    config["steps_per_epoch"] = 10
    config["compute_dtype"] = dtype
    traffic = copy.deepcopy(spec.load_json(spec.HERE / "traffic"
                                           / f"{TRAFFIC}.json"))
    # 32 px globals: stage 0 shifted over 2x2 windows; 24 px locals: a
    # padded stage 0 and one padded window (the augmented route) at 1.
    traffic.update(batch_per_card=4, global_size=32, local_size=24,
                   local_crops=2, region_task=region_task)
    bench = spec.benchmark()
    return spec.Cell(name="femto", chips=chips, config=config,
                     traffic=traffic,
                     limits=dict(FP32_LIMITS if limits is None else limits),
                     end_to_end=bench["end_to_end"],
                     per_layer=bench["per_layer"])
