"""The readings that the correctness limits of a cell are set from.

    python3 port_bench/calibrate.py --workload <cell> --first-seed <n> \\
        --seeds 12 --control-seeds 3 [--faults half_batch ...]

On the card, at the cell's own size, in one process (one a card where the
cell has several): for each of ``--seeds`` seeds the program's first
three steps against the reference's (the sound runs: the lower reading of
each number is their largest); for ``--control-seeds`` seeds the
control, the reference computed with float8 products
(reference/precision.py) put in the program's place, and each planted
fault of ``--faults`` (program.py ``plant``) against the reference (the
upper reading). Prints one JSON line a reading, and at the end each
number's largest sound reading and the smallest of the control and of
each fault. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench import check, inputs, run, spec  # noqa: E402
from port_bench.program import Program  # noqa: E402
from port_bench.reference import step as ref_step  # noqa: E402
from port_bench.reference.precision import FP8, no_tf32  # noqa: E402


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def program_side(cell, seed, device, group, fault=None):
    traffic = cell.traffic
    spec_ = ref_step.param_spec(cell.config, traffic["region_task"])
    prog = Program(cell.config, traffic, device)
    if fault is not None:
        prog.plant(fault)
    prog.load(inputs.make_weights(spec_, seed, device))
    batches = [inputs.make_crops(traffic, seed, i, group.rank, device)
               for i in range(run.CORRECTNESS_STEPS)]
    read = run.program_readings(prog, cell, batches, spec_, seed, device,
                                group.rank)
    prog.free()
    del prog, batches
    _free(device)
    return read


def reference_side(cell, seed, device, group, prec=None):
    spec_ = ref_step.param_spec(cell.config, cell.traffic["region_task"])
    read = run.reference_readings(cell.config, cell.traffic, spec_, seed,
                                  device, group, prec)
    _free(device)
    return read


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", nargs="*", default=[])
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    world = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print("calibrate needs the cell's cards", file=sys.stderr)
        return 2
    no_tf32()
    rank0 = "PORT_BENCH_RANK" not in os.environ
    children = (run.start_ranks(world, str(Path(__file__).resolve()), argv)
                if rank0 and world > 1 else [])
    group = run.init_group(world) if world > 1 else run.Group()
    device = torch.device("cuda", group.rank)
    readings = {"sound": [], "control": []}
    readings.update({f: [] for f in args.faults})

    def emit(kind, seed, values, t0):
        readings[kind].append(values)
        if group.rank == 0:
            print(json.dumps({"kind": kind, "seed": seed, **values,
                              "s": round(time.perf_counter() - t0, 2)}),
                  flush=True)

    for i in range(args.seeds):
        seed = args.first_seed + i
        t0 = time.perf_counter()
        prog = program_side(cell, seed, device, group)
        ref = reference_side(cell, seed, device, group)
        emit("sound", seed, check.numbers(prog, ref), t0)
        if i < args.control_seeds:
            t0 = time.perf_counter()
            ctl = reference_side(cell, seed, device, group, FP8)
            emit("control", seed, check.numbers(ctl, ref), t0)
            for fault in args.faults:
                t0 = time.perf_counter()
                bad = program_side(cell, seed, device, group, fault)
                emit(fault, seed, check.numbers(bad, ref), t0)
    if group.rank == 0:
        summary = {"lower": {n: max(r[n] for r in readings["sound"])
                             for n in check.NUMBERS}}
        for kind in ["control", *args.faults]:
            if readings[kind]:
                summary[kind] = {n: min(r[n] for r in readings[kind])
                                 for n in check.NUMBERS}
        print(json.dumps({"summary": summary}), flush=True)
    if world > 1:
        torch.distributed.destroy_process_group()
    for child in children:
        child.wait(timeout=300)
    return 0


if __name__ == "__main__":
    sys.exit(main())
