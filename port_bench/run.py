"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (BENCHMARK.json) names a configuration, a traffic mix and its
cards. Set-up builds the program's ``EsViTTrainer`` and ``TrainState`` on
the card, loads weights made from the seed, makes ``DISTINCT_BATCHES``
batches of crops from the seed, runs the first three steps (the ones the
check compares with the reference; their stochastic depth from the seed
too), then ``WARMUP_STEPS`` more. The window then calls ``train_step`` as
``train()`` does, reading each step's loss on the host before the next
step starts, for ``--seconds``. With ``--trace 1`` the same window runs,
then torch.profiler warms up over ``TRACE_WARMUP`` steps and records
``TRACE_STEPS``, and the per-layer metrics are read. Last, with the
program freed, the reference repeats the first three steps in float32 (in
blocks of ``REFERENCE_CHUNK`` images) and the check decides ``correct``.
The last line of standard output is the result; the numbers compared,
each with its limit, are the last lines of standard error.

A cell on more than one card starts a process a card, data-parallel over
NCCL; this process is rank 0 and prints the result. The ranks agree on
the window's end every ``STOP_EVERY`` steps. It exits non-zero without a result where the cards are missing,
a step fails, or jax, jaxlib, flax, optax, orbax or esvit_tpu was
imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Caches at fixed paths inside the checkout: a run after the first builds
# nothing. (The port builds its kernels into esvit_tpu_torch/_build/.)
CACHE = ROOT / "port_bench" / "_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

import torch  # noqa: E402

from port_bench import check, inputs, spec  # noqa: E402
from port_bench import trace as trace_lib  # noqa: E402
from port_bench.program import Program  # noqa: E402
from port_bench.reference import step as ref_step  # noqa: E402
from port_bench.reference.precision import no_tf32  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "esvit_tpu")
CORRECTNESS_STEPS = 3
DISTINCT_BATCHES = 4    # batches of crops cycled: no step reuses its input
WARMUP_STEPS = 2        # after the checked steps, before the window
TRACE_WARMUP = 2        # profiled steps left out of the trace
TRACE_STEPS = 6         # profiled steps read
REFERENCE_CHUNK = 8     # images a block of the reference's step
STOP_EVERY = 8          # steps between the ranks' agreements to stop
GIB = 2 ** 30


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:8.2f}s] {msg}", file=sys.stderr,
          flush=True)


def banned_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not
    load, compared whole (esvit_tpu_torch is not esvit_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def p90(values: list[float]) -> float:
    """The 90th percentile, as statistics.quantiles cuts ten groups."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10)[8]


@dataclass
class Group:
    """This process's place among the run's processes."""

    rank: int = 0
    world: int = 1
    host: object = None             # a gloo group for host-side exchange

    def all_reduce_sum(self, tensors: list[torch.Tensor]) -> None:
        import torch.distributed as dist

        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat)
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    def any(self, flag: bool) -> bool:
        if self.world == 1:
            return flag
        import torch.distributed as dist

        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host)
        return bool(t.item())

    def gather(self, obj) -> list:
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host)
        return out

    def barrier(self) -> None:
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier(group=self.host)


@dataclass
class Readings:
    """What the per-layer readers (metrics/*.py) read."""

    config: dict
    traffic: dict
    window_s: float
    step_s: list[float]
    enqueue_s: list[float]
    trace: trace_lib.Trace | None = None

    @property
    def window_steps(self) -> int:
        return len(self.step_s)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_readings(prog: Program, cell: spec.Cell, batches, spec_, seed,
                     device, rank: int = 0) -> dict:
    """The first three steps: their losses, the first gradient as AdamW
    got it, and each leaf's change over the three."""
    losses, grad = [], None
    for i in range(CORRECTNESS_STEPS):
        draws = inputs.make_drop_draws(cell.config, cell.traffic, seed, i,
                                       rank, device)
        losses.append(float(prog.step(batches[i % len(batches)], draws)))
        if i == 0:
            grad = prog.first_grad_norms()
    change = prog.change_norms(inputs.make_weights(spec_, seed, device))
    return {"losses": losses, "grad": grad, "change": change}


def reference_readings(config, traffic, spec_, seed, device, group: Group,
                       prec=None) -> dict:
    """The reference's first three steps on the same weights and crops,
    over the global batch (each process its own images)."""
    kw = {} if prec is None else {"prec": prec}
    b = traffic["batch_per_card"]
    start_step = traffic["start_epoch"] * config["steps_per_epoch"]
    ref = ref_step.ReferenceTrainer(
        config, traffic["region_task"],
        inputs.make_weights(spec_, seed, device), traffic["lr_total_batch"],
        start_step, device, **kw)
    losses, grad = [], None
    for i in range(CORRECTNESS_STEPS):
        crops = inputs.make_crops(traffic, seed, i % DISTINCT_BATCHES,
                                  group.rank, device)
        draws = inputs.make_drop_draws(config, traffic, seed, i, group.rank,
                                       device)
        out = ref.step(crops, b, REFERENCE_CHUNK, total_b=b * group.world,
                       all_reduce=(group.all_reduce_sum if group.world > 1
                                   else None), draws=draws)
        losses.append(out["loss"])
        if i == 0:
            grad = out["grad_norms"]
        del crops, draws
    start = inputs.make_weights(spec_, seed, device)
    change = {}
    with torch.no_grad():
        for key, net in (("student", ref.student), ("teacher", ref.teacher)):
            change[key] = {n: float(torch.linalg.vector_norm(p - start[n]))
                           for n, p in net.named_parameters()}
    return {"losses": losses, "grad": grad, "change": change}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, group: Group | None = None, fault: str | None = None
             ) -> dict:
    """One run of ``cell`` on this process's device; returns the result
    (every process) before the import check."""
    group = group or Group()
    device = torch.device(device)
    cuda = device.type == "cuda"
    log(f"rank {group.rank} of {group.world}: imports done")
    config, traffic = cell.config, cell.traffic
    spec_ = ref_step.param_spec(config, traffic["region_task"])

    prog = Program(config, traffic, device)
    if fault is not None:
        prog.plant(fault)
    prog.load(inputs.make_weights(spec_, seed, device))
    n = DISTINCT_BATCHES
    batches = [inputs.make_crops(traffic, seed, i, group.rank, device)
               for i in range(n)]
    log("program built; the first three steps")
    prog_read = program_readings(prog, cell, batches, spec_, seed, device,
                                 group.rank)
    k = CORRECTNESS_STEPS
    for _ in range(WARMUP_STEPS):
        float(prog.step(batches[k % n]))
        k += 1
    _sync(device)
    group.barrier()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")

    step_s, enqueue_s, failed = [], [], 0
    stop_every = 1 if group.world == 1 else STOP_EVERY
    w0 = last = time.perf_counter()
    while True:
        with torch.profiler.record_function(trace_lib.STEP_SPAN):
            a = time.perf_counter()
            with torch.profiler.record_function("port_bench/enqueue"):
                loss = prog.step(batches[k % n])
            e = time.perf_counter()
            with torch.profiler.record_function("port_bench/loss_read"):
                value = float(loss)
        t = time.perf_counter()
        k += 1
        step_s.append(t - last)
        enqueue_s.append(e - a)
        last = t
        failed += not math.isfinite(value)
        if (len(step_s) % stop_every == 0
                and group.any(t - w0 >= seconds)):
            break
    window_s = last - w0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    q = statistics.quantiles(step_s, n=10) if len(step_s) > 1 else step_s * 9
    log(f"window: {len(step_s)} steps in {window_s:.3f} s; step ms p10 "
        f"{q[0] * 1e3:.1f} p50 {q[4] * 1e3:.1f} p90 {q[8] * 1e3:.1f} max "
        f"{max(step_s) * 1e3:.1f}; enqueue ms p50 "
        f"{statistics.median(enqueue_s) * 1e3:.1f}")

    readings = Readings(config, traffic, window_s, step_s, enqueue_s)
    if trace:
        def traced_step():
            nonlocal k
            with torch.profiler.record_function(trace_lib.STEP_SPAN):
                float(prog.step(batches[k % n]))
            k += 1

        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        readings.trace = trace_lib.record(traced_step, TRACE_WARMUP,
                                          TRACE_STEPS, acts)
        log(f"traced {len(readings.trace.steps)} steps")

    prog.free()
    del prog, batches, loss
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    per_layer = {}
    if trace:
        for m in cell.per_layer:
            got = spec.reader(m["name"])(readings)
            if got is not None:
                per_layer[m["name"]] = (float(got), m["unit"])

    log("reference: the first three steps in float32")
    ref_read = reference_readings(config, traffic, spec_, seed, device,
                                  group)
    values = check.numbers(prog_read, ref_read)
    correct, checks = check.judge(values, cell.limits)
    out = {
        "correct": correct, "attempted": len(step_s), "failed": failed,
        "setup_s": setup_s, "window_s": window_s, "step_s": step_s,
        "peak": peak, "per_layer": per_layer, "checks": checks,
    }
    if trace:
        tr = readings.trace
        out["busy_s"], out["trace_window_s"] = tr.busy_s(), tr.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in tr.group_s()[:10]],
                            "idle_gaps": [list(x)
                                          for x in tr.idle_gaps()[:10]]}
    return out


def result_line(cell: spec.Cell, outs: list[dict], trace: bool,
                device_kind: str) -> dict:
    """The result from every process's output (rank 0's first)."""
    r0 = outs[0]
    b = cell.traffic["batch_per_card"]
    if trace:
        metrics = {}
        for name, (_, unit) in r0["per_layer"].items():
            vals = [o["per_layer"][name][0] for o in outs
                    if name in o["per_layer"]]
            metrics[name] = {"value": statistics.fmean(vals), "unit": unit}
    else:
        e2e = {
            "train_img_per_s": len(r0["step_s"]) * b / r0["window_s"],
            "step_ms_p90": p90(r0["step_s"]) * 1e3,
            "peak_mem_gib": max(o["peak"] for o in outs) / GIB,
            "setup_s": r0["setup_s"],
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": device_kind, "count": len(outs),
              "memory_peak_bytes": max(o["peak"] for o in outs)}
    line = {"correct": r0["correct"] and r0["failed"] == 0,
            "attempted": r0["attempted"], "failed": r0["failed"],
            "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = statistics.fmean(o["busy_s"] for o in outs)
        device["window_s"] = statistics.fmean(o["trace_window_s"]
                                              for o in outs)
        line["breakdown"] = r0["breakdown"]
    line["checks"] = r0["checks"]
    return line


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(world: int, script: str, argv: list[str]
                ) -> list[subprocess.Popen]:
    """Ranks 1..world-1 of ``script`` with the same arguments."""
    port = free_port()
    os.environ["PORT_BENCH_PORT"] = str(port)
    procs = []
    for r in range(1, world):
        env = dict(os.environ, PORT_BENCH_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, script, *argv], env=env,
            stdout=sys.stderr, cwd=os.getcwd()))
    return procs


def init_group(world: int) -> Group:
    import torch.distributed as dist

    rank = int(os.environ.get("PORT_BENCH_RANK", "0"))
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{os.environ['PORT_BENCH_PORT']}",
        world_size=world, rank=rank)
    return Group(rank=rank, world=world, host=dist.new_group(backend="gloo"))


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(description="one run of a benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    world = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {world} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    no_tf32()
    torch.set_num_threads(1)        # the host's work is the step's Python
    rank0 = "PORT_BENCH_RANK" not in os.environ
    children = (start_ranks(world, str(Path(__file__).resolve()), argv)
                if rank0 and world > 1 else [])
    try:
        group = init_group(world) if world > 1 else Group()
        device = torch.device("cuda", group.rank)
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       device, group)
        outs = group.gather(out)
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()
        if not rank0:
            return 0
        for child in children:
            if child.wait(timeout=300) != 0:
                print(f"rank process {child.pid} exited {child.returncode}",
                      file=sys.stderr)
                return 1
        line = result_line(cell, outs, bool(args.trace),
                           torch.cuda.get_device_name(0))
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                with contextlib.suppress(subprocess.TimeoutExpired):
                    child.wait(timeout=30)
    found = banned_modules()
    if found:
        print(f"modules that the benchmark must not load: {found}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
