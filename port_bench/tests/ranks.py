"""One rank of a femto run over gloo on the CPU, one process a rank:
``python -m port_bench.tests.ranks <rank> <world> <port> <fault|none>``;
rank 0 prints the checks as JSON."""

from __future__ import annotations

import json
import sys

import torch
import torch.distributed as dist

from port_bench import run
from port_bench.tests import femto


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    port, fault = sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    group = run.Group(rank=rank, world=world, host=dist.group.WORLD)
    out = run.run_cell(femto.cell(chips=world), 2 ** 31 + 11, 0.2, False,
                       "cpu", group, None if fault == "none" else fault)
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"correct": out["correct"],
                          "checks": out["checks"]}))


if __name__ == "__main__":
    main()
