"""Multi-process launch helper (port of esvit_tpu/launch.py; ref:
main_esvit_mnodes.py + utils.py:442-465).

One process per card, as the reference's ``torch.distributed.launch``:
the rendezvous address, world size, rank and local rank come from the
same SLURM, OpenMPI or torch-style environment variables that esvit_tpu
reads, so existing launch scripts keep working:

    # SLURM:   srun python -m esvit_tpu_torch.train.train --distributed ...
    # OpenMPI: mpirun -n <procs> python -m esvit_tpu_torch.train.train \\
    #              --distributed ...
    # manual:  MASTER_ADDR=host0 MASTER_PORT=1234 WORLD_SIZE=4 RANK=i \\
    #              LOCAL_RANK=i python -m esvit_tpu_torch.train.train \\
    #              --distributed ...

NCCL runs on the cards; gloo when the caller asks for the CPU. NCCL
takes one rank per card.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def resolve_distributed_env() -> dict | None:
    """Rendezvous spec from SLURM / OpenMPI / torch-style env vars
    (mirrors utils.py:443-449 and main_esvit_mnodes.py:77-92): esvit_tpu's
    ``coordinator_address``, ``num_processes`` and ``process_id``, plus
    ``local_rank``, this process's card on its host."""
    env = os.environ
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
        head = nodelist.split(",")[0].split("[")[0] if nodelist else "localhost"
        return {
            "coordinator_address": f"{head}:{env.get('MASTER_PORT', '12355')}",
            "num_processes": int(env["SLURM_NTASKS"]),
            "process_id": int(env["SLURM_PROCID"]),
            "local_rank": int(env.get("SLURM_LOCALID", 0)),
        }
    if "OMPI_COMM_WORLD_SIZE" in env:
        addr = env.get("MASTER_ADDR", "localhost")
        port = env.get("MASTER_PORT", "12355")
        return {
            "coordinator_address": f"{addr}:{port}",
            "num_processes": int(env["OMPI_COMM_WORLD_SIZE"]),
            "process_id": int(env["OMPI_COMM_WORLD_RANK"]),
            "local_rank": int(env.get("OMPI_COMM_WORLD_LOCAL_RANK", 0)),
        }
    if "WORLD_SIZE" in env and "RANK" in env:
        addr = env.get("MASTER_ADDR", "localhost")
        port = env.get("MASTER_PORT", "12355")
        return {
            "coordinator_address": f"{addr}:{port}",
            "num_processes": int(env["WORLD_SIZE"]),
            "process_id": int(env["RANK"]),
            "local_rank": int(env.get("LOCAL_RANK", 0)),
        }
    return None


def initialize_distributed(verbose: bool = True,
                           device: torch.device | str = "cuda") -> None:
    """``torch.distributed.init_process_group`` from the environment:
    NCCL with this process's card (``local_rank``) made current for a
    CUDA ``device``, gloo for the CPU. Call once per process before any
    work on the card."""
    spec = resolve_distributed_env()
    if spec is None:
        raise RuntimeError(
            "--distributed needs the rendezvous in the environment: SLURM "
            "(SLURM_PROCID, SLURM_NTASKS), OpenMPI (OMPI_COMM_WORLD_SIZE, "
            "OMPI_COMM_WORLD_RANK) or WORLD_SIZE and RANK (with MASTER_ADDR "
            "and MASTER_PORT)")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(spec["local_rank"])
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{spec['coordinator_address']}",
        world_size=spec["num_processes"], rank=spec["process_id"])
    if verbose:
        where = (f"cuda:{spec['local_rank']}" if device.type == "cuda"
                 else "cpu")
        print(f"torch.distributed: process {dist.get_rank()}/"
              f"{dist.get_world_size()}, {backend} on {where}", flush=True)
