"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with nvcc for sm_90a into ``esvit_tpu_torch/_build/``, under a
file name that carries a hash of the source and of every header in
``csrc/`` (so an edit to a shared ``.cuh`` rebuilds its users), and loaded
with ctypes. No PyTorch header is compiled, so a build takes seconds.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "kernels are built from csrc/ at first use")


def _library(name: str, csrc: Path = CSRC,
             build: Path = BUILD) -> tuple[Path, Path]:
    """csrc/<name>.cu and its library's path, named by the hash of the
    source and of every csrc/*.cuh (in name order)."""
    src = csrc / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return src, build / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile csrc/<name>.cu (if not built yet) and return the library's
    path and the compiler's report ('' when it was already built)."""
    return build_all([name])[name]


def build_all(names) -> dict[str, tuple[Path, str]]:
    """Compile every csrc/<name>.cu not built yet, one nvcc process each,
    all running at once; {name: (library path, compiler report)}."""
    out, running = {}, {}
    for name in names:
        src, lib = _library(name)
        if lib.exists():
            out[name] = (lib, "")
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        running[name] = (src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {name: run[3].communicate()[0] for name, run in running.items()}
    for name, (src, lib, tmp, proc) in running.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n"
                               f"{reports[name]}")
        os.replace(tmp, lib)
        out[name] = (lib, reports[name])
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, loaded once per process."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
