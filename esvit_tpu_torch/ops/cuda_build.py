"""Build and load the port's CUDA kernels.

Each library has a plain C interface and is built from ``csrc/<name>.cu``
and any ``csrc/<name>_*.cu`` (a source split off so that its kernels
compile beside the rest). At first use every source is compiled with
nvcc for sm_90a, one process per source, all started together, and the
objects are linked into ``esvit_tpu_torch/_build/`` under a file name that
carries a hash of the sources and of every header in ``csrc/`` (so an
edit to a shared ``.cuh`` rebuilds its users); the library is loaded with
ctypes. No PyTorch header is compiled, so a build takes seconds to a
minute or two. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def sources(name: str, csrc: Path = CSRC) -> list[Path]:
    """The sources of library ``name``: csrc/<name>.cu, then every
    csrc/<name>_*.cu in name order."""
    return [csrc / f"{name}.cu", *sorted(csrc.glob(f"{name}_*.cu"))]


def _library(name: str, csrc: Path = CSRC,
             build: Path = BUILD) -> tuple[list[Path], Path]:
    """The library's sources and its path, named by the hash of the
    sources and of every csrc/*.cuh (in name order)."""
    srcs = sources(name, csrc)
    digest = hashlib.sha256()
    for path in (*srcs, *sorted(csrc.glob("*.cuh"))):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return srcs, build / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile library ``name`` (if not built yet) and return its path and
    the compiler's report ('' when it was already built)."""
    return build_all([name])[name]


def build_all(names) -> dict[str, tuple[Path, str]]:
    """Build every library of ``names`` not built yet: one nvcc process per
    source, all running at once, then one link per library; {name:
    (library path, report)}. The report holds, per source, the seconds
    its nvcc took (a line ``nvcc <source>: <s> s``) and its output."""
    out, jobs = {}, []
    for name in names:
        srcs, lib = _library(name, CSRC, BUILD)
        if lib.exists():
            out[name] = (lib, "")
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        for src in srcs:
            obj = lib.with_name(f"{lib.stem}.{src.stem}.{os.getpid()}.o")
            log = obj.with_suffix(".log")
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o",
                   str(obj), str(src)]
            with open(log, "w") as f:
                proc = subprocess.Popen(cmd, stdout=f,
                                        stderr=subprocess.STDOUT)
            jobs.append((name, lib, src, obj, log, proc))
    start, done = time.perf_counter(), {}
    while len(done) < len(jobs):
        for i, job in enumerate(jobs):
            if i not in done and job[5].poll() is not None:
                done[i] = time.perf_counter() - start
        time.sleep(0.1)
    reports, objs = {}, {}
    for i, (name, lib, src, obj, log, proc) in enumerate(jobs):
        text = log.read_text()
        log.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n"
                               f"{text}")
        reports[name] = (reports.get(name, "")
                         + f"nvcc {src.name}: {done[i]:.1f} s\n{text}")
        objs.setdefault(name, (lib, []))[1].append(obj)
    for name, (lib, obj_paths) in objs.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        link = subprocess.run(
            [_nvcc(), "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp), *map(str, obj_paths)],
            capture_output=True, text=True)
        for obj in obj_paths:
            obj.unlink()
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed ({link.returncode}) linking "
                               f"{lib.name}:\n{link.stdout}{link.stderr}")
        os.replace(tmp, lib)
        out[name] = (lib, reports[name])
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, loaded once per process."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
