"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from port_bench import run, spec

BANNED = set(run.BANNED)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in spec.HERE.rglob("*.py")
                 if "_cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_source_imports_jax(path):
    assert not set(_imports(path)) & BANNED


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference")
                                        .rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not set(_imports(path)) & {"esvit_tpu_torch", "esvit_tpu"}


def test_whole_names_are_compared(monkeypatch):
    import esvit_tpu_torch  # noqa: F401

    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "esvit_tpu.models", sys)
    assert run.banned_modules() == ["esvit_tpu"]


def test_a_run_process_loads_no_banned_module():
    """Import everything a run imports, the program's step and every
    metric reader in a fresh process, and look at sys.modules."""
    code = (
        "import sys, json\n"
        "sys.argv = ['run']\n"
        "import port_bench.run as r, port_bench.calibrate\n"
        "from port_bench import spec, counts\n"
        "import esvit_tpu_torch.train.step, esvit_tpu_torch.parallel.mesh\n"
        "for m in spec.benchmark()['per_layer']: spec.reader(m['name'])\n"
        "print(json.dumps(r.banned_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, check=True,
                         env={"PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
