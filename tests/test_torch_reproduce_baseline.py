"""The port's BASELINE runbook (esvit_tpu_torch/reproduce_baseline.py)
against esvit_tpu's (scripts/reproduce_baseline.py), on the CPU.

- Its ``GATES``, row by row, and its parser, flag by flag (apart from the
  port's ``--device``), equal the original's.
- End to end on one reference-layout .pth ('teacher', 'module.' prefix)
  of a seeded femto Swin and one pair of PNG ImageFolders: the k-NN
  results and the best top-1 equal, the linear probe's top-1 within
  PROBE_TOL (tests/test_torch_evals.py holds the probe's weights to 1e-4
  and its accuracies equal), the report's keys, the JSON last line and
  the exit codes equal.
- The gate's verdict at and around its edge, ``--no_gate`` and
  ``--skip_linear``, through both runbooks on a stubbed k-NN result.
- ``vil_tiny`` and ``cvt_tiny`` get no gate and exit 0 in both: their
  configs have no top-level ``window_size``, so the lookup misses their
  rows (esvit_tpu's behaviour, which the port keeps).
- Importing the runbook and the modules its ``main`` imports loads no
  jax, flax, optax, esvit_tpu or scripts module.
"""

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from esvit_tpu.evals import knn as jknn
from esvit_tpu.evals import linear as jlinear
from esvit_tpu.models import registry as jregistry
from esvit_tpu_torch import config as tcfg
from esvit_tpu_torch import reproduce_baseline as port
from esvit_tpu_torch.evals import knn as tknn
from esvit_tpu_torch.evals import linear as tlinear
from esvit_tpu_torch.models.registry import build_backbone
from scripts import reproduce_baseline as orig
from tests.torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_TOL = 1e-4


class _Parsed(Exception):
    pass


def _original_parser(monkeypatch):
    """The parser the original's main builds (it builds it inline): caught
    at parse_args, before it imports anything."""
    got = {}

    def grab(self, *a, **kw):
        got["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            orig.main([])
    return got["parser"]


def _flags(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


ORIGINAL_FLAGS = ("pth", "checkpoint_key", "arch", "window_size", "imagenet",
                  "data_kind", "train_path", "val_path", "dataset_kw",
                  "batch_size", "nb_knn", "linear_epochs", "n_last_blocks",
                  "skip_linear", "gate_tol", "no_gate", "output_dir")


@pytest.mark.parametrize("key", sorted(orig.GATES))
def test_gates_equal_the_original(key):
    assert port.GATES[key] == orig.GATES[key]
    assert set(port.GATES) == set(orig.GATES)


@pytest.mark.parametrize("dest", ORIGINAL_FLAGS)
def test_flag_equals_the_original(dest, monkeypatch):
    want = _flags(_original_parser(monkeypatch))[dest]
    got = _flags(port.build_parser())[dest]
    for field in ("option_strings", "default", "type", "nargs", "required",
                  "const"):
        assert getattr(got, field) == getattr(want, field), field
    assert type(got) is type(want)


def test_parser_adds_only_device(monkeypatch):
    want = _flags(_original_parser(monkeypatch))
    got = _flags(port.build_parser())
    assert set(want) == set(ORIGINAL_FLAGS)
    assert set(got) == set(want) | {"device"}
    assert got["device"].option_strings == ["--device"]
    assert got["device"].default == "cuda"


# --- end to end on the CPU -------------------------------------------------


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """Both runbooks on one femto .pth and one ImageFolder root (train/
    and val/, 3 classes of 40 x 36 PNGs): (rc, report, stdout's last line)
    of each."""
    root = tmp_path_factory.mktemp("runbook")
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("val", 4)):
        for c in ("a", "b", "c"):
            d = root / "imagenet" / split / c
            d.mkdir(parents=True)
            for i in range(n):
                arr = rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)
                Image.fromarray(arr).save(d / f"{i}.png")
    model = build_backbone(tcfg.get_model_config("swin_femto"),
                           generator=torch.Generator().manual_seed(0))
    pth = root / "synthetic_teacher.pth"
    torch.save({"teacher": {"module." + k: v
                            for k, v in model.state_dict().items()}},
               str(pth))
    args = ["--pth", str(pth), "--arch", "swin_femto", "--imagenet",
            str(root / "imagenet"), "--batch_size", "8", "--nb_knn", "3", "5",
            "--linear_epochs", "2"]
    out = {}
    for name, main, extra in (("orig", orig.main, []),
                              ("port", port.main, ["--device", "cpu"])):
        d = root / name
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(args + extra + ["--output_dir", str(d)])
        report = json.loads((d / "baseline_report.json").read_text())
        last = buf.getvalue().strip().splitlines()[-1]
        out[name] = (rc, report, json.loads(last), buf.getvalue())
    return out


def test_end_to_end_knn_equals_the_original(both_runs):
    want, got = both_runs["orig"][1], both_runs["port"][1]
    assert set(got["knn"]) == {"3", "5"}
    assert got["knn"] == want["knn"]
    assert got["best_knn_top1"] == want["best_knn_top1"]
    assert got["best_knn_top1"] == max(t1 for t1, _ in got["knn"].values())


def test_end_to_end_probe_agrees_with_the_original(both_runs):
    want, got = both_runs["orig"][1], both_runs["port"][1]
    assert got["linear_top1"] is not None
    assert abs(got["linear_top1"] - want["linear_top1"]) <= PROBE_TOL


def test_end_to_end_report_and_exit_equal_the_original(both_runs):
    (rc_o, rep_o, last_o, _), (rc_p, rep_p, last_p, _) = (
        both_runs["orig"], both_runs["port"])
    assert rc_p == rc_o == 0                 # femto has no gate
    assert list(rep_p) == list(rep_o)
    assert rep_p["gate"] is rep_o["gate"] is None
    assert "gate_pass" not in rep_p
    assert {k: v for k, v in rep_p.items() if k != "linear_top1"} == {
        k: v for k, v in rep_o.items() if k != "linear_top1"}
    assert last_p == rep_p and last_o == rep_o


def test_end_to_end_stages_match_the_original(both_runs):
    def stages(text):
        return [line.split()[0] for line in text.splitlines()
                if line.startswith("[") and "/4]" in line[:5]]

    assert stages(both_runs["port"][3]) == stages(both_runs["orig"][3]) == [
        "[1/4]", "[2/4]", "[3/4]", "[4/4]"]


# --- the gate on a stubbed k-NN result --------------------------------------


def _stub(monkeypatch, which, best, linear=50.0):
    """Both runbooks' imports, model building and evals stubbed: the k-NN
    result's best top-1 is ``best``, the probe's top-1 ``linear``. The
    model config is the real one. Returns the runbook's main."""
    if which == "port":
        monkeypatch.setattr(tknn, "build_backbone", lambda cfg, **kw: None)
        monkeypatch.setattr(tknn, "load_backbone_variables",
                            lambda backbone, *a: backbone)
        monkeypatch.setattr(tknn, "run_knn_eval",
                            lambda *a, **kw: {10: (best, 99.0),
                                              20: (best - 1, 98.0)})
        monkeypatch.setattr(tlinear, "run_linear_eval",
                            lambda *a, **kw: (linear, 90.0))
        return lambda argv: port.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(jregistry, "build_backbone", lambda cfg: None)
    monkeypatch.setattr(jknn, "load_backbone_variables", lambda *a: None)
    monkeypatch.setattr(jknn, "run_knn_eval",
                        lambda *a, **kw: {10: (best, 99.0),
                                          20: (best - 1, 98.0)})
    monkeypatch.setattr(jlinear, "run_linear_eval",
                        lambda *a, **kw: (linear, 90.0))
    return orig.main


def _stub_args(tmp_path, arch="swin_tiny", *extra):
    return ["--pth", "unused.pth", "--arch", arch, "--data_kind",
            "synthetic", "--dataset_kw", json.dumps({"n": 4, "size": 8}),
            "--output_dir", str(tmp_path), *extra]


EDGE = 75.7 - 0.3          # the published 75.7 less the default tolerance


@pytest.mark.parametrize("which", ["port", "orig"])
@pytest.mark.parametrize("best,extra,rc,verdict", [
    (EDGE, (), 0, True),
    (math.nextafter(EDGE, -math.inf), (), 1, False),
    (80.0, (), 0, True),
    (10.0, ("--no_gate",), 0, None),
    (10.0, ("--skip_linear",), 1, False),
    (75.5, ("--gate_tol", "0.1"), 1, False),
], ids=["edge", "below", "above", "no_gate", "skip_linear", "gate_tol"])
def test_gate_verdict(which, best, extra, rc, verdict, monkeypatch, tmp_path,
                      capsys):
    main = _stub(monkeypatch, which, best)
    assert main(_stub_args(tmp_path, "swin_tiny", *extra)) == rc
    report = json.loads((tmp_path / "baseline_report.json").read_text())
    out = capsys.readouterr().out
    assert report["gate"] == [75.7, 78.0]
    assert report["best_knn_top1"] == best
    assert report.get("gate_pass") is verdict
    if verdict is not None:
        assert ("PASS" if verdict else "FAIL") in out
    if "--skip_linear" in extra:
        assert report["linear_top1"] is None
        assert "[3/4] linear probe skipped" in out
    else:
        assert report["linear_top1"] == 50.0
    assert json.loads(out.strip().splitlines()[-1]) == report


@pytest.mark.parametrize("which", ["port", "orig"])
@pytest.mark.parametrize("arch", ["vil_tiny", "cvt_tiny"])
def test_vil_and_cvt_rows_are_never_looked_up(which, arch, monkeypatch,
                                              tmp_path, capsys):
    """Their GATES rows exist, but the lookup's window is 0: no gate, exit
    0, even at a k-NN top-1 of 0."""
    assert (arch, 7) in orig.GATES
    main = _stub(monkeypatch, which, 0.0)
    assert main(_stub_args(tmp_path, arch)) == 0
    report = json.loads((tmp_path / "baseline_report.json").read_text())
    assert report["gate"] is None and "gate_pass" not in report
    out = capsys.readouterr().out
    assert f"[4/4] no gate for ({arch})" in out
    if which == "port":
        assert "has no top-level window_size" in out


def test_no_gate_reasons():
    swin = tcfg.get_model_config("swin_femto")
    assert port.no_gate_reason(swin, True) == "--no_gate"
    assert port.no_gate_reason(swin, False) == (
        "no published number at window 4")
    assert "ViLConfig has no top-level window_size" in port.no_gate_reason(
        tcfg.get_model_config("vil_tiny"), False)


def test_imports_no_jax_or_reference():
    code = ("import sys\n"
            "import esvit_tpu_torch.reproduce_baseline as m\n"
            "import esvit_tpu_torch.data.datasets, esvit_tpu_torch.evals.knn\n"
            "import esvit_tpu_torch.evals.linear\n"
            "m.build_parser()\n"
            "bad = ('jax', 'jaxlib', 'flax', 'optax', 'esvit_tpu', 'scripts')\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in bad))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
