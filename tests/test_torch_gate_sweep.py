"""The learning gate's seed sweep (``esvit_tpu_torch.validate_learning
--seeds``), on the CPU.

- ``parse_seeds``: ranges, lists and mixes; refusals of an empty list, a
  descending range and a repeated seed; the CLI refuses ``--seeds`` with
  ``--seed`` and ``--jobs`` below 1.
- ``summarize``: the mean, the sample SD and SE = SD / sqrt(n) against
  ``statistics``; the three verdicts at and around their edges.
- ``run_sweep`` through ``main`` on stand-in legs (a few lines of Python
  that print a leg's k-NN lines): a leg that fails its gate or crashes is
  counted and the others run; the exit code of each verdict; a sweep
  resumes from its finished logs; each leg's command line parses back to
  the sweep's settings.
- A two-seed femto sweep on the CPU through the CLI gives each seed the
  gain of that seed's single-seed run.
"""

import math
import os
import statistics
import subprocess
import sys

import pytest

from esvit_tpu_torch import validate_learning as vl
from tests.torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240

# A stand-in leg: prints the k-NN lines of LEGS[seed] = (before, after,
# exit code), or crashes before its trained eval where LEGS[seed] is None.
FAKE_LEG = """
import sys
LEGS = {legs!r}
seed = int(sys.argv[sys.argv.index("--seed") + 1])
leg = LEGS[seed]
if leg is None:
    print("[random init] 10-NN top-1: 20.00%")
    print("RuntimeError: lost the device")
    sys.exit(1)
before, after, rc = leg
print(f"[random init] 10-NN top-1: {{before:.2f}}%")
print(f"[trained] 10-NN top-1: {{after:.2f}}%")
print(f"result: {{before:.1f}}% -> {{after:.1f}}% (seed={{seed}})")
if rc:
    print(f"AssertionError: training gain {{after - before:.1f}} < required")
sys.exit(rc)
"""


def _fake(monkeypatch, legs):
    monkeypatch.setattr(vl, "LEG_COMMAND",
                        (sys.executable, "-c", FAKE_LEG.format(legs=legs)))


@pytest.mark.parametrize("text,seeds", [
    ("0-7", list(range(8))),
    ("0,3,5", [0, 3, 5]),
    ("2-4,9", [2, 3, 4, 9]),
    (" 1 - 2 , 7 ", [1, 2, 7]),
])
def test_parse_seeds(text, seeds):
    assert vl.parse_seeds(text) == seeds


@pytest.mark.parametrize("text", ["", ",", "5-3", "a", "1,1", "0-2,2"])
def test_parse_seeds_refuses(text):
    with pytest.raises(ValueError):
        vl.parse_seeds(text)


@pytest.mark.parametrize("argv,message", [
    (["--seeds", "0-1", "--seed", "3"], "exclude each other"),
    (["--seeds", ""], "--seeds"),
    (["--seeds", "0-1", "--jobs", "0"], "--jobs"),
])
def test_cli_refuses(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        vl.main(["--cpu", *argv])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_summary_statistics():
    gains = [3.5, 9.4, 13.7, 8.2]          # four nano-Swin legs on the card
    s = vl.summarize(gains, 10.0)
    assert s["n"] == 4
    assert s["mean"] == pytest.approx(statistics.mean(gains), abs=1e-12)
    assert s["sd"] == pytest.approx(statistics.stdev(gains), abs=1e-12)
    assert s["se"] == pytest.approx(statistics.stdev(gains) / 2, abs=1e-12)
    one = vl.summarize([12.0], 10.0)
    assert one["mean"] == 12.0 and math.isnan(one["sd"])
    assert math.isnan(one["se"])


@pytest.mark.parametrize("gains,bar,verdict", [
    ([10.0, 10.0], 10.0, "met"),            # mean == bar
    ([9.99, 9.99], 10.0, "fault"),          # no spread: SE 0
    ([7.0, 9.0], 8.0, "met"),
    ([7.0, 9.0], 10.0, "unresolved"),       # mean + 2 SE == bar exactly
    ([7.0, 9.0], 10.0001, "fault"),
    ([5.0], 10.0, "unresolved"),            # one leg: no SE, never a fault
    ([12.0], 10.0, "met"),
])
def test_verdict_edges(gains, bar, verdict):
    s = vl.summarize(gains, bar)
    if len(gains) == 2 and gains[0] != gains[1]:
        assert s["mean"] + 2 * s["se"] == 10.0     # the edge is exact
    assert s["verdict"] == verdict


def test_failing_and_crashing_legs_are_counted(monkeypatch, capsys):
    """Seed 1 fails its gate and seed 2 crashes: seeds 0 and 3 still
    run; the failed leg's gain counts toward the mean, the crashed leg is
    listed and makes the sweep exit 1."""
    _fake(monkeypatch, {0: (20.0, 35.0, 0), 1: (20.0, 25.0, 1), 2: None,
                        3: (21.0, 33.0, 0)})
    with pytest.raises(SystemExit) as e:
        vl.main(["--cpu", "--seeds", "0-3", "--jobs", "2"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert out.count("[seed ") == 4
    assert "[seed 2] no result line gain none; exit 1" in out
    summary = [ln for ln in out.splitlines() if ln.startswith("summary:")]
    assert len(summary) == 1
    assert "gains=0:+15.00,1:+5.00,3:+12.00" in summary[0]
    assert "n=3 mean=+10.67" in summary[0]
    assert "cleared=2/4" in summary[0] and "crashed=2 " in summary[0]


@pytest.mark.parametrize("after,verdict,code", [
    (36.0, "met", 0), (29.0, "unresolved", 0), (25.0, "fault", 1)])
def test_exit_code_per_verdict(after, verdict, code, monkeypatch, capsys):
    """Gains (after - 20) and after - 20 +- 2 at the +10 Swin bar: the
    sweep returns on met and unresolved and exits 1 on a fault."""
    _fake(monkeypatch, {0: (20.0, after - 2, 1), 1: (20.0, after, 1),
                        2: (20.0, after + 2, 1)})
    argv = ["--cpu", "--task", "shapes_hard", "--steps", "6000",
            "--seeds", "0-2"]
    if code:
        with pytest.raises(SystemExit) as e:
            vl.main(argv)
        assert e.value.code == code
    else:
        assert vl.main(argv)["verdict"] == verdict
    assert f"bar=+10.0 crashed=- verdict={verdict}" in capsys.readouterr().out


def test_sweep_resumes_from_its_logs(tmp_path, monkeypatch, capsys):
    """A second sweep into one --log_dir reads each finished leg's log;
    a log of another command line, or one without its exit line, runs
    again."""
    logs = str(tmp_path / "legs")
    argv = ["--cpu", "--min_gain", "-100", "--seeds", "0-2",
            "--log_dir", logs]
    _fake(monkeypatch, {0: (20.0, 30.0, 0), 1: (20.0, 31.0, 0),
                        2: (20.0, 32.0, 0)})
    first = vl.main(argv)
    assert open(os.path.join(logs, "swin_seed0.log")).read().endswith(
        "[sweep] exit 0\n")
    cut = os.path.join(logs, "swin_seed1.log")
    with open(cut) as f:
        text = f.read()
    with open(cut, "w") as f:                 # a leg cut short
        f.write(text.replace("[sweep] exit 0\n", ""))
    capsys.readouterr()
    _fake(monkeypatch, {0: (20.0, 40.0, 0), 1: (20.0, 41.0, 0),
                        2: (20.0, 42.0, 0)})
    second = vl.main(argv)
    assert [second["legs"][s]["gain"] for s in range(3)] == [10.0, 21.0,
                                                             12.0]
    out = capsys.readouterr().out
    assert out.count("(read from its log)") == 2
    assert first["legs"][0] == second["legs"][0]
    third = vl.main([*argv[:-4], "--steps", "10", *argv[-4:]])
    assert [third["legs"][s]["gain"] for s in range(3)] == [20.0, 21.0,
                                                            22.0]


@pytest.mark.parametrize("argv", [
    [],
    ["--backbone", "vil", "--no-fused", "--task", "shapes", "--steps",
     "6000", "--lr", "0.002", "--cpu", "--jobs", "8"],
    ["--size", "femto", "--no-dense", "--host_aug", "--min_gain", "-100",
     "--max_seconds", "30.5", "--eval_every", "7", "--batch", "16"],
    ["--hires", "--backbone", "cvt", "--log_dir", "legs"],
])
def test_leg_argv_parses_back_to_the_sweep(argv, monkeypatch):
    """Each leg's command line gives the sweep's settings with its own
    seed and no sweep options."""
    seen = []
    monkeypatch.setattr(vl, "run_sweep",
                        lambda args, seeds, bar: seen.append(args) or {
                            "exit_code": 0})
    vl.main([*argv, "--seeds", "4,6"])
    args = seen[0]
    parsed = []
    monkeypatch.setattr(vl, "validate", lambda **kw: parsed.append(kw) or {
        "before": 0.0, "after": 50.0, "steps": 1, "seconds": 1.0,
        "last_loss": 1.0, "feed_wait_seconds": 0.0})
    for seed in (4, 6):
        vl.main(vl.leg_argv(args, seed))
        kw = parsed.pop()
        assert kw["seed"] == seed and kw["steps"] == args.steps
        assert kw["backbone"] == args.backbone and kw["fused"] == args.fused
        assert kw["device"] == ("cpu" if args.cpu else "cuda")
        assert (kw["lr"], kw["max_seconds"], kw["hires"], kw["host_aug"],
                kw["dense"], kw["batch"], kw["size"], kw["task"],
                kw["eval_every"]) == (
            args.lr, args.max_seconds, args.hires, args.host_aug,
            args.dense, args.batch, args.size, args.task, args.eval_every)


def test_femto_sweep_equals_single_seed_runs():
    """Two femto legs through the CLI (one at a time and two at once give
    the same numbers: each leg is its own process) against the two
    single-seed commands, all on one intra-op thread."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    common = [sys.executable, "-m", "esvit_tpu_torch.validate_learning",
              "--size", "femto", "--steps", "8", "--batch", "16", "--cpu",
              "--task", "shapes", "--lr", "0.05", "--min_gain", "-100"]
    procs = [subprocess.Popen([*common, "--seed", str(s)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s in (0, 1)]
    sweep = subprocess.run([*common, "--seeds", "0-1", "--jobs", "2"],
                           cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=TIMEOUT)
    singles = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    assert sweep.returncode == 0, sweep.stdout + sweep.stderr
    gains = [vl.leg_gain(out) for out in singles]
    assert None not in gains and gains != [0.0, 0.0]
    summary = [ln for ln in sweep.stdout.splitlines()
               if ln.startswith("summary:")]
    assert len(summary) == 1
    assert f"gains=0:{gains[0]:+.2f},1:{gains[1]:+.2f} n=2" in summary[0]
