"""The BASELINE.md accuracy gate in one command (the twin of
scripts/reproduce_baseline.py): a released EsViT .pth -> import -> k-NN
-> the reference-protocol linear probe -> PASS / FAIL against the
published k-NN top-1 (75.7 +- 0.3 for Swin-T W=7 V+R).

    python -m esvit_tpu_torch.reproduce_baseline \\
        --pth checkpoint_best.pth --imagenet /data/imagenet   # on the card
    python -m esvit_tpu_torch.reproduce_baseline --device cpu ...

The flags, the four ``[i/4]`` stages, ``baseline_report.json`` and the
exit status are the original's; ``--device`` (default ``cuda``) is the
port's, as the eval CLIs have it. The backbone is built as those CLIs
build it (evals/knn.py ``model_from_args``), so the runbook takes the
same kernel route as ``python -m esvit_tpu_torch.evals.knn``: on the
card the evals' fp32 kernels, with no plain fallback.

The gate is looked up by (arch, the model config's ``window_size``), as
the original looks it up. ViL's and CvT's configs carry ``window_size``
only in their stage configs, so their rows of ``GATES`` are never found:
``vil_tiny`` and ``cvt_tiny`` get no gate and exit 0, as they do in
esvit_tpu's runbook, and the "no gate" line says why.

Exit status: 1 if the gate FAILs, else 0 (the gate passes, or none
applies).
"""

from __future__ import annotations

import argparse
import json
import os

# Published numbers (ref README tables; SURVEY.md §6): (knn_top1,
# linear_top1) for V+R 300-epoch checkpoints, keyed by (arch, window).
GATES = {
    ("swin_tiny", 7): (75.7, 78.0),
    ("swin_small", 7): (77.7, 79.5),
    ("swin_base", 7): (78.9, 80.4),
    ("swin_tiny", 14): (77.0, 78.7),
    ("swin_small", 14): (79.1, 80.8),
    ("swin_base", 14): (79.3, 81.3),
    ("vil_tiny", 7): (74.5, 77.5),
    ("cvt_tiny", 7): (76.7, 78.5),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("esvit_tpu_torch baseline reproduction runbook")
    p.add_argument("--pth", required=True, help="released torch checkpoint")
    p.add_argument("--checkpoint_key", default="teacher")
    p.add_argument("--arch", default="swin_tiny")
    p.add_argument("--window_size", default=None, type=int)
    p.add_argument("--imagenet", default="",
                   help="root with train/ and val/ ImageFolder layouts")
    p.add_argument("--data_kind", default="folder")
    p.add_argument("--train_path", default="")
    p.add_argument("--val_path", default="")
    p.add_argument("--dataset_kw", default="{}",
                   help="JSON kwargs for build_dataset (smoke tests)")
    p.add_argument("--batch_size", default=128, type=int)
    p.add_argument("--nb_knn", nargs="+", type=int, default=[10, 20])
    p.add_argument("--linear_epochs", default=100, type=int)
    p.add_argument("--n_last_blocks", default=4, type=int)
    p.add_argument("--skip_linear", action="store_true")
    p.add_argument("--gate_tol", default=0.3, type=float,
                   help="BASELINE.md allows +-0.3 on k-NN top-1")
    p.add_argument("--no_gate", action="store_true")
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--device", default="cuda",
                   help="where the evals run: the card unless 'cpu'")
    return p


def no_gate_reason(model_cfg, no_gate: bool) -> str:
    """Why no gate applies: --no_gate, a config with no top-level
    window_size (ViL, CvT: their rows are looked up at window 0), or an
    (arch, window) that GATES does not list."""
    if no_gate:
        return "--no_gate"
    if not hasattr(model_cfg, "window_size"):
        return (f"{type(model_cfg).__name__} has no top-level window_size, "
                "so the gate is looked up at window 0")
    return f"no published number at window {model_cfg.window_size}"


def main(argv=None):
    args = build_parser().parse_args(argv)

    from esvit_tpu_torch.data import datasets as datasets_lib
    from esvit_tpu_torch.evals import knn as knn_lib
    from esvit_tpu_torch.evals import linear as linear_lib

    model_cfg, backbone = knn_lib.model_from_args(args)

    print(f"[1/4] importing {args.pth} (key={args.checkpoint_key})", flush=True)
    backbone = knn_lib.load_backbone_variables(
        backbone, model_cfg, args.pth, args.checkpoint_key)

    train_path = args.train_path or (args.imagenet and
                                     os.path.join(args.imagenet, "train"))
    val_path = args.val_path or (args.imagenet and
                                 os.path.join(args.imagenet, "val"))
    ds_kw = json.loads(args.dataset_kw)
    if args.data_kind == "folder":
        train_ds = datasets_lib.build_dataset("folder", root=train_path, **ds_kw)
        val_ds = datasets_lib.build_dataset("folder", root=val_path, **ds_kw)
    else:
        train_ds = datasets_lib.build_dataset(args.data_kind, **ds_kw)
        val_ds = datasets_lib.build_dataset(args.data_kind, **ds_kw)

    print(f"[2/4] k-NN eval ({len(train_ds)} train / {len(val_ds)} val)",
          flush=True)
    knn_results = knn_lib.run_knn_eval(
        backbone, train_ds, val_ds, ks=tuple(args.nb_knn),
        batch_size=args.batch_size, size=model_cfg.img_size,
        device=args.device)
    best_knn = max(t1 for t1, _ in knn_results.values()) if knn_results else 0.0

    linear_top1 = None
    if not args.skip_linear:
        print("[3/4] linear probe (reference per-epoch augmented protocol)",
              flush=True)
        linear_top1, _ = linear_lib.run_linear_eval(
            backbone, train_ds, val_ds, n_last_blocks=args.n_last_blocks,
            epochs=args.linear_epochs,
            batch_size=min(args.batch_size, len(train_ds)),
            device=args.device)
    else:
        print("[3/4] linear probe skipped", flush=True)

    gate = GATES.get((args.arch, getattr(model_cfg, "window_size", 0)))
    report = {
        "pth": args.pth, "arch": args.arch,
        "knn": {str(k): v for k, v in knn_results.items()},
        "best_knn_top1": best_knn,
        "linear_top1": linear_top1,
        "gate": gate, "gate_tol": args.gate_tol,
    }
    ok = True
    if gate and not args.no_gate:
        expect_knn, expect_lin = gate
        ok = best_knn >= expect_knn - args.gate_tol
        report["gate_pass"] = ok
        print(f"[4/4] gate: k-NN {best_knn:.2f} vs published "
              f"{expect_knn:.1f} +- {args.gate_tol} -> "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if linear_top1 is not None:
            print(f"      linear {linear_top1:.2f} vs published "
                  f"{expect_lin:.1f} (informational)", flush=True)
    else:
        print(f"[4/4] no gate for ({args.arch}) — results informational: "
              f"{no_gate_reason(model_cfg, args.no_gate)}", flush=True)

    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "baseline_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
