"""Merge per-seed quality runs into one board: the port's counterpart of
``tools/aggregate_quality.py``, over ``quality_torch.py --track onetrans``'s
JSONs (the same ``onetrans_replica`` layout as ``examples/quality_parity.py``'s).

One recipe run on several seeds; the board reports mean ± std (and min,
max) of the final AND selected (best-validation checkpoint) metrics, a row
per seed, and the comparator lifts on the seeds that carried a DIN
baseline. Field for field the board the JAX tool writes.

Usage:
  python tools_torch/aggregate_quality.py quality_torch_onetrans_S_seed0.json \
      quality_torch_onetrans_S_seed1.json --output board.json --device cpu

The board needs no device; like every entry point of the port it runs on the
card unless given ``--device cpu``, and without CUDA and without ``--device``
it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from recommend_tpu_torch._device import resolve_device

METRICS = ("ctr_auc", "ctr_uauc", "cvr_auc", "cvr_uauc")


def _stats(vals):
    a = np.asarray([v for v in vals if v is not None], dtype=np.float64)
    if a.size == 0:
        return None
    return {
        "mean": round(float(a.mean()), 5),
        "std": round(float(a.std(ddof=1)) if a.size > 1 else 0.0, 5),
        "min": round(float(a.min()), 5),
        "max": round(float(a.max()), 5),
        "n_seeds": int(a.size),
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("inputs", nargs="+")
    ap.add_argument("--output", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless given (cpu to run on the CPU)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Write the board of ``args.inputs`` to ``args.output`` and return it."""
    resolve_device(args.device, "aggregate_quality")

    runs = []
    for path in args.inputs:
        with open(path) as f:
            r = json.load(f)
        runs.append((path, r["onetrans_replica"]))

    recipes = {
        json.dumps({k: v for k, v in o["recipe"].items() if k != "seed"},
                   sort_keys=True)
        for _, o in runs
    }
    board = {
        "protocol": "one recipe, seeds "
                    + str(sorted(o["recipe"]["seed"] for _, o in runs))
                    + "; non-oracle best-val checkpoint selection applied "
                    "identically to every model; metrics on the untouched "
                    "future test split",
        "recipe_identical_across_seeds": len(recipes) == 1,
        "recipe": runs[0][1]["recipe"],
        "geometry": runs[0][1]["geometry"],
        "replica_version": runs[0][1].get("replica_version"),
        "dataset": runs[0][1]["dataset"],
    }

    per_seed = []
    for path, o in runs:
        m = o["onetrans"]
        sel = m.get("selected", {})
        curve = m.get("convergence_curve", [])
        aucs = [c.get("ctr_auc") for c in curve]
        collapsed = bool(aucs) and (max(aucs) - aucs[-1] > 0.05)
        per_seed.append({
            "seed": o["recipe"]["seed"],
            "source": path,
            "final": {k: m.get(k) for k in METRICS},
            "selected": {k: sel.get(k) for k in METRICS},
            "selected_epoch": m.get("selected_epoch"),
            "train_epochs": m.get("train_epochs"),
            "val_curve_ctr_auc": aucs,
            "collapsed": collapsed,
        })
    board["per_seed"] = per_seed
    board["onetrans"] = {
        "final": {k: _stats([s["final"][k] for s in per_seed]) for k in METRICS},
        "selected": {k: _stats([s["selected"][k] for s in per_seed])
                     for k in METRICS},
        "any_collapse": any(s["collapsed"] for s in per_seed),
    }

    # comparator lifts on the seeds that carried baselines (ALL four task
    # metrics, selected-checkpoint protocol — no selective reporting)
    lifts = {}
    for path, o in runs:
        if o.get("din_baseline"):
            lifts[o["recipe"]["seed"]] = {
                "final": o.get("lift_vs_baseline_pct"),
                "selected": o.get("lift_vs_baseline_pct_selected"),
                "din_final": {k: o["din_baseline"].get(k) for k in METRICS},
                "din_selected": {
                    k: o["din_baseline"].get("selected", {}).get(k)
                    for k in METRICS
                },
                "din_selected_epoch": o["din_baseline"].get("selected_epoch"),
            }
    board["vs_din_by_seed"] = lifts or None
    board["reference_anchors"] = runs[0][1].get("reference_anchors")

    with open(args.output, "w") as f:
        json.dump(board, f, indent=2)
    print(json.dumps({
        "final_ctr_auc": board["onetrans"]["final"]["ctr_auc"],
        "selected_ctr_auc": board["onetrans"]["selected"]["ctr_auc"],
        "any_collapse": board["onetrans"]["any_collapse"],
    }, indent=2))
    print(f"wrote {args.output}")
    return board


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
