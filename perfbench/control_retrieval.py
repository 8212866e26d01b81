"""Read, at the KuaiFormer cell's own size, what sets the limits of its
``correct`` (``control.py``'s readings, for the retrieval runner):

- the program's numbers over many seeds (the lower readings);
- the control: the reference with every product in float8, put in the
  program's place (a precision below the configuration's bfloat16);
- two faults planted in the reference put in the program's place: half of
  the batch left out (the in-batch softmax over the other half); the dense
  learning rate a quarter too high (``wrong_lr``);
- with ``--witness-seeds``, what bfloat16 rounding alone does: the program
  in float32 (``program_f32``) and the reference with its products in
  bfloat16 (``reference_bf16``), beside the program as it runs.

A state left unchanged reads 1 in ``change_gap`` and ``rows_gap`` by their
definitions and needs no run. All in one process, one seed after another:

    python3 perfbench/control_retrieval.py \\
        --workload kuaiformer_flagship.train_s2s_b1024 \\
        --program-seeds 1,2,3 --control-seeds 4,5,6 --out build/control.jsonl

Each reading is one JSON line on standard output (and in ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench.control import WRONG_LR, _own, _seeds, _worst_changes  # noqa: E402
from perfbench.reference.onetrans import Bf16Ops, Fp8Ops  # noqa: E402
from perfbench.run import load_cell  # noqa: E402
from perfbench.workloads.retrieval_train import (  # noqa: E402
    program_readings,
    reference_readings,
)
from perfbench.yardstick.compare import gaps  # noqa: E402


def readings(info: dict, program_seeds, control_seeds, device, witness_seeds=()):
    """Yield one dict per reading: its kind, seed, numbers and seconds."""
    cfg, traffic = info["config"], info["traffic"]
    half = slice(0, traffic["batch_size"] // 2)
    wrong_lr = {**cfg, "learning_rate": WRONG_LR * cfg["learning_rate"]}
    f32 = {**cfg, "compute_dtype": "float32"}
    for kind, seeds in (("program", program_seeds), ("control", control_seeds),
                        ("witness", witness_seeds)):
        for seed in seeds:
            t = time.time()
            ref = reference_readings(cfg, traffic, seed, device)
            if kind == "program":
                got = {"program": program_readings(cfg, traffic, seed, device)}
            elif kind == "control":
                got = {"control": reference_readings(cfg, traffic, seed, device, Fp8Ops()),
                       "half_batch": reference_readings(cfg, traffic, seed, device, rows=half),
                       "wrong_lr": reference_readings(wrong_lr, traffic, seed, device)}
            else:
                got = {"program": program_readings(cfg, traffic, seed, device),
                       "program_f32": program_readings(f32, traffic, seed, device),
                       "reference_bf16": reference_readings(cfg, traffic, seed, device,
                                                            Bf16Ops())}
            at = _worst_changes(got["program"], ref) if "program" in got else []
            for k, r in got.items():
                g = gaps(r, ref)
                names = list(dict.fromkeys(_worst_changes(r, ref) + at))
                yield {"kind": k if kind != "witness" else f"witness_{k}", "seed": seed,
                       "seconds": time.time() - t,
                       **{n: g[n] for n in ("grad_gap", "grad_worst", "rows_gap",
                                            "change_gap", "loss_gap", "grad_at",
                                            "change_worst", "change_at")},
                       "loss": r["loss"], "reference_loss": ref["loss"],
                       "own": _own(r, ref, names)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    info = load_cell(args.workload)
    if info["traffic"]["kind"] != "retrieval_train":
        raise SystemExit(f"{args.workload} is not a retrieval training cell; use control.py")
    device = torch.device(args.device)
    out = open(args.out, "a") if args.out else None
    try:
        for r in readings(info, _seeds(args.program_seeds), _seeds(args.control_seeds),
                          device, _seeds(args.witness_seeds)):
            line = json.dumps({"workload": args.workload, **r})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
