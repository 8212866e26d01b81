"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. The cell names a configuration (its file under ``configs/``) and a
traffic mix (``traffic/<traffic>.json``, whose ``kind`` names the runner
under ``workloads/``). Each metric is read by ``metrics/<name>.py``, and
``limits/<cell>.json`` holds the limits of the numbers that decide
``correct`` (a number whose limit is null is reported, not compared). The
last line of standard output is the result, one JSON object; the numbers
compared, each with its limit, are the last lines of standard error and
the result's last key, ``checks``.

It exits without a result (code 3) when CUDA or the cell's cards are
missing, and (code 4) when JAX, flax or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "perfbench")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "recommend_tpu")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str) -> dict:
    """Everything one cell needs, found by name: its ``BENCHMARK.json``
    entry, the configuration, the traffic, the limits and the metrics it
    reports."""
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    limits_path = os.path.join(ROOT, "perfbench", "limits", f"{workload}.json")
    limits = _json(limits_path) if os.path.exists(limits_path) else {}

    def reported(section):
        return [m for m in bench[section] if workload in m.get("workloads", [workload])]

    return {"cell": cell, "config": _json(os.path.join(ROOT, entry["file"]))["config"],
            "traffic": _json(os.path.join(ROOT, "perfbench", "traffic",
                                          f"{cell['traffic']}.json")),
            "limits": {k: v["limit"] for k, v in limits.items() if v["limit"] is not None},
            "end_to_end": reported("end_to_end"), "per_layer": reported("per_layer")}


def reader(name: str):
    """The module ``metrics/<name>.py`` (its ``read(ctx)`` gives the value,
    or None where the run has nothing to read)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(info: dict, seed: int, seconds: float, trace: bool, device, device_name: str,
             t_start: float) -> dict:
    """Run the cell and return the result object (without printing it)."""
    from perfbench.yardstick.compare import NAMES, verdict

    traffic = info["traffic"]
    runner = importlib.import_module(f"perfbench.workloads.{traffic['kind']}")
    out = runner.run(info["config"], traffic, seed, seconds, trace, device, t_start)
    ctx = {**out, "cfg": info["config"], "traffic": traffic, "device_name": device_name}
    metrics = {}
    for m in info["per_layer" if trace else "end_to_end"]:
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers, limits = out["numbers"], info["limits"]
    dev = {"platform": "gpu" if str(device).startswith("cuda") else "cpu",
           "kind": device_name, "count": info["cell"]["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": verdict(numbers, limits), "attempted": out["steps"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = out["profile"]["busy_s"]
        dev["window_s"] = out["profile"]["window_s"]
        result["breakdown"] = out["breakdown"]
    result["where"] = {k: numbers[k] for k in ("grad_at", "change_worst", "change_at")}
    result["where"]["reported"] = {n: numbers[n] for n in NAMES if n not in limits}
    result["checks"] = {n: {"value": numbers[n], "limit": limits[n]} for n in NAMES
                        if n in limits}
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    info = load_cell(args.workload)
    import torch

    chips = info["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # the kernel caches live at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    torch.set_num_threads(1)  # the step's host work is one thread's dispatch
    device = torch.device("cuda", 0)
    result = run_cell(info, args.seed, args.seconds, bool(args.trace), device,
                      torch.cuda.get_device_name(device), T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 4
    where = result.pop("where")
    reported = "".join(f", {n} {v!r}" for n, v in where["reported"].items())
    print(f"grad_worst read at {where['grad_at']}; not compared: the worst change "
          f"{where['change_worst']!r} at {where['change_at']}{reported}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
