"""The training runner: ``RankingTrainer._train_step`` on batches placed
on the device before the window (traffic kind ``train``).

A run, in order:

1. set-up: the trainer, the weights drawn from the seed and handed to
   ``init_state(params=...)``, ``placed_batches`` batches drawn from the
   seed; the first ``CHECKED_STEPS`` steps on the first batches (the window's
   own call and feed), with the readings the comparison takes, then
   ``warm_steps`` more and a host fetch of the loss;
2. the window: steps on the placed batches in turn until ``seconds`` have
   passed, ended by a host fetch of the last loss (the barrier); every step
   dispatched in it is counted, and its time runs to the barrier;
3. with a trace: ``profiled_steps`` steps under a device-only profile (busy
   and idle time, launches), then ``ATTRIBUTED_STEPS`` under a profile with
   Python stacks (device time by source, the breakdown);
4. the device's peak memory, then the program's state freed, then the plain
   reference over the checked steps from the same weights and batches.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import tempfile
import time
from typing import Dict, Mapping, Optional

import torch

from perfbench.reference.onetrans import F32Ops, reference_steps
from perfbench.yardstick import trace as trace_lib
from perfbench.yardstick.batches import make_batches
from perfbench.yardstick.compare import gaps
from perfbench.yardstick.flops import model_flops
from perfbench.yardstick.model_shapes import param_specs, s_length, table_names
from perfbench.yardstick.weights import make_weights

# the steps compared with the reference (every limit under limits/ was set
# from readings of these three), and the steps profiled with Python stacks
CHECKED_STEPS = 3
ATTRIBUTED_STEPS = 2


def log(t_start: float, what: str) -> None:
    """A progress line on standard error, seconds since the process began."""
    print(f"[perfbench {time.time() - t_start:8.2f} s] {what}", file=sys.stderr, flush=True)


def build(cfg: Mapping, traffic: Mapping, seed: int, device, t_start: Optional[float] = None):
    """(trainer, state, batches) with the seed's weights and batches."""
    def mark(what):
        if t_start is not None:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            log(t_start, what)

    torch.zeros((), device=device)
    from recommend_tpu_torch.config import RankingConfig
    from recommend_tpu_torch.training.ranking_trainer import RankingTrainer

    mark("the device's context and the program's modules")
    rcfg = RankingConfig.from_dict({**cfg, "batch_size": traffic["batch_size"]})
    trainer = RankingTrainer(rcfg, device=device)
    mark("the trainer")
    specs = param_specs(cfg)
    shapes = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
    if shapes != {n: s.shape for n, s in specs.items()}:
        raise RuntimeError("the program's parameters are not the ones the benchmark draws")
    weights = make_weights(cfg, seed, device)
    mark("the weights drawn")
    state = trainer.init_state(params={n: weights[n] for n in shapes})
    del weights
    mark("init_state")
    batches = make_batches(cfg, traffic, seed, device)
    mark("the batches drawn")
    return trainer, state, batches


@torch.no_grad()
def _first_readings(state, cfg: Mapping, seed: int, device):
    """(per parameter, the first gradient as the optimizer took it, from the
    state one step on: a dense parameter's rmsprop ``nu`` (0.1 g^2 after
    one step from zeros), a table's change over the step (row-wise adagrad
    moves a row by sparse_lr g / sqrt(~0.1)); per table, the rows the step
    moved)."""
    params = state.params
    nu = state.opt_state[0]["dense"]["nu"]
    first, rows = {}, {}
    t0 = make_weights(cfg, seed, device, tables_only=True)
    tables = set(table_names(cfg))
    for n in params:
        if n in tables:
            first[n] = (params[n] - t0[n]).norm() * (math.sqrt(0.1) / cfg["sparse_lr"])
            rows[n] = (params[n] != t0[n]).any(-1).sum()
        else:
            first[n] = torch.sqrt(nu[n].sum() / 0.1)
    return first, rows


def checked_steps(trainer, state, batches, cfg: Mapping, seed: int, steps: int, device):
    """The first ``steps`` steps, each on its own batch, and the program's
    readings of them (``reference_steps``' layout)."""
    if not (cfg["use_sparse_embedding_updates"] and set(table_names(cfg)) <= set(state.params)):
        raise ValueError("the checked readings need the touched-row table updates")
    losses, first, rows = [], None, None
    for k in range(steps):
        state, m = trainer._train_step(state, batches[k])
        losses.append(m["loss"])
        if k == 0:
            first, rows = _first_readings(state, cfg, seed, device)
    with torch.no_grad():
        p0 = make_weights(cfg, seed, device)
        change = {n: (state.params[n] - p0[n]).norm() for n in state.params}
        del p0
    readings = {"loss": [float(v) for v in losses],
                "first": {n: float(v) for n, v in first.items()},
                "rows": {n: int(v) for n, v in rows.items()},
                "change": {n: float(v) for n, v in change.items()}}
    return state, readings


def program_readings(cfg: Mapping, traffic: Mapping, seed: int, device) -> Dict:
    """The program's readings of the checked steps alone, its state freed
    after them."""
    trainer, state, batches = build(cfg, traffic, seed, device)
    state, readings = checked_steps(trainer, state, batches, cfg, seed, CHECKED_STEPS,
                                    device)
    del trainer, state, batches
    _free(device)
    return readings


def reference_readings(cfg: Mapping, traffic: Mapping, seed: int, device, ops=None,
                       rows: slice = slice(None)) -> Dict:
    """The reference's readings of the checked steps from the seed's
    weights and batches (``rows`` of each batch; ``ops``: its products)."""
    # drawn as the run draws them (the same calls), the checked ones kept
    batches = make_batches(cfg, traffic, seed, device)[:CHECKED_STEPS]
    batches = [{g: {k: v[rows] for k, v in b[g].items()} for g in b} for b in batches]
    return reference_steps(make_weights(cfg, seed, device), cfg, batches, ops or F32Ops())


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _profile(trainer, state, batches, steps: int, start: int, stacks: bool, path: str):
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if stacks:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts, with_stack=stacks) as prof:
        for i in range(steps):
            state, m = trainer._train_step(state, batches[(start + i) % len(batches)])
        float(m["loss"])
    prof.export_chrome_trace(path)
    del prof
    return state


def _traced(trainer, state, batches, traffic: Mapping, start: int):
    """(the per-layer readings of a device-only profile and of a profile
    with stacks, the state after them); the trace files are deleted once
    read."""
    out = {}
    tmp = tempfile.mkdtemp(prefix="perfbench-trace-")
    try:
        path = os.path.join(tmp, "device.json")
        k = traffic["profiled_steps"]
        state = _profile(trainer, state, batches, k, start, False, path)
        rows = trace_lib.load_events(path)["events"]
        out["profile"] = {"steps": k, "launches": len(rows), **trace_lib.busy_and_window(rows)}
        os.remove(path)
        path = os.path.join(tmp, "stacks.json")
        k2 = ATTRIBUTED_STEPS
        state = _profile(trainer, state, batches, k2, start + k, True, path)
        loaded = trace_lib.load_events(path)
        os.remove(path)
        out["sources"] = trace_lib.by_source(loaded["events"], k2)
        out["attributed_steps"] = k2
        out["breakdown"] = {
            "device_ops": trace_lib.top(((r["source"], r["dur"] * 1e-6)
                                         for r in loaded["events"]), k2),
            "idle_gaps": trace_lib.top(loaded["idle"], k2),
        }
    finally:
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        os.rmdir(tmp)
    return out, state


def run(cfg: Mapping, traffic: Mapping, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> Dict:
    """One run of a training cell; returns what the harness reports:
    ``setup_s``, the window's ``steps``, ``seconds`` and ``examples``,
    ``failed`` (steps whose loss was not finite), ``memory_peak_bytes``, the
    trace's readings when traced, and the program's and the reference's
    readings with their ``numbers``."""
    cuda = torch.device(device).type == "cuda"
    log(t_start, "imports done")
    trainer, state, batches = build(cfg, traffic, seed, device, t_start)
    checked = CHECKED_STEPS
    state, program = checked_steps(trainer, state, batches, cfg, seed, checked, device)
    log(t_start, f"{checked} checked steps")
    nb = len(batches)
    m = None
    for i in range(traffic["warm_steps"]):
        state, m = trainer._train_step(state, batches[(checked + i) % nb])
    if m is not None:
        float(m["loss"])
    start = checked + traffic["warm_steps"]

    log(t_start, f"{traffic['warm_steps']} warm steps; the window opens")
    losses, dispatched = [], []
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    while True:
        state, m = trainer._train_step(state, batches[(start + len(losses)) % nb])
        losses.append(m["loss"])
        dispatched.append(time.perf_counter() - t0)
        if dispatched[-1] >= seconds:
            break
    float(m["loss"])
    window_s = time.perf_counter() - t0
    steps = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    del losses, m
    out = {"setup_s": setup_s, "steps": steps, "seconds": window_s,
           "examples": steps * traffic["batch_size"], "failed": failed,
           "s_len": s_length(cfg, traffic["seq_len"])}
    out["flops_per_step"] = model_flops(cfg, out["s_len"]) * traffic["batch_size"]
    quarters = [sum(1 for t in dispatched if q * seconds / 4 <= t < (q + 1) * seconds / 4)
                for q in range(4)]
    log(t_start, f"the window closed: {steps} steps in {window_s:.3f} s "
                 f"(dispatched in its quarters: {quarters})")
    if trace:
        from recommend_tpu_torch.ops.flash_attention import LAUNCHES

        log(t_start, f"band-attention launches over the run's {start + steps} steps: "
                     f"{ {k: v for k, v in LAUNCHES.items() if v} }")
        traced, state = _traced(trainer, state, batches, traffic, start + steps)
        out.update(traced)
        log(t_start, "traces taken and read")
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0

    del trainer, state, batches
    _free(device)
    reference = reference_readings(cfg, traffic, seed, device)
    log(t_start, "the reference's steps")
    out["program"], out["reference"] = program, reference
    out["numbers"] = gaps(program, reference)
    return out
