"""The retrieval training runner: ``RetrievalTrainer._train_step`` in the
traffic's ``mode`` on batches placed on the device before the window
(traffic kind ``retrieval_train``).

A run keeps ``workloads/train.py``'s protocol step for step:

1. set-up: the trainer, the weights drawn from the seed
   (``yardstick/retrieval_inputs.py``) and handed to
   ``init_state(params=...)``, ``placed_batches`` batches drawn from the
   seed on the device and put through ``_put_batch``; the first
   ``CHECKED_STEPS`` steps on the first batches, with the readings the
   comparison takes, then ``warm_steps`` more and a host fetch of the loss;
2. the window: steps on the placed batches in turn until ``seconds`` have
   passed, ended by a host fetch of the last loss; every step dispatched
   in it is counted, and its time runs to the barrier;
3. with a trace: ``profiled_steps`` steps under a device-only profile, then
   ``ATTRIBUTED_STEPS`` under a profile with Python stacks
   (``train._traced``); the device's peak memory; then the span phase on
   the run's own trainer and state (``yardstick/retrieval_spans.py``),
   whose readings go into the output as ``spans``;
4. the program's state freed, then the plain reference
   (``reference/kuaiformer.py``) over the checked steps from the same
   weights and batches.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Mapping, Optional

import torch

from perfbench.reference.kuaiformer import F32Ops, reference_steps
from perfbench.workloads.train import ATTRIBUTED_STEPS, CHECKED_STEPS, _free, _traced, log
from perfbench.yardstick.compare import gaps
from perfbench.yardstick.retrieval_flops import model_flops
from perfbench.yardstick.retrieval_inputs import make_batches, make_weights, to_host
from perfbench.yardstick.retrieval_shapes import param_specs, table_names

# the length of adamw's warmup-cosine schedule: the trainer's default,
# which the reference follows too
TOTAL_STEPS = 100_000


def build(cfg: Mapping, traffic: Mapping, seed: int, device, t_start: Optional[float] = None):
    """(trainer, state, batches) with the seed's weights and batches."""
    def mark(what):
        if t_start is not None:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            log(t_start, what)

    torch.zeros((), device=device)
    from recommend_tpu_torch.config import RetrievalConfig
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    mark("the device's context and the program's modules")
    rcfg = RetrievalConfig.from_dict({**cfg, "batch_size": traffic["batch_size"]})
    trainer = RetrievalTrainer(rcfg, total_steps=TOTAL_STEPS, mode=traffic["mode"],
                               device=device)
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
    batches = [trainer._put_batch(to_host(b)) for b in make_batches(cfg, traffic, seed, device)]
    mark("the batches drawn and put")
    return trainer, state, batches


@torch.no_grad()
def _first_readings(state, cfg: Mapping, seed: int, device):
    """(per parameter, the first gradient as the optimizer took it, from the
    state one step on: a dense parameter's adamw ``nu``, (1 - b2) g^2 after
    one step from zeros; a table's change over the step, times sqrt(0.1) /
    sparse lr; per table, the rows the step moved)."""
    params = state.params
    nu = state.opt_state[0]["nu"]
    first, rows = {}, {}
    t0 = make_weights(cfg, seed, device, tables_only=True)
    tables = set(table_names(cfg))
    for n in params:
        if n in tables:
            first[n] = ((params[n] - t0[n]).norm()
                        * (math.sqrt(0.1) / cfg["sparse_embedding_lr"]))
            rows[n] = (params[n] != t0[n]).any(-1).sum()
        else:
            first[n] = torch.sqrt(nu[n].sum() / (1 - cfg["adam_b2"]))
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
    def cut(x):
        return {k: cut(v) for k, v in x.items()} if isinstance(x, Mapping) else x[rows]

    batches = [cut(b) for b in make_batches(cfg, traffic, seed, device)[:CHECKED_STEPS]]
    return reference_steps(make_weights(cfg, seed, device), cfg, batches, ops or F32Ops(),
                           TOTAL_STEPS, traffic["mode"])


def run(cfg: Mapping, traffic: Mapping, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> Dict:
    """One run of a retrieval training cell; returns what the harness
    reports: ``setup_s``, the window's ``steps``, ``seconds`` and
    ``examples``, ``failed`` (steps whose loss was not finite),
    ``flops_per_step``, ``memory_peak_bytes``, the trace's readings and the
    span phase's ``spans`` when traced, and the program's and the
    reference's readings with their ``numbers``."""
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
           "flops_per_step": model_flops(cfg, traffic["batch_size"], traffic["mode"])
           * traffic["batch_size"]}
    quarters = [sum(1 for t in dispatched if q * seconds / 4 <= t < (q + 1) * seconds / 4)
                for q in range(4)]
    log(t_start, f"the window closed: {steps} steps in {window_s:.3f} s "
                 f"(dispatched in its quarters: {quarters})")
    start += steps
    if trace:
        traced, state = _traced(trainer, state, batches, traffic, start)
        out.update(traced)
        start += traffic["profiled_steps"] + ATTRIBUTED_STEPS
        log(t_start, "traces taken and read")
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        from perfbench.yardstick.retrieval_spans import run_phase

        out["spans"], state = run_phase(trainer, state, batches, start, device)
        log(t_start, "the span phase")

    del trainer, state, batches
    _free(device)
    reference = reference_readings(cfg, traffic, seed, device)
    log(t_start, "the reference's steps")
    out["program"], out["reference"] = program, reference
    out["numbers"] = gaps(program, reference)
    return out
