#!/usr/bin/env python3
"""Where a ranking training step's time goes on the card, per chip_smoke
training phase.

    python3 profile_training.py     # from the repository root; one CUDA card

    python3 profile_training.py TB SG   # only the phases named

For each of chip_smoke's training phases (TA, TB, TC: same configs, weights
and batches) it warms the trainer, times train steps unprofiled (median on
the host clock, each step ending in a synchronize), then traces a few with
``torch.profiler`` and prints per step: the unprofiled wall time, the
profiled wall time, device busy time (the sum of kernel times in the trace),
the card's idle share against the unprofiled wall time, the number of
kernels launched, the band-attention kernels' device time, and the kernels
that took most device time. Then the same for one pass of chip_smoke's
phase SG (the S-trunk gradient at TA's widths and traffic).
"""

from __future__ import annotations

import sys

import torch

import chip_smoke
from profile_serving import measure
from recommend_tpu_torch.convert import init_params
from recommend_tpu_torch.data.pipeline import ranking_batches
from recommend_tpu_torch.data.synthetic import make_ranking_data
from recommend_tpu_torch.training.ranking_trainer import RankingTrainer

N_STEPS = (20, 3)  # steps per measurement: (unprofiled, traced)


def main(phases) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line())
    for label, heads, items, batch_size, _ in chip_smoke.TRAIN_PHASES:
        if phases and label not in phases:
            continue
        cfg = chip_smoke.training_config(heads, batch_size)
        data = make_ranking_data(cfg, num_samples=4 * batch_size,
                                 max_seq_per_feature=items, seed=chip_smoke.SEED)
        it = ranking_batches(data, cfg, batch_size=batch_size, seed=chip_smoke.SEED)
        trainer = RankingTrainer(cfg, device="cuda")
        state = trainer.init_state(init_params(cfg, seed=chip_smoke.SEED, device="cuda"))
        batches = [trainer._put_batch(next(it)) for _ in range(4)]

        def step():
            nonlocal state
            state, _ = trainer._train_step(state, batches[state.step % len(batches)])

        for _ in range(chip_smoke.N_TRAIN_WARMUP):
            step()
        measure(label, "train step", step, N_STEPS)
        del trainer, state, batches
        torch.cuda.empty_cache()
    if not phases or "SG" in phases:
        cfg = chip_smoke.training_config(2, chip_smoke.SG_BATCH)
        model_for, names, seqs, sv, noise = chip_smoke.s_trunk_inputs(
            cfg, chip_smoke.SG_ITEMS, chip_smoke.SG_BATCH)
        model = model_for(cfg)

        def grad_pass():
            chip_smoke.s_trunk_grads(model, names, seqs, sv, noise)

        grad_pass()
        measure("SG", "S-trunk backward", grad_pass, N_STEPS)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
