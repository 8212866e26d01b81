#!/usr/bin/env python3
"""Where the retrieval path's time goes on the card.

    python3 profile_retrieval.py [OTHER_ROOT]   # from the repository root; one CUDA card

1. The corpus scans, ``topk_retrieval`` and ``topk_retrieval_quantized``, at
   ``chip_smoke.py`` phase R's shapes (a 10M x 128 bf16 corpus and its int8
   copy, drawn from a seed; batch 1 and 64, top 100), timed with CUDA events.
   With OTHER_ROOT (another checkout, e.g. the parent commit unpacked with
   ``git archive`` under ``build/``) its ``ops/topk.py`` runs beside this
   tree's, in turns (other, this, this, other), and the two results are
   compared; then a ``torch.profiler`` table of this tree's batch-64 scan.
2. The retrieval trainer's step at phase RT's config (``retrieval_flagship``:
   the 10M-row video table, batch 256, bf16, dropout 0.1, rowwise sparse
   updates at its 16,384-row scatter budget, single mode): unprofiled wall
   p50, device busy, idle share, kernels per step and the kernels that took
   most device time (``profile_serving.measure``).
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch

import chip_smoke
from profile_serving import measure
from recommend_tpu_torch.config import get_config
from recommend_tpu_torch.data.pipeline import retrieval_batches
from recommend_tpu_torch.data.synthetic import make_retrieval_data
from recommend_tpu_torch.ops import topk
from recommend_tpu_torch.training.trainer import RetrievalTrainer

N_CALLS = 20  # scans per timing
TRAIN_USERS = 40  # ~1,000 examples: four batches of 256
N_STEPS = (20, 3)  # train steps per measurement: (unprofiled, traced)


def scans(other_root) -> None:
    other = None
    if other_root:
        path = Path(other_root) / "recommend_tpu_torch" / "ops" / "topk.py"
        spec = importlib.util.spec_from_file_location("other_topk", path)
        other = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(other)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    items = torch.randn(chip_smoke.R_CORPUS, 128, device="cuda", generator=gen).bfloat16()
    ints = torch.randn(chip_smoke.R_BATCH, 4, 128, device="cuda", generator=gen).bfloat16()
    q_items, q_scales = topk.quantize_corpus(items)
    k = chip_smoke.R_TOPK
    for tag, x in (("batch 1", ints[:1]), (f"batch {len(ints)}", ints)):
        for label, scan in (
                ("flat", lambda m, x=x: m.topk_retrieval(x, items, k)),
                ("int8", lambda m, x=x: m.topk_retrieval_quantized(x, q_items, q_scales, k))):
            if other is None:
                print(f"{label} scan, {tag}: {chip_smoke.cuda_ms(lambda: scan(topk), N_CALLS):.3f}"
                      f" ms (n={N_CALLS})")
                continue
            (s0, i0), (s1, i1) = scan(other), scan(topk)
            same = torch.equal(s0, s1) and torch.equal(i0, i1)
            ms = {"other": [], "this": []}
            for name, m in (("other", other), ("this", topk), ("this", topk), ("other", other)):
                ms[name].append(chip_smoke.cuda_ms(lambda: scan(m), N_CALLS))
            print(f"{label} scan, {tag}: other {', '.join(f'{t:.3f}' for t in ms['other'])} ms, "
                  f"this {', '.join(f'{t:.3f}' for t in ms['this'])} ms (n={N_CALLS} each), "
                  f"results {'equal' if same else 'DIFFER'}", flush=True)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            topk.topk_retrieval(ints, items, k)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))


def train_step() -> None:
    cfg = get_config("retrieval_flagship")
    data = make_retrieval_data(cfg, num_users=TRAIN_USERS, num_videos=cfg.video_vocab_size,
                               seed=chip_smoke.SEED)
    it = retrieval_batches(data, cfg, batch_size=cfg.batch_size, seed=chip_smoke.SEED)
    trainer = RetrievalTrainer(cfg, device="cuda")
    state = trainer.init_state(seed=chip_smoke.SEED)
    batches = [trainer._put_batch(next(it)) for _ in range(4)]
    gen = torch.Generator().manual_seed(chip_smoke.SEED)

    def step():
        nonlocal state
        state, _ = trainer._train_step(state, batches[state.step % len(batches)], gen)

    for _ in range(chip_smoke.N_TRAIN_WARMUP):
        step()
    measure("RT", "train step", step, N_STEPS)


def main(argv) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.CARD = chip_smoke.card_line()
    print(chip_smoke.CARD, flush=True)
    scans(argv[0] if argv else None)
    train_step()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
