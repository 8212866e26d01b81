#!/usr/bin/env python3
"""Where a step on a 1 x 1 NCCL mesh spends the time it adds, on one H100.

    python3 profile_mesh.py            # from the repository root; one card

Builds the kernels, initializes one NCCL rank in-process (a ``file://``
store under build/) and ``make_mesh()``, then:

1. one bf16 ``RetrievalTrainer`` step at ``retrieval_flagship`` (10M-row
   video table, ``make_retrieval_data`` from 200 users) without and with the
   mesh from one state: the largest difference of each gradient and
   parameter between the two (the plain path run twice shows its own
   determinism);
2. TA's ``RankingTrainer`` step and that retrieval step, without and with
   the mesh in turns (plain, mesh, plain, mesh; 20 steps each after 3),
   host clock, each step ending in reading its loss;
3. a ``torch.profiler`` trace of 3 retrieval steps each way: device busy,
   the collectives a step and their host time.

Run it once as is and once under ``TORCH_NCCL_ASYNC_ERROR_HANDLING=0
TORCH_NCCL_ENABLE_MONITORING=0`` to see the share of NCCL's watchdog. Every
line names the card and its power limit.
"""

from __future__ import annotations

import os
import shutil
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

VOCAB = 10_000_000
USERS = 200
STEPS, WARMUP = 20, 3


def _retrieval_diffs(cfg, host, params, mesh):
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    runs = {}
    for label, m in (("plain", None), ("plain again", None), ("mesh", mesh)):
        tr = RetrievalTrainer(cfg, device=None if m else "cuda", mesh=m)
        st = tr.init_state(params)
        grads = {}
        step = tr.optimizer.step

        def spy(p, g, s, step=step):
            grads.update({k: v.detach().float().cpu() for k, v in g.items()})
            return step(p, g, s)

        tr.optimizer.step = spy
        st, _ = tr._train_step(st, tr._put_batch(host[0]), torch.Generator().manual_seed(0))
        runs[label] = (grads, {k: v.detach().float().cpu() for k, v in st.params.items()})
        del tr, st
        torch.cuda.empty_cache()
    g0, p0 = runs["plain"]
    for label in ("plain again", "mesh"):
        g, p = runs[label]
        gd = max((float((g[k] - g0[k]).abs().max()), k) for k in g)
        pd = max((float((p[k] - p0[k]).abs().max()), k) for k in p)
        cs.log(f"bf16 retrieval step, {label} vs plain: largest gradient difference "
               f"{gd[0]:.3e} ({gd[1]}), parameter {pd[0]:.3e} ({pd[1]}) [{cs.CARD}]")


def _turns(label, make, host, params, mesh):
    times = {"plain": [], "mesh": []}
    for side, m in (("plain", None), ("mesh", mesh), ("plain", None), ("mesh", mesh)):
        tr = make(m)
        st = tr.init_state(params)
        batches = [tr._put_batch(b) for b in host]
        gen = torch.Generator().manual_seed(0)
        for i in range(WARMUP + STEPS):
            t = time.perf_counter()
            st, met = tr._train_step(st, batches[i % len(batches)], gen)
            float(met["loss"])
            if i >= WARMUP:
                times[side].append((time.perf_counter() - t) * 1e3)
        del tr, st, batches
        torch.cuda.empty_cache()
    cs.log(f"{label} step in turns: p50 {np.median(times['plain']):.3f} ms without, "
           f"{np.median(times['mesh']):.3f} ms with the mesh (n={2 * STEPS} each) [{cs.CARD}]")


def _trace(make, host, params, mesh):
    from torch.profiler import ProfilerActivity, profile

    for side, m in (("plain", None), ("mesh", mesh)):
        tr = make(m)
        st = [tr.init_state(params)]
        batch = tr._put_batch(host[0])
        gen = torch.Generator().manual_seed(0)

        def step():
            st[0], met = tr._train_step(st[0], batch, gen)
            float(met["loss"])

        for _ in range(WARMUP):
            step()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        busy = sum(e.self_device_time_total for e in ev) / 1e3 / 3
        comms = [e for e in ev if e.key.startswith("c10d::")]
        n = sum(e.count for e in comms) / 3
        host_ms = sum(e.cpu_time_total for e in comms) / 1e3 / 3
        cs.log(f"retrieval step traced, {side}: device busy {busy:.3f} ms, {n:.0f} collectives "
               f"a step ({', '.join(f'{e.key} {e.count // 3}' for e in comms) or 'none'}), "
               f"{host_ms:.3f} ms of host time in them [{cs.CARD}]")
        del tr, st
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_mesh: no CUDA device", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from recommend_tpu_torch.config import get_config
    from recommend_tpu_torch.convert import init_params, init_retrieval_params
    from recommend_tpu_torch.data.pipeline import ranking_batches, retrieval_batches
    from recommend_tpu_torch.data.synthetic import make_ranking_data, make_retrieval_data
    from recommend_tpu_torch.ops import _build
    from recommend_tpu_torch.parallel import make_mesh, multihost_init
    from recommend_tpu_torch.training.ranking_trainer import RankingTrainer
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = cs.card_line()
    env = {k: v for k, v in os.environ.items() if k.startswith("TORCH_NCCL")}
    cs.log(f"{cs.CARD}; torch {torch.__version__}; NCCL settings {env or 'defaults'}")
    _build.build_all()
    shutil.rmtree(cs.P_DIR, ignore_errors=True)
    cs.P_DIR.mkdir(parents=True)
    multihost_init(init_method=f"file://{cs.P_DIR}/store", world_size=1, rank=0)
    mesh = make_mesh()

    cfg = get_config("retrieval_flagship", video_vocab_size=VOCAB)
    data = make_retrieval_data(cfg, num_users=USERS, num_videos=VOCAB, seed=cs.SEED)
    it = retrieval_batches(data, cfg, batch_size=cfg.batch_size, seed=cs.SEED)
    r_host = [next(it) for _ in range(4)]
    r_params = init_retrieval_params(cfg, seed=cs.SEED, device="cuda")
    _retrieval_diffs(cfg, r_host, r_params, mesh)

    def retrieval(m):
        return RetrievalTrainer(cfg, device=None if m else "cuda", mesh=m)

    t_cfg = cs.training_config(2, 512)
    t_data = make_ranking_data(t_cfg, num_samples=2048, max_seq_per_feature=cs.SG_ITEMS,
                               seed=cs.SEED)
    it = ranking_batches(t_data, t_cfg, batch_size=512, seed=cs.SEED)
    t_host = [next(it) for _ in range(4)]
    t_params = init_params(t_cfg, seed=cs.SEED, device="cuda")
    _turns("TA ranking", lambda m: RankingTrainer(t_cfg, device=None if m else "cuda", mesh=m),
           t_host, t_params, mesh)
    _turns("retrieval_flagship", retrieval, r_host, r_params, mesh)
    _trace(retrieval, r_host, r_params, mesh)
    dist.destroy_process_group()
    shutil.rmtree(cs.P_DIR)
    return 0


if __name__ == "__main__":
    sys.exit(main())
