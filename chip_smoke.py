#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (recommend_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order; any failure raises and exits non-zero:

1. print the card's name and power limit (nvidia-smi);
2. build the band-attention kernels from csrc/ with nvcc (sm_90a), one
   nvcc per source, all at once;
3. hold each of the four forward kernels against its plain PyTorch version
   at the serving shapes (the blocked kernel also at every other Dh, the bh
   kernel first at training phase TC's layer 0, then at the serving
   shapes, Dh 96 (ranking_base's head width), the edges of its tiling and
   every other Dh, the mh kernel first at the S-trunk gradient's shapes,
   and the segmented kernel also at Dh 64 and 48 and at small shapes that
   reach each edge of its tiling), in bf16 and f32 (every bf16 call runs
   the tensor-core kernel, every f32 call the CUDA-core one), and time
   kernel, plain version and ``F.scaled_dot_product_attention`` (a
   yardstick the port never calls) with CUDA events, beside the kernel's
   bound; then the same for the five backward kernels at the training
   shapes (B3b at the S-trunk gradient's shapes), against their plain
   backward and SDPA's backward (the bf16 calls run the tensor-core passes:
   B1b, B3b and B4b both, B2dq and B2dkv one each; also at small shapes
   that reach each edge of their tiling, B1b and B3b at Dh 64, 96, 48 and
   16 as well, B2dq and B2dkv at Dh 64 and 96, and B4b at every Dh);
4. serve three engines at full OneTrans-S width (random weights from a
   seed): A (2 heads, 64-item window), B (2 heads, 400-item window, the long
   history) and C (4 heads), each 400 requests of 100 candidates and 20
   batch forwards of 100 rows, timed on the host clock around each call
   (p50 and p99, with the count beside them). Each checks the KV-cache
   invariant (``score_request`` against the full forward per candidate, in
   bf16 and in float32), the kernels against the plain attention path end
   to end (bf16 and float32: ``score_request`` and ``batch_inference`` of an
   engine built with ``use_flash_attention=False`` on the same weights), and
   that each kernel's launch count moved exactly as its phase predicts;
5. train at bench.py's OneTrans-S widths (``RankingTrainer``, rowwise sparse
   adagrad, rmsprop with momentum, bf16, dropout 0, random weights from a
   seed): TA (bench.py's exact config), TB (400 items per sequence, the
   blocked kernels at layer 0) and TC (4 heads, Dh 64), each a few warm-up
   steps and N_TRAIN timed steps on the host clock (p50, p99, n, examples/s,
   the losses). Each asserts a finite loss at every step, its launch counts
   exactly, and, on one batch, that one step through the kernels agrees
   with one step through the plain attention path: in float32 (loss, dense
   gradient norm, table updates) and in bf16 (loss, dense gradient norm);
6. SG, the S-trunk gradient: at TA's widths and traffic (2 heads, Dh 128,
   116 items per sequence, batch 512, bf16), N_SG backward passes of a
   scalar of ``encode_s``'s cache through a ``RankingModel`` whose dense
   parameters require grad; asserts the model-layout kernels' launch counts
   (B3f and B3b once per pass in every layer keeping >= 64 S rows) and, in
   float32 and in bf16, the gradient norm through the kernels against the
   plain path;
7. S, the cross-request session cache at the JAX serving bench's config
   (examples/serving_bench.py: 4 heads, Dh 64, window 64, 48 items per
   sequence, 100 candidates, Δ-mix 1/2/4/8, the deployment profile with
   ``maintain()`` between pairs, outside the timers): N_SESSION_PAIRS
   interleaved ``score_request`` / ``score_session`` pairs on one session
   after ``warmup``, timed on the host clock (p50/p99 with n, the paired
   delta, the session's win fraction); asserts the encode launches exactly,
   ``score_session`` against ``score_request`` at a re-anchor (bf16 and
   float32) and, without pruning, a refresh/append/fold/append chain
   against ``score_request`` in float32;
8. K, the deployment loop at TA's config (dropout 0.1): a ``RankingTrainer``
   with ``checkpoint_dir`` (under build/, two kept) and a ``PushTracker``
   takes 2 steps and saves; engine E0 starts ``from_checkpoint`` and opens
   sessions; a new trainer restores step 2 and trains to step 4, held
   against an unbroken 0-4 run (loss 1e-6 relative, every parameter 1e-5 of
   its largest |value|; the sums run in a fixed order, so 0 is expected); the push
   of steps 2->4 makes E0's state dict equal the step-4 checkpoint's bit for
   bit, its requests the step-4 engine's (1e-6) and its refreshed sessions
   its requests (bf16, 1e-2); a push with a wrong shape raises and leaves
   E0's scores as they were. Prints checkpoint and push bytes and seconds,
   then deletes the checkpoints;
9. D: ``RankingTrainer(model=DINRankingModel(cfg))`` at the same config (3
   warm-up and N_DIN timed steps, finite loss, no kernel launch), one
   float32 DIN step on the card against the CPU at batch 32 (1e-5);
   ``RankingEvaluator.evaluate`` of DIN and of K's step-4 OneTrans on the same
   4 validation batches (AUC, UAUC, throughput); ``latency_benchmark`` of
   ``score_request``; TA's MFU against the H100's dense bf16 peak;
10. R, retrieval serving at the JAX package's flagship serving row
    (examples/flagship_serving_bench.py: ``retrieval_flagship``, dropout 0,
    top 100, a 10M-item corpus, random weights from a seed, bf16; no
    band-attention kernel runs, and the counts are held at 0): the flat
    index built through the item tower in batches of 8192; searches of the
    flat, int8 and int8 + ``approx_recall=0.99`` (exact here) variants at
    batch 1 and 64 (p50, QPS, top-100 recall against the exact scan; the
    int8 variants take the flat index's corpus by assignment, as the JAX
    script does, and their recall is gated at 0.97), the single request
    end to end; an IVF index (4096 clusters, capacity 2.5x
    the mean, int8, 5 iterations) searched with nprobe 16 in query chunks of
    16 users; ``RealTimeRecommender`` (200 requests, ``similar_to``, an
    ``update_items`` append, ``refresh``); ``RetrievalEvaluator`` on a
    100k-video corpus. Gates: the float32 tower on the card against the CPU
    (1e-5 of max|ref|); the chunked flat and int8 scans against one-shot
    scans (the same top-100 id sets, scores 1e-6 relative); at 100k items
    and 256 clusters a full-probe IVF search against the flat scan and two
    builds bit-equal; no seen item recommended, and the recommender's scores
    those of ``index.search``; the flat index stays for RT;
11. RT, the retrieval trainer at ``retrieval_flagship`` (full widths, the
    10M-row video table, rowwise sparse updates at a 16,384-row scatter
    budget, batch 256, bf16, dropout 0.1, single mode; random weights from a
    seed; 10 batches of ``make_retrieval_data`` from 200 users, cycled; no
    band-attention kernel, the counts held at 0). Gates: one float32 step
    (dropout 0, the video table cut to 100k rows) of each mode, single,
    seq2seq and masked (the masked positions handed to both), on the card
    against the CPU from one state (loss 1e-5, grad norm 1e-4 relative,
    each dense gradient 1e-4 of its tensor's largest, parameters, tables and
    accumulators 1e-5 / 1e-4, the parameters against adamw of the card's
    own gradients: see the constants of phase RT); three steps of
    ``train()`` run twice from one seed bit-equal; at the 100k cut a run
    resumed from a step-2 checkpoint (under build/, deleted) bit-equal to
    an unbroken one at step 4;
    ``sparse_dropped_rows`` 0; the state of ``train()`` handed to phase R's
    flat index through ``refresh``: the corpus and the batch-1 and batch-64
    top 100 (ids and scores) bit-equal to an index built fresh from it.
    Prints, not gated: step p50/p99 and examples/s (N_TRAIN steps after
    N_TRAIN_WARMUP, host clock, each ending in reading its loss) at the
    preset's budget and at 0, and their ratio; device busy, idle share and
    kernels per step from a ``torch.profiler`` trace of 3 steps; peak memory
    allocated; IVF recall@100 at nprobe 16 after the refresh; returns its
    data for L and N;
12. L, LLM4Rec: the semantic-distillation student at its own widths (teacher
    768, hidden 256, 4 heads x 32) on 4,096 seeded teacher vectors: one
    float32 forward + loss + backward on the card against the CPU (loss 1e-5
    relative, each gradient 1e-4 of its tensor's largest), then N_TRAIN
    timed passes; ``build_semantic_ids`` (1024 clusters, 10 iterations) twice
    over phase R's 10M item vectors but the last 1,000, bit-equal (the
    retrieval tower's vectors stand in for LLM item embeddings), ``assign``
    of the 1,000 held-back items (each at its nearest centroid),
    ``map_ids`` with the padding sentinel, ``remap_retrieval_data`` of RT's
    data and N_TRAIN timed ``RetrievalTrainer`` steps over the semantic
    vocabulary (1,025 ids, batch 256, bf16, single mode); then phase R's
    index is freed, and a stub LLM (replies from a hash of the prompt, no
    model downloaded) through ``IntentPromptGenerator``, whose axis encoder
    is the student's user-tower head of each axis on a per-label teacher
    vector, fills an ``IntentCache`` (10,000 users precomputed, then hits,
    synchronous misses and stale entries, their counts asserted), whose
    ``batch_get`` gives the ``user_intent`` [512, 128] of ``RankingTrainer``
    steps at phase TA's config: the intent reaches the trainer as float32
    and moves the logits, N_TRAIN timed bf16 steps with their B1f/B1b
    launches counted, a trace, and a float32 kernels-vs-plain step at TA's
    tolerances;
13. N, the data layer: the port's C++ batcher built with g++ (timed), RT's
    data batched at ``retrieval_flagship`` by the native and the numpy path
    (N_BATCHES each, bit-equal, batches per second), ``AliasSampler``'s
    draws against its probabilities (chi-square), ``make_ml1m_replica`` at
    full scale and ``make_onetrans_replica`` at its defaults (seconds and
    sizes);
14. P, the mesh paths (``parallel/``) at world size 1: one NCCL rank
    initialized in-process (a ``file://`` store under build/, removed at
    the end), ``make_mesh()`` (1 x 1); ``RankingTrainer(mesh=...)`` at TA's
    config, P_STEPS steps and P_TIMED timed ones, against the trainer
    without a mesh from the same state and batches (losses 1e-5 relative,
    parameters 2e-5: the CPU mesh tests' tolerances; bit-equal expected and
    printed), its B1f/B1b launches counted (3 a step) into the kernels'
    totals; one ``RetrievalTrainer(mesh=...)`` step at ``retrieval_flagship``
    on RT's data in float32 against the one without (the two run in turn,
    compared on the host: loss, grad norm, parameters, accumulators), then
    timed bf16 steps; ``RetrievalIndex(mesh=...)`` at the 10M
    corpus against the index without: ``search`` at batch 1 and 64,
    ``fetch_items`` and ``similar_items`` the same ids, scores 1e-5; the
    three sharded lookups and their table gradients over NCCL against a
    plain gather. Prints each side's p50 (host clock);
15. E, the entry points: each ``examples_torch`` script as its ``main``
    runs it, on the card at small flags, its launches counted into the kernels' totals:
    ``train_ranking --config ranking_small --steps 200 --flash --push-dir``
    (B4f/B4b at layer 0) then ``evaluate ranking --eval_type all`` on its
    checkpoint (B4f), ``train_retrieval --quick-start`` then ``evaluate
    retrieval``, ``serving_demo`` and ``online_learning_demo`` at their
    defaults, and ``quality_torch.py --track onetrans --scale small
    --epochs 1`` (OneTrans-S, DIN, NS-only). Gates: every script writes
    the JAX script's files; ``evaluate``'s offline AUCs on the
    checkpoint equal ``RankingEvaluator``'s on the trainer's final params
    over the same batches (1e-6); the push applied to an engine at the
    trainer's initial params equals the checkpoint's state bit for bit;
    the online demo trains on from its checkpoint and keeps the appended
    items indexed; each quality model's test CTR AUC is above 0.56;
16. AB, the compression ablation: ``examples_torch/ablation_compression.py``
    as its ``main`` runs it at ``--steps 200 --num_users 1000`` (both arms
    at L = 64). Gates: the JAX script's keys on every printed line, 22 and
    64 tokens, finite recalls in [0, 1], no band-attention kernel launched;
17. M, the measurement scripts: each ``examples_torch`` bench as its
    ``main`` runs it on the card, its launches counted into the kernels'
    totals: ``flagship_serving_bench --corpus 1000000`` (every phase: flat,
    int8 and int8 ``approx_recall`` searches on assigned indexes, IVF, the
    checkpoint and the push), ``flagship_bench --steps 20 --num_users 200``,
    ``serving_bench --requests 100`` and ``--device-side --chains 10``,
    ``lookup_bench`` and ``scaling_bench --steps 10`` at one rank over
    NCCL, ``graft_entry_torch``'s ``entry()`` and ``dryrun_multichip(1)``.
    Gates: the JAX scripts' keys, the flat recall 1 and the int8 recalls at
    least 0.97, finite losses, no band-attention kernel launched (the JAX
    scripts' configs leave ``use_flash_attention`` off);
18. print the kernels' JSON line, then the result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
N_CANDIDATES = 100
# requests per serving phase: enough that p99 is a tail and not the maximum
N_REQUESTS = 400
N_BATCH = 20  # batch_inference calls per phase
# training steps per phase: warm-up, then timed
N_TRAIN_WARMUP = 3
N_TRAIN = 20
N_SG = 20  # S-trunk backward passes, as many as the training steps
SG_ITEMS, SG_BATCH = 116, 512  # phase SG: TA's items per sequence and batch
N_SESSION_PAIRS = 400  # score_request / score_session pairs
SESSION_DELTAS = (1, 2, 4, 8)  # items appended per session request, cycled
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM dense peaks
PEAK_BYTES = 3.35e12
# Kernel against plain version, output error: in bf16 relative to the
# largest reference output (|out| ~1 here, and one bf16 ulp is at most
# 2^-7 = 7.8e-3 of a value, so this allows about one ulp: the kernel and the
# plain version both round once from float32); in float32 absolute.
BF16_REL_TOL = 1e-2
F32_TOL = 1e-4
LSE_TOL = 1e-3
# Probabilities of two request paths. In bf16 every eager op rounds, and the
# same path at two batch sizes already differs by up to ~6e-3 (measured on
# the CPU at these widths), so the cached request against the 128-row batch
# forward is held at 1e-2; against single_inference, one row at a time, at
# 5e-3. The invariant itself is held tightly in float32.
BF16_BATCH_TOL = 1e-2
BF16_SINGLE_TOL = 5e-3
F32_PATH_TOL = 1e-4
# One float32 training step through the kernels against one through the
# plain attention path, same params and batch: the loss and the dense
# gradient norm relative to their value, the tables' gradients (each
# lookup's, as the sparse optimizer receives them) relative to the largest
# of each table. Measured on the H100: loss 0, norm <= 2.3e-7, table
# gradients <= 2.1e-6; the limits leave 16x and more. The table updates
# are printed, not gated: rowwise
# adagrad's first step divides each lookup's gradient by its own RMS, so a
# lookup with a small gradient takes a full-size step carrying its
# rounding. They read <= 6.2e-6 (TA-TC) and 2.1e-5 (L) with the NS stacks
# drawn 3.46x too wide, and 1.8e-5 to 1.6e-4 at flax's scale, where loss
# and grad norm stayed bit-equal.
F32_STEP_LOSS_TOL = 1e-6
F32_STEP_NORM_TOL = 4e-6
F32_STEP_TABLE_TOL = 1e-4
# The same in bf16 (loss and dense gradient norm of phases TA/TB/TC, phase
# SG's gradient norm), where the tensor-core backwards sum in another order
# than the plain backward and every eager op rounds. Measured on the H100:
# loss <= 2.3e-4, grad norm <= 4.8e-4, SG 8.6e-5; TC read as much as TA
# while it ran no tensor-core backward, so most of the gap is the bf16
# rounding of the two paths' forwards. The limits leave about 4x.
BF16_STEP_LOSS_TOL = 2e-3
BF16_STEP_NORM_TOL = 2e-3
CARD = ""

# The tensor-core kernels tile each key segment on its own; these small
# shapes reach each edge of that tiling: Lq < 64 (one query tile, rows past
# Lq), Ls % 64 != 0 with n = 12 (the last S tile zero-filled, the NS tile
# holding only its n rows), a fully padded batch row (n = 0: no valid key at
# all; n = 12: no valid S key, so rows below Ls have no valid key), and the
# band off. B1f and B1b take those with n = 12, B3b those with n = 0. The
# tensor-core backward tiles each width otherwise (64-, 32- or 16-column
# chunks) and a head's columns start at h·Dh, so B1b and B3b also take the
# edges at the widths below 128, with 2 or 4 heads.
EDGE_SHAPES = [
    dict(b=3, h=2, lq=40, ls=100, n=12, dh=128),
    dict(b=3, h=2, lq=150, ls=200, n=12, dh=128, padded_row=True),
    dict(b=3, h=2, lq=150, ls=200, n=12, dh=128, causal=False),
    dict(b=3, h=2, lq=40, ls=100, n=0, dh=128),
    dict(b=2, h=2, lq=70, ls=130, n=0, dh=128, causal=False),
]
NARROW_EDGE_SHAPES = [
    dict(b=3, h=4, lq=40, ls=100, n=12, dh=64),
    dict(b=3, h=2, lq=150, ls=200, n=12, dh=96, padded_row=True),
    dict(b=3, h=2, lq=150, ls=200, n=12, dh=48, causal=False),
    dict(b=2, h=4, lq=70, ls=130, n=12, dh=16),
    dict(b=3, h=4, lq=40, ls=100, n=0, dh=64),
    dict(b=3, h=2, lq=150, ls=200, n=0, dh=96),
    dict(b=3, h=2, lq=150, ls=200, n=0, dh=48, causal=False),
    dict(b=2, h=4, lq=70, ls=130, n=0, dh=16),
]
# (name, JAX kernel body it replaces, shapes on the main path). The first
# shape of each kernel is the one its JSON entry reports (its heaviest).
KERNELS = [
    ("band_attn_blocked_fwd", "recommend_tpu/ops/pallas/flash_attention.py:59", [
        # phase B batch_inference layer 0 (B=128, H=2), score_request layer 0
        dict(b=256, h=1, lq=607, ls=1214, n=0, dh=128),
        dict(b=2, h=1, lq=595, ls=1202, n=0, dh=128),
        # the other widths that reach it (kv > 1024): Dh 64 (4 heads at
        # d 256) and ranking_base's Dh 96
        dict(b=512, h=1, lq=607, ls=1214, n=0, dh=64),
        dict(b=512, h=1, lq=607, ls=1214, n=0, dh=96),
        # and the rest of _KERNEL_DH, which the bf16 kernel tiles otherwise:
        # Dh 32 as one 32-column chunk (64-byte swizzle), Dh 16, 48, 80
        # and 112 as 16-column chunks (32-byte swizzle, m64n16k16 PV)
        *(dict(b=64, h=1, lq=607, ls=1214, n=0, dh=dh) for dh in (16, 32, 48, 80, 112)),
    ]),
    ("band_attn_bh_fwd", "recommend_tpu/ops/pallas/flash_attention.py:393", [
        # phase TC layer 0 (batch 512 x 4 heads), then phase C
        # batch_inference (B=128, H=4) and score_request, layer 0
        dict(b=2048, h=1, lq=181, ls=362, n=0, dh=64),
        dict(b=512, h=1, lq=103, ls=206, n=0, dh=64),
        dict(b=4, h=1, lq=91, ls=194, n=0, dh=64),
        # ranking_base's head width (384 / 4 heads), training layer 0 shape
        dict(b=512, h=1, lq=181, ls=362, n=0, dh=96),
        # the edges of the tensor-core kernel's tiling: Lq < 64, a partial
        # last query tile, Lkv % 64 != 0 (the last key tile zero-filled),
        # row 0 fully padded (make_inputs pads it when n = 0), the band off;
        # then every other width of _KERNEL_DH, which it tiles otherwise
        dict(b=3, h=1, lq=40, ls=100, n=0, dh=64),
        dict(b=3, h=1, lq=150, ls=200, n=0, dh=64),
        dict(b=2, h=1, lq=70, ls=130, n=0, dh=64, causal=False),
        *(dict(b=64, h=1, lq=181, ls=362, n=0, dh=dh) for dh in (16, 32, 48, 80, 112, 128)),
    ]),
    ("band_attn_mh_fwd", "recommend_tpu/ops/pallas/flash_attention.py:620", [
        # after phase SG's shapes (put first in main): encode_s serving,
        # phase B layers 1-3, phase A layer 0
        dict(b=1, h=2, lq=352, ls=595, n=0, dh=128),
        dict(b=1, h=2, lq=231, ls=352, n=0, dh=128),
        dict(b=1, h=2, lq=109, ls=231, n=0, dh=128),
        dict(b=1, h=2, lq=91, ls=194, n=0, dh=128),
    ]),
    ("band_attn_segkv_fwd", "recommend_tpu/ops/pallas/flash_attention.py:865", [
        # full forward, B=128: phase B layers 1-3, phase A layer 0
        dict(b=128, h=2, lq=364, ls=595, n=12, dh=128),
        dict(b=128, h=2, lq=243, ls=352, n=12, dh=128),
        dict(b=128, h=2, lq=121, ls=231, n=12, dh=128),
        dict(b=128, h=2, lq=103, ls=194, n=12, dh=128),
        # training phase TA's layer 0 (batch 512, 2 heads)
        dict(b=512, h=2, lq=181, ls=350, n=12, dh=128),
        # the edges of the tensor-core kernel's tiling (EDGE_SHAPES, above),
        # then the NS segment at a 64- and a 16-column chunk
        *(s for s in EDGE_SHAPES if s["n"]),
        dict(b=64, h=2, lq=364, ls=595, n=12, dh=64),
        dict(b=64, h=2, lq=364, ls=595, n=12, dh=48),
    ]),
]
# the source of each kernel's bf16 body on the main path, for the kernels'
# JSON line
CSRC = "recommend_tpu_torch/csrc/"
SOURCE = {"band_attn_blocked_fwd": CSRC + "band_attention_fwd_sm90.cuh",
          "band_attn_mh_fwd": CSRC + "band_attention_fwd_sm90.cuh",
          "band_attn_bh_fwd": CSRC + "band_attention_fwd_sm90.cuh",
          "band_attn_segkv_fwd": CSRC + "band_attention_fwd_sm90.cuh",
          "band_attn_segkv_bwd": CSRC + "band_attention_bwd_sm90.cuh",
          "band_attn_mh_bwd": CSRC + "band_attention_bwd_sm90.cuh",
          "band_attn_blocked_bwd_dq": CSRC + "band_attention_bwd_sm90.cuh",
          "band_attn_blocked_bwd_dkv": CSRC + "band_attention_bwd_sm90.cuh",
          "band_attn_bh_bwd": CSRC + "band_attention_bwd_sm90.cuh"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(shape, dtype, gen):
    """Kernel inputs at one shape. q and k ~ N(0, 1.5^2), so the scaled
    logits have std ~2.25: each softmax is peaked on a few keys and a row's
    running maximum moves from kv tile to kv tile. v ~ N(0, 0.25^2), so an
    output is about one value row (|out| up to ~1.2, where a bf16 ulp is
    7.8e-3). Keys are left-padded by up to a quarter of the S length per
    row and, where there are several rows and no NS segment (or the shape
    sets ``padded_row``), the first row's S keys are all padded (fully
    masked query rows when there is no NS segment)."""
    import torch

    b, h, lq, ls, n, dh = (shape[k] for k in ("b", "h", "lq", "ls", "n", "dh"))
    hd = h * dh
    dev = "cuda"
    rnd = lambda std, *s: (std * torch.randn(*s, generator=gen, device=dev)).to(dtype)
    pad = torch.randint(0, ls // 4 + 1, (b, 1), generator=gen, device=dev)
    valid = torch.arange(ls, device=dev)[None, :] >= pad
    if shape.get("padded_row", n == 0) and b > 1:
        valid[0] = False
    bias = torch.where(valid, 0.0, -1e9).float()
    t = dict(q=rnd(1.5, b, lq, hd), k=rnd(1.5, b, ls, hd), v=rnd(0.25, b, ls, hd),
             bias=bias)
    if n:
        t.update(kns=rnd(1.5, b, n, hd), vns=rnd(0.25, b, n, hd))
    return t


def call(name, t, shape, fa, plain=False):
    h, dh = shape["h"], shape["dh"]
    total = shape["ls"] + shape["n"]
    off, scale = total - shape["lq"], 1.0 / dh ** 0.5
    causal = shape.get("causal", True)
    fn = getattr(fa, name + ("_plain" if plain else ""))
    if name == "band_attn_segkv_fwd":
        return fn(t["q"], t["k"], t["v"], t["kns"], t["vns"], t["bias"], scale,
                  off, causal, h)
    if name == "band_attn_mh_fwd":
        return fn(t["q"], t["k"], t["v"], t["bias"], scale, off, causal, h)
    return fn(t["q"], t["k"], t["v"], t["bias"], scale, off, causal)


def library_inputs(t, shape):
    """q, k, v as [B, H, L, Dh] views (keys joined) and the additive mask of
    the kernels' function, for F.scaled_dot_product_attention."""
    import torch

    b, h, lq, ls, n, dh = (shape[k] for k in ("b", "h", "lq", "ls", "n", "dh"))
    total = ls + n
    heads = lambda x: x.view(b, x.shape[1], h, dh).transpose(1, 2)
    k, v, bias = t["k"], t["v"], t["bias"]
    if n:
        k, v = torch.cat([k, t["kns"]], 1), torch.cat([v, t["vns"]], 1)
        bias = torch.cat([bias, bias.new_zeros(b, n)], 1)
    mask = bias[:, None, None, :]
    if shape.get("causal", True):
        q_pos = total - lq + torch.arange(lq, device="cuda")
        band = torch.where(torch.arange(total, device="cuda")[None, :] <= q_pos[:, None],
                           0.0, -1e9)
        mask = mask + band[None, None]
    return heads(t["q"]), heads(k), heads(v), mask.to(t["q"].dtype)


def library_call(t, shape):
    """One F.scaled_dot_product_attention over the same inputs with the same
    additive mask (keys joined, mask built outside the timed call)."""
    import torch.nn.functional as F

    q, k, v, mask = library_inputs(t, shape)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=1.0 / shape["dh"] ** 0.5)


def bound(t, out, lse, shape, dtype_name):
    """Least time for the call: every input read once and every output
    written once at the memory rate, or the in-band work (4·Dh flops per
    query row and key it may see) at the peak rate of the input type."""
    nbytes = sum(x.numel() * x.element_size() for x in (*t.values(), out, lse))
    flops = 4.0 * shape["dh"] * band_pairs(shape)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_kernels(fa, kernels):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    entries = {}
    for name, replaces, shapes in kernels:
        for i, shape in enumerate(shapes):
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[1]
                t = make_inputs(shape, dtype, gen)
                out, lse = call(name, t, shape, fa)
                torch.cuda.synchronize()
                ref, ref_lse = call(name, t, shape, fa, plain=True)
                live = ref_lse > -1e8  # rows with a valid key
                # On a padded batch row with an NS segment, the rows below Ls
                # have no valid key: there the plain version also weighs the
                # NS keys above the band (their -1e9 band mask rounds to the
                # padding's -1e9), which the kernels skip with the tiles above
                # the band. The model never reads those rows; leave them out.
                diff, ref_abs = (out.float() - ref.float()).abs(), ref.float().abs()
                note = ""
                if shape.get("padded_row") and shape["n"]:
                    b, lq, h = shape["b"], shape["lq"], shape["h"]
                    keep = live.transpose(1, 2)[..., None]  # [B, Lq, H, 1]
                    diff = diff.view(b, lq, h, -1) * keep
                    ref_abs = ref_abs.view(b, lq, h, -1) * keep
                    note = f", {int((~keep).sum())} of {b * lq * h} keyless rows left out"
                err, ref_max = diff.max().item(), ref_abs.max().item()
                lse_err = (lse - ref_lse)[live].abs().max().item()
                assert torch.isfinite(out).all(), f"{name} {shape}: non-finite output"
                assert bool((lse[~live] < -1e8).all()), f"{name}: masked-row lse"
                limit = BF16_REL_TOL * ref_max if dn == "bfloat16" else F32_TOL
                assert err <= limit, f"{name} {shape} {dn}: out err {err} > {limit}"
                assert lse_err <= LSE_TOL, f"{name} {shape} {dn}: lse err {lse_err}"
                ms = cuda_ms(lambda: call(name, t, shape, fa), 20)
                plain_ms = cuda_ms(lambda: call(name, t, shape, fa, plain=True), 5)
                lib_ms = cuda_ms(library_call(t, shape), 20)
                b_ms, b_by = bound(t, out, lse, shape, dn)
                log(f"kernel {name} {dn} {shape}: max_abs_err {err:.3g} "
                    f"(max|ref| {ref_max:.3g}{note}) "
                    f"lse_err {lse_err:.3g} | {ms:.4f} ms, "
                    f"plain {plain_ms:.4f} ms, "
                    f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) "
                    f"[{CARD}]")
                if i == 0 and dtype == torch.bfloat16:
                    entries[name] = {
                        "name": name, "route": "cuda",
                        "source": SOURCE[name],
                        "replaces": replaces, "launches": 0,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                        "shape": shape, "dtype": dn,
                    }
                del t, out, lse, ref, ref_lse
    torch.cuda.empty_cache()
    return entries


# B2dq and B2dkv, the two halves of the blocked backward: phase TB's layer
# 0 (batch 128 x 2 heads), then the edges of the tensor-core passes at kv >
# 1024 (Lkv % 64 != 0, the last key tile zero-filled): Lq < 64, a partial
# last query tile, the band off, row 0 of each fully padded (n = 0); then
# the other widths that reach them at kv > 1024, Dh 64 (4 heads at d 256)
# and ranking_base's Dh 96
BLOCKED_BWD_SHAPES = [
    dict(b=256, h=1, lq=607, ls=1214, n=0, dh=128),
    dict(b=3, h=1, lq=40, ls=1100, n=0, dh=128),
    dict(b=3, h=1, lq=555, ls=1100, n=0, dh=128),
    dict(b=2, h=1, lq=300, ls=1100, n=0, dh=128, causal=False),
    dict(b=128, h=1, lq=607, ls=1214, n=0, dh=64),
    dict(b=128, h=1, lq=607, ls=1214, n=0, dh=96),
]
# (name, JAX kernel body it replaces, training shapes; the first one is
# reported in the JSON line), checked against the plain backward
BWD_KERNELS = [
    ("band_attn_segkv_bwd", "recommend_tpu/ops/pallas/flash_attention.py:912", [
        # phase TA layer 0 (batch 512, 2 heads)
        dict(b=512, h=2, lq=181, ls=350, n=12, dh=128),
        *(s for s in EDGE_SHAPES + NARROW_EDGE_SHAPES if s["n"]),
    ]),
    ("band_attn_blocked_bwd_dq", "recommend_tpu/ops/pallas/flash_attention.py:102",
     BLOCKED_BWD_SHAPES),
    ("band_attn_blocked_bwd_dkv", "recommend_tpu/ops/pallas/flash_attention.py:142",
     BLOCKED_BWD_SHAPES),
    ("band_attn_bh_bwd", "recommend_tpu/ops/pallas/flash_attention.py:420", [
        # phase TC layer 0 (batch 512 x 4 heads), then ranking_base's Dh 96
        dict(b=2048, h=1, lq=181, ls=362, n=0, dh=64),
        dict(b=512, h=1, lq=181, ls=362, n=0, dh=96),
        # the edges of the tensor-core passes (Lq < 64, Lkv % 64 != 0, row 0
        # fully padded, the band off), then every other width of _KERNEL_DH,
        # which the passes tile otherwise: Dh 32 as one 32-column chunk, Dh
        # 16, 48, 80 and 112 as 16-column chunks (m64n16k16 products from
        # registers), Dh 128 as two 64-column chunks
        dict(b=3, h=1, lq=40, ls=100, n=0, dh=64),
        dict(b=2, h=1, lq=70, ls=130, n=0, dh=64, causal=False),
        *(dict(b=64, h=1, lq=181, ls=362, n=0, dh=dh) for dh in (16, 32, 48, 80, 112, 128)),
    ]),
    # phase SG's shapes, put first by main, then the edges
    ("band_attn_mh_bwd", "recommend_tpu/ops/pallas/flash_attention.py:654",
     [s for s in EDGE_SHAPES + NARROW_EDGE_SHAPES if not s["n"]]),
]
# the kernels phase SG runs: checked first at its shapes
SG_KERNELS = ("band_attn_mh_fwd", "band_attn_mh_bwd")
# flops per (row, key) pair in the band: the dq pass recomputes s and dp and
# forms dQ (3 products), the dkv pass s, dp, dV and dK (4); the one-kernel
# backwards do the five products of the function (2.5x the forward's 4 Dh)
BWD_FLOPS_PER_DH = {"band_attn_blocked_bwd_dq": 6, "band_attn_blocked_bwd_dkv": 8,
                    "band_attn_bh_bwd": 10, "band_attn_mh_bwd": 10,
                    "band_attn_segkv_bwd": 10}
# the forward kernel each backward kernel's inputs (lse, delta) come from
FWD_OF = {"band_attn_segkv_bwd": "band_attn_segkv_fwd",
          "band_attn_mh_bwd": "band_attn_mh_fwd"}


def band_pairs(shape) -> int:
    """(query row, key) pairs inside the causal band (all of them when the
    shape sets causal=False), over batch and heads."""
    b, h, lq, ls, n = (shape[k] for k in ("b", "h", "lq", "ls", "n"))
    total = ls + n
    off = total - lq
    if not shape.get("causal", True):
        return lq * total * b * h
    return sum(min(total, off + r + 1) for r in range(lq)) * b * h


def bwd_inputs(name, shape, dtype, gen, fa):
    """make_inputs' tensors plus dO ~ N(0, 1) and the forward's out, lse
    and delta (from the forward kernel)."""
    import torch

    t = make_inputs(shape, dtype, gen)
    t["do"] = torch.randn(t["q"].shape, generator=gen, device="cuda").to(dtype)
    fwd = FWD_OF.get(name, "band_attn_bh_fwd")
    out, lse = call(fwd, t, shape, fa)
    if shape.get("padded_row"):
        # Rows of B1b's padded batch row that see no NS key have no valid key.
        # There the plain backward recomputes p = 1 also for the NS keys
        # above the band (their -1e9 band mask rounds to the padded keys'
        # -1e9), which the kernels skip with the tiles above the band. The
        # model's dO on such rows is exactly 0, as here.
        b, lq, hd = t["do"].shape
        live = (lse > -1e8).to(dtype).transpose(1, 2)[..., None]  # [B, Lq, H, 1]
        t["do"] = (t["do"].view(b, lq, shape["h"], -1) * live).view(b, lq, hd)
    t["lse"] = lse
    # model layout: per-head statistics [B, H, Lq]
    t["delta"] = fa._delta(out, t["do"], shape["h"] if name in FWD_OF else 0)
    return t


def bwd_call(name, t, shape, fa, plain=False):
    off, scale = shape["ls"] + shape["n"] - shape["lq"], 1.0 / shape["dh"] ** 0.5
    causal = shape.get("causal", True)
    fn = getattr(fa, name + ("_plain" if plain else ""))
    if name == "band_attn_segkv_bwd":
        out = fn(t["q"], t["k"], t["v"], t["kns"], t["vns"], t["bias"], t["do"],
                 t["lse"], t["delta"], scale, off, causal, shape["h"])
    elif name == "band_attn_mh_bwd":
        out = fn(t["q"], t["k"], t["v"], t["bias"], t["do"], t["lse"], t["delta"],
                 scale, off, causal, shape["h"])
    else:
        out = fn(t["q"], t["k"], t["v"], t["bias"], t["do"], t["lse"], t["delta"],
                 scale, off, causal)
    return out if isinstance(out, tuple) else (out,)


def library_bwd(name, t, shape):
    """The backward of one F.scaled_dot_product_attention over the same
    inputs and mask: autograd.grad of its output with dO, for the inputs
    whose gradients the kernel computes (the forward runs once, outside the
    timed call)."""
    import torch
    import torch.nn.functional as F

    q, k, v, mask = library_inputs(t, shape)
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         scale=1.0 / shape["dh"] ** 0.5)
    b, lq, h, dh = shape["b"], shape["lq"], shape["h"], shape["dh"]
    do = t["do"].view(b, lq, h, dh).transpose(1, 2)
    wrt = {"band_attn_blocked_bwd_dq": (q,), "band_attn_blocked_bwd_dkv": (k, v)}.get(
        name, (q, k, v))
    return lambda: torch.autograd.grad(out, wrt, do, retain_graph=True)


def check_backward_kernels(fa, kernels):
    """Each backward kernel against its plain backward at the training
    shapes, in bf16 (about one ulp: 1e-2 of each output's max|ref|) and f32
    (1e-4 of max|ref|), with its time, the plain and SDPA-backward times and
    its bound (B4b's first shape also with each of its passes alone). The
    CUDA-core passes (f32) accumulate over keys in the plain version's order
    at its rounding points and read no difference at all on the H100; the
    tensor-core passes (every bf16 call) round at the same points but sum
    in another order, and read about one bf16 ulp of the largest
    gradient."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    entries = {}
    for name, replaces, shapes in kernels:
        for i, shape in enumerate(shapes):
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[1]
                t = bwd_inputs(name, shape, dtype, gen, fa)
                got = bwd_call(name, t, shape, fa)
                torch.cuda.synchronize()
                ref = bwd_call(name, t, shape, fa, plain=True)
                rel = 0.0
                for g, r in zip(got, ref):
                    assert torch.isfinite(g).all(), f"{name} {shape}: non-finite gradient"
                    r_max = r.float().abs().max().item()
                    rel = max(rel, (g.float() - r.float()).abs().max().item() / r_max)
                limit = BF16_REL_TOL if dn == "bfloat16" else F32_TOL
                assert rel <= limit, f"{name} {shape} {dn}: rel err {rel} > {limit}"
                ms = cuda_ms(lambda: bwd_call(name, t, shape, fa), 10)
                plain_ms = cuda_ms(lambda: bwd_call(name, t, shape, fa, plain=True), 3)
                lib_ms = cuda_ms(library_bwd(name, t, shape), 10)
                nbytes = sum(x.numel() * x.element_size()
                             for x in (*t.values(), *got))
                flops = BWD_FLOPS_PER_DH[name] * shape["dh"] * band_pairs(shape)
                t_ops, t_bytes = flops / PEAK_FLOPS[dn], nbytes / PEAK_BYTES
                b_ms = max(t_ops, t_bytes) * 1e3
                b_by = "operations" if t_ops >= t_bytes else "bytes"
                passes = ""
                if name == "band_attn_bh_bwd" and i == 0:
                    # B4b's two passes alone, through the B2dq and B2dkv entry
                    # points: the same launches on the same inputs
                    passes = ", ".join(
                        f"{label} pass {cuda_ms(lambda: bwd_call(half, t, shape, fa), 10):.4f} ms"
                        for label, half in (("dq", "band_attn_blocked_bwd_dq"),
                                            ("dkv", "band_attn_blocked_bwd_dkv"))) + ", "
                log(f"kernel {name} {dn} {shape}: max rel err {rel:.3g} | {ms:.4f} ms, "
                    f"{passes}plain {plain_ms:.4f} ms, sdpa bwd {lib_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by}) [{CARD}]")
                if i == 0 and dtype == torch.bfloat16:
                    entries[name] = {
                        "name": name, "route": "cuda",
                        "source": SOURCE[name],
                        "replaces": replaces, "launches": 0, "max_abs_err": max(
                            (g.float() - r.float()).abs().max().item()
                            for g, r in zip(got, ref)),
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms,
                        "shape": shape, "dtype": dn,
                    }
                del t, got, ref
                torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------


def serving_config(num_heads: int, flash: bool = True):
    from recommend_tpu_torch.config import get_config

    # bench.py's OneTrans-S widths on the ranking_base vocabularies
    return get_config(
        "ranking_base", embed_dim=256, num_layers=6, num_heads=num_heads,
        ffn_dim=1024, num_ns_tokens=12,
        pyramid_ratios=(0.5, 0.3, 0.2, 0.1, 0.05, 0.03),
        use_mixed_precision=True, dropout_rate=0.0, feature_embed_dim=128,
        seq_item_feature_dim=128, use_flash_attention=flash,
    )


def make_requests(cfg, rng, n_requests: int, history: int):
    vocab = dict(cfg.feature_vocab_sizes)
    reqs = []
    for _ in range(n_requests):
        user = {f: int(rng.integers(0, vocab[f]))
                for f in cfg.user_features + cfg.context_features}
        seqs = {sf: rng.integers(1, vocab["item_id"], size=history).tolist()
                for sf in cfg.sequence_features}
        cands = [{f: int(rng.integers(0, vocab[f])) for f in cfg.item_features}
                 for _ in range(N_CANDIDATES)]
        reqs.append((user, seqs, cands))
    return reqs


def counted(fa, fn, expected, times):
    """Run ``fn`` with every launch count at 0 first; require each kernel's
    count to be exactly ``times`` x its expected launches per call."""
    fa.reset_launch_counts()
    result = fn()
    got = dict(fa.LAUNCHES)
    want = {k: times * expected.get(k, 0) for k in got}
    assert got == want, f"launch counts {got}, expected {want}"
    return result, got


def max_diff(a, b, tasks):
    return max(abs(x[t] - y[t]) for x, y in zip(a, b) for t in tasks)


def serve_phase(label, heads, max_seq_len, history, per_score, per_batch, fa,
                totals):
    import dataclasses

    import numpy as np
    import torch

    from recommend_tpu_torch.convert import init_params
    from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine

    t0 = time.perf_counter()
    cfg = serving_config(heads)
    params = init_params(cfg, seed=SEED, device="cuda")
    engine = RankingInferenceEngine(cfg, params, max_seq_len=max_seq_len, device="cuda")
    # the plain attention path on the same weights, in bf16, and float32
    # twins with and without the kernels, for the checks that bf16 rounding
    # would blur
    p16 = RankingInferenceEngine(dataclasses.replace(cfg, use_flash_attention=False),
                                 params, max_seq_len=max_seq_len, device="cuda")
    f32 = dataclasses.replace(cfg, use_mixed_precision=False)
    e32 = RankingInferenceEngine(f32, params, max_seq_len=max_seq_len, device="cuda")
    p32 = RankingInferenceEngine(dataclasses.replace(f32, use_flash_attention=False),
                                 params, max_seq_len=max_seq_len, device="cuda")
    del params
    engine.warmup(N_CANDIDATES)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reqs = make_requests(cfg, np.random.default_rng(SEED), N_REQUESTS, history)

    lat = []

    def serve_all():
        outs = []
        for user, seqs, cands in reqs:
            t = time.perf_counter()
            outs.append(engine.score_request(user, seqs, cands))
            lat.append((time.perf_counter() - t) * 1e3)
        return outs

    outs, got_s = counted(fa, serve_all, per_score, N_REQUESTS)
    user, seqs, cands = reqs[0]
    rows = [(dict(user, **c), seqs) for c in cands]
    batch_lat = []

    def batch_all():
        for _ in range(N_BATCH):
            t = time.perf_counter()
            out = engine.batch_inference(rows)
            batch_lat.append((time.perf_counter() - t) * 1e3)
        return out

    batch, got_b = counted(fa, batch_all, per_batch, N_BATCH)
    for k in got_s:
        totals[k] += got_s[k] + got_b[k]

    # outputs: a probability per candidate and task
    for out in outs:
        assert len(out) == N_CANDIDATES
        for row in out:
            assert set(row) == set(cfg.tasks)
            assert all(0.0 <= p <= 1.0 for p in row.values()), row
    tasks = cfg.tasks
    # KV-cache invariant in bf16: the cached request against the full
    # forward per candidate (batch_inference) and single_inference
    kv_err = max_diff(outs[0], batch, tasks)
    singles = [engine.single_inference(*rows[i]) for i in range(4)]
    single_err = max_diff(outs[0][:4], singles, tasks)
    # bf16 kernels against the bf16 plain attention path, both calls
    path16_err = max(max_diff(outs[0], p16.score_request(user, seqs, cands), tasks),
                     max_diff(batch, p16.batch_inference(rows), tasks))
    # the same in float32, and the kernels against the plain attention path
    s32, b32 = e32.score_request(user, seqs, cands), e32.batch_inference(rows)
    kv32_err = max_diff(s32, b32, tasks)
    path_err = max(max_diff(s32, p32.score_request(user, seqs, cands), tasks),
                   max_diff(b32, p32.batch_inference(rows), tasks))
    assert kv_err <= BF16_BATCH_TOL, f"{label}: score_request vs batch {kv_err}"
    assert single_err <= BF16_SINGLE_TOL, f"{label}: score_request vs single {single_err}"
    assert path16_err <= BF16_BATCH_TOL, f"{label}: bf16 kernels vs plain path {path16_err}"
    assert kv32_err <= F32_PATH_TOL, f"{label}: f32 score_request vs batch {kv32_err}"
    assert path_err <= F32_PATH_TOL, f"{label}: f32 kernels vs plain path {path_err}"
    p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
    b50 = np.percentile(batch_lat, 50)
    log(f"phase {label}: heads {heads}, window {max_seq_len}, history {history}/feature, "
        f"{N_CANDIDATES} candidates | score_request n={len(lat)} p50 {p50:.3f} ms "
        f"p99 {p99:.3f} ms, batch_inference({N_CANDIDATES}) n={len(batch_lat)} p50 "
        f"{b50:.3f} ms | "
        f"launches score {got_s} batch {got_b} | bf16 cached-vs-full {kv_err:.2e}, "
        f"vs single {single_err:.2e}, kernels-vs-plain {path16_err:.2e}; f32 "
        f"cached-vs-full {kv32_err:.2e}, "
        f"kernels-vs-plain {path_err:.2e} | setup {setup_s:.1f} s [{CARD}]")
    del engine, p16, e32, p32
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------

# (label, heads, items per sequence, batch, kernel launches per step)
TRAIN_PHASES = [
    ("TA", 2, 116, 512, {"band_attn_segkv_fwd": 3, "band_attn_segkv_bwd": 3}),
    ("TB", 2, 400, 128, {"band_attn_blocked_fwd": 1, "band_attn_blocked_bwd_dq": 1,
                         "band_attn_blocked_bwd_dkv": 1, "band_attn_segkv_fwd": 3,
                         "band_attn_segkv_bwd": 3}),
    ("TC", 4, 116, 512, {"band_attn_bh_fwd": 3, "band_attn_bh_bwd": 3}),
]


def training_config(num_heads: int, batch_size: int, **overrides):
    """bench.py's OneTrans-S training config (bench.py:35-67) at the given
    head count and batch."""
    import dataclasses

    return dataclasses.replace(
        serving_config(num_heads), batch_size=batch_size, use_remat=False,
        use_sparse_embedding_updates=True, sparse_update_mode="rowwise",
        dense_lr=1e-3, dense_momentum=0.9, sparse_lr=0.05, **overrides)


def step_vs_plain(cfg, params, batch, mixed: bool, device="cuda"):
    """One step through the kernels and one through the plain attention
    path from the same params on the same batch, in float32 or (``mixed``)
    bf16 -> (loss, grad norm, table gradient, table update) relative
    differences; the table gradients are the lookups' as the step hands
    them to its sparse optimizer."""
    import dataclasses

    from recommend_tpu_torch.training.ranking_trainer import RankingTrainer

    def rel(a, b):
        return max(((a[k] - b[k]).abs().max() / b[k].abs().max()).item() for k in b)

    results = []
    for flash in (True, False):
        c = dataclasses.replace(cfg, use_mixed_precision=mixed, use_flash_attention=flash)
        trainer = RankingTrainer(c, device=device)
        grads, apply = {}, trainer._apply_sparse_updates

        def keep(p, accums, gdummies, *args, apply=apply, grads=grads):
            grads.update({k: v.detach().clone() for k, v in gdummies.items()})
            return apply(p, accums, gdummies, *args)

        trainer._apply_sparse_updates = keep
        state = trainer.init_state(params)
        state, m = trainer._train_step(state, trainer._put_batch(batch))
        updates = {n: state.params[n] - params[n] for n in trainer.tables}
        results.append((float(m["loss"]), float(m["grad_norm"]), grads, updates))
        del trainer, state
    (l1, n1, g1, u1), (l2, n2, g2, u2) = results
    assert g2, "the step handed no table gradients to its sparse optimizer"
    return (abs(l1 - l2) / abs(l2), abs(n1 - n2) / abs(n2), rel(g1, g2), rel(u1, u2))


def time_train_steps(fa, totals, trainer, state, batches, per_step, steps=N_TRAIN):
    """``steps`` train steps cycling ``batches``, each ending in reading
    its loss, under ``counted`` (``per_step`` launches a step), their
    launches added to ``totals`` -> (state, ms per step, losses, launches)."""
    times, losses = [], []

    def run():
        nonlocal state
        for i in range(steps):
            t = time.perf_counter()
            state, m = trainer._train_step(state, batches[i % len(batches)])
            losses.append(float(m["loss"]))  # waits for the step
            times.append((time.perf_counter() - t) * 1e3)

    _, got = counted(fa, run, per_step, steps)
    for k in got:
        totals[k] += got[k]
    return state, times, losses, got


def train_phase(label, heads, items, batch_size, per_step, fa, totals):
    import numpy as np
    import torch

    from recommend_tpu_torch.convert import init_params
    from recommend_tpu_torch.data.pipeline import ranking_batches
    from recommend_tpu_torch.data.synthetic import make_ranking_data
    from recommend_tpu_torch.training.ranking_trainer import RankingTrainer

    t0 = time.perf_counter()
    cfg = training_config(heads, batch_size)
    data = make_ranking_data(cfg, num_samples=4 * batch_size,
                             max_seq_per_feature=items, seed=SEED)
    it = ranking_batches(data, cfg, batch_size=batch_size, seed=SEED)
    host_batches = [next(it) for _ in range(4)]
    params = init_params(cfg, seed=SEED, device="cuda")
    trainer = RankingTrainer(cfg, device="cuda")
    state = trainer.init_state(params)
    batches = [trainer._put_batch(b) for b in host_batches]
    for i in range(N_TRAIN_WARMUP):
        state, m = trainer._train_step(state, batches[i % len(batches)])
        assert np.isfinite(float(m["loss"])), f"{label}: warm-up loss {m['loss']}"
    setup_s = time.perf_counter() - t0
    state, times, losses, got = time_train_steps(fa, totals, trainer, state, batches,
                                                 per_step)
    assert all(np.isfinite(losses)), f"{label}: non-finite loss {losses}"
    del trainer, state
    torch.cuda.empty_cache()
    errs = step_vs_plain(cfg, params, host_batches[0], mixed=False)
    assert errs[0] <= F32_STEP_LOSS_TOL, f"{label}: f32 loss differs by {errs[0]}"
    assert errs[1] <= F32_STEP_NORM_TOL, f"{label}: f32 grad norm differs by {errs[1]}"
    assert errs[2] <= F32_STEP_TABLE_TOL, f"{label}: f32 table gradients differ by {errs[2]}"
    errs16 = step_vs_plain(cfg, params, host_batches[0], mixed=True)
    assert errs16[0] <= BF16_STEP_LOSS_TOL, f"{label}: bf16 loss differs by {errs16[0]}"
    assert errs16[1] <= BF16_STEP_NORM_TOL, f"{label}: bf16 grad norm differs by {errs16[1]}"
    p50, p99 = np.percentile(times, 50), np.percentile(times, 99)
    ex_s = batch_size * len(times) / (sum(times) / 1e3)
    log(f"phase {label}: heads {heads}, {items} items/sequence, batch {batch_size} | "
        f"train step n={len(times)} p50 {p50:.3f} ms p99 {p99:.3f} ms, {ex_s:.1f} "
        f"examples/s | loss first {losses[0]:.4f} last {losses[-1]:.4f} mean "
        f"{np.mean(losses):.4f} | launches {got} | kernels-vs-plain step: f32 loss "
        f"{errs[0]:.2e}, grad norm {errs[1]:.2e}, table gradient {errs[2]:.2e} (update "
        f"{errs[3]:.2e}); bf16 loss {errs16[0]:.2e}, grad norm {errs16[1]:.2e}, table "
        f"gradient {errs16[2]:.2e} (update {errs16[3]:.2e}) | "
        f"setup {setup_s:.1f} s [{CARD}]")
    del params
    torch.cuda.empty_cache()
    return ex_s


# ---------------------------------------------------------------------------
# phase SG: the gradient of the S trunk
# ---------------------------------------------------------------------------


def s_trunk_kernel_shapes(cfg, items: int, batch: int):
    """The model-layout kernel shapes of ``encode_s`` at ``items`` per
    sequence, from ``pyramid_keep_lengths``: one per layer whose kept S
    window reaches the 64-query gate, as KERNELS' shape dicts."""
    from recommend_tpu_torch.models.ranking import pyramid_keep_lengths

    n = cfg.num_ns_tokens
    ls = len(cfg.sequence_features) * (items + 1) - 1  # [SEP] between sequences
    shapes = []
    for keep in pyramid_keep_lengths(cfg, ls + n):
        keep_s = keep - n
        if keep_s <= 0:
            break
        if keep_s >= 64:
            shapes.append(dict(b=batch, h=cfg.num_heads, lq=keep_s, ls=ls, n=0,
                               dh=cfg.embed_dim // cfg.num_heads))
        ls = keep_s
    return shapes


def s_trunk_grads(model, names, seqs, sv, noise):
    """Gradients of L = sum over layers of <k_s, R_k> + <v_s, R_v> over
    ``encode_s``'s cache, each R masked by the layer's key validity (on a
    fully padded query row the kernel backward recomputes p = 1 where the
    plain path's autograd gives 1/n; the mask makes dO there exactly 0)."""
    import torch

    cache = model.encode_s(seqs, sv)
    loss = 0.0
    for (k, v, valid), (rk, rv) in zip(cache, noise):
        m = valid[..., None, None]
        loss = loss + (k.float() * (rk * m)).sum() + (v.float() * (rv * m)).sum()
    params = dict(model.named_parameters())
    # the NS stacks and heads take no part in encode_s: no gradient
    grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    return [g for g in grads if g is not None]


def s_trunk_inputs(cfg, items: int, batch_size: int):
    """Phase SG's inputs at ``cfg``: (``model_for``, which builds a
    ``RankingModel`` of a config on the seeded weights with the dense
    parameters requiring grad, their names, one batch's sequences and
    validity on the card, the masked-loss noise per cached layer)."""
    import numpy as np
    import torch

    from recommend_tpu_torch.convert import init_params, table_param_names
    from recommend_tpu_torch.data.pipeline import ranking_batches
    from recommend_tpu_torch.data.synthetic import make_ranking_data
    from recommend_tpu_torch.models.ranking import RankingModel

    data = make_ranking_data(cfg, num_samples=batch_size, max_seq_per_feature=items,
                             seed=SEED)
    batch = next(ranking_batches(data, cfg, batch_size=batch_size, seed=SEED))
    seqs = {k: torch.from_numpy(v).cuda() for k, v in batch["sequences"].items()}
    sv = {k: torch.from_numpy(v).cuda() for k, v in batch["seq_valid"].items()}
    params = init_params(cfg, seed=SEED, device="cuda")
    tables = set(table_param_names(cfg))
    names = [n for n in params if n not in tables]

    def model_for(c):
        with torch.device("meta"):
            model = RankingModel(c)
        model.load_state_dict(params, assign=True)
        for name, p in model.named_parameters():
            p.requires_grad_(name not in tables)
        return model

    with torch.no_grad():
        shapes = [tuple(k.shape) for k, _, _ in model_for(cfg).encode_s(seqs, sv)]
    rng = np.random.default_rng(SEED)
    noise = [tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).cuda()
                   for _ in range(2)) for s in shapes]
    return model_for, names, seqs, sv, noise


def s_trunk_phase(fa, totals):
    import dataclasses

    import numpy as np
    import torch

    t0 = time.perf_counter()
    items, batch_size = SG_ITEMS, SG_BATCH
    cfg = training_config(2, batch_size)  # TA's widths
    model_for, names, seqs, sv, noise = s_trunk_inputs(cfg, items, batch_size)
    model = model_for(cfg)
    per_pass = len(s_trunk_kernel_shapes(cfg, items, batch_size))
    s_trunk_grads(model, names, seqs, sv, noise)  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    times = []

    def run():
        for _ in range(N_SG):
            t = time.perf_counter()
            grads = s_trunk_grads(model, names, seqs, sv, noise)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            assert all(torch.isfinite(g).all() for g in grads), "SG: non-finite gradient"

    _, got = counted(fa, run, {"band_attn_mh_fwd": per_pass,
                               "band_attn_mh_bwd": per_pass}, N_SG)
    for k in got:
        totals[k] += got[k]
    del model
    # on the same batch, through the kernels and through the plain path:
    # float32 (the CUDA-core passes) and bf16 (the tensor-core ones)
    norms = {}
    for mixed in (False, True):
        for flash in (True, False):
            c = dataclasses.replace(cfg, use_mixed_precision=mixed, use_flash_attention=flash)
            grads = s_trunk_grads(model_for(c), names, seqs, sv, noise)
            norms[mixed, flash] = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).item()
            del grads
    err = {m: abs(norms[m, True] - norms[m, False]) / norms[m, False] for m in (False, True)}
    assert err[False] <= F32_STEP_NORM_TOL, f"SG: f32 grad norm differs by {err[False]}"
    assert err[True] <= BF16_STEP_NORM_TOL, f"SG: bf16 grad norm differs by {err[True]}"
    log(f"phase SG: heads 2, {items} items/sequence, batch {batch_size}, kernel layers "
        f"{per_pass} | S-trunk backward n={len(times)} p50 {np.percentile(times, 50):.3f} "
        f"ms p99 {np.percentile(times, 99):.3f} ms | launches {got} | kernels-vs-plain "
        f"grad norm: f32 {norms[False, True]:.6g} vs {norms[False, False]:.6g}, rel "
        f"{err[False]:.2e}; bf16 {norms[True, True]:.6g} vs {norms[True, False]:.6g}, rel "
        f"{err[True]:.2e} | setup {setup_s:.1f} s [{CARD}]")
    del model_for, noise
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase S: the cross-request session cache
# ---------------------------------------------------------------------------


def session_phase(fa, totals):
    import dataclasses

    import numpy as np
    import torch

    from recommend_tpu_torch.convert import init_params
    from recommend_tpu_torch.models.ranking import pyramid_keep_lengths
    from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine

    t0 = time.perf_counter()
    window, items = 64, 48
    cfg = serving_config(4)  # examples/serving_bench.py's config, kernels on
    params = init_params(cfg, seed=SEED, device="cuda")
    engine = RankingInferenceEngine(cfg, params, max_seq_len=window, device="cuda")
    assert engine.auto_maintain is False and engine.fold_headroom >= max(SESSION_DELTAS)
    engine.warmup(N_CANDIDATES, deltas=SESSION_DELTAS)
    n = cfg.num_ns_tokens
    s_len = len(cfg.sequence_features) * (window + 1) - 1
    per_encode = sum(1 for keep in pyramid_keep_lengths(cfg, s_len + n) if keep - n >= 64)
    # the serving bench's ids: features in [0, 100) (here below each
    # feature's vocabulary too: hour, weekday and device have fewer rows, and
    # an id past a table raises in the port), items in [0, 1000)
    rng = np.random.default_rng(SEED)
    vocab = dict(cfg.feature_vocab_sizes)
    draw = lambda f: int(rng.integers(0, min(100, vocab[f])))
    user = {f: draw(f) for f in cfg.user_features + cfg.context_features}
    history = {sf: rng.integers(0, 1000, size=items).tolist()
               for sf in cfg.sequence_features}
    sf0 = cfg.sequence_features[0]
    cands = [[{f: draw(f) for f in cfg.item_features}
              for _ in range(N_CANDIDATES)] for _ in range(2 * N_SESSION_PAIRS + 4)]
    new = [rng.integers(0, 1000, size=SESSION_DELTAS[i % len(SESSION_DELTAS)]).tolist()
           for i in range(N_SESSION_PAIRS)]
    engine.update_session("u1", history)
    refreshes = 0
    refresh = engine.refresh_session

    def counting_refresh(sid):
        nonlocal refreshes
        refreshes += 1
        refresh(sid)

    engine.refresh_session = counting_refresh
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    lat_req, lat_sess = [], []
    maintained = 0
    fa.reset_launch_counts()
    for i in range(N_SESSION_PAIRS):
        t = time.perf_counter()
        engine.score_request(user, history, cands[2 * i])
        lat_req.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        out = engine.score_session("u1", user, cands[2 * i + 1], new_items={sf0: new[i]})
        lat_sess.append((time.perf_counter() - t) * 1e3)
        assert len(out) == N_CANDIDATES and all(
            0.0 <= p <= 1.0 for row in out for p in row.values()), out[0]
        maintained += engine.maintain()  # idle time between requests
    got = dict(fa.LAUNCHES)
    want = {k: 0 for k in got}
    want["band_attn_bh_fwd"] = (N_SESSION_PAIRS + refreshes) * per_encode
    assert got == want, f"S: launch counts {got}, expected {want}"
    for k in got:
        totals[k] += got[k]
    engine.refresh_session = refresh
    memory_mb = engine.session_memory_mb()

    # at a re-anchor the session scores as score_request does, bf16 and f32
    tasks = cfg.tasks
    engine.refresh_session("u1")
    ids = {sf: list(v) for sf, v in engine._sessions["u1"]["ids"].items()}
    c = cands[-1]
    bf16_err = max_diff(engine.score_session("u1", user, c),
                        engine.score_request(user, ids, c), tasks)
    e32 = RankingInferenceEngine(dataclasses.replace(cfg, use_mixed_precision=False),
                                 params, max_seq_len=window, device="cuda")
    e32.update_session("u1", ids)
    f32_err = max_diff(e32.score_session("u1", user, c), e32.score_request(user, ids, c),
                       tasks)
    assert bf16_err <= BF16_BATCH_TOL, f"S: bf16 session vs request {bf16_err}"
    assert f32_err <= F32_PATH_TOL, f"S: f32 session vs request {f32_err}"
    del engine, e32
    # no pruning, one sequence: refresh, appends, a fold, more appends
    flat = RankingInferenceEngine(
        dataclasses.replace(cfg, use_mixed_precision=False,
                            pyramid_ratios=(1.0,) * cfg.num_layers,
                            sequence_features=(sf0,)),
        params, max_seq_len=window, device="cuda")
    flat.update_session("np", {sf0: history[sf0][:40]})
    chain_err, folds = 0.0, 0
    for d in (4, 8, 8, 2, 1):
        flat.update_session("np", {sf0: rng.integers(0, 1000, size=d).tolist()})
        folds = max(folds, flat._sessions["np"]["compactions"])
        sess_ids = {sf0: list(flat._sessions["np"]["ids"][sf0])}
        chain_err = max(chain_err, max_diff(flat.score_session("np", user, c),
                                            flat.score_request(user, sess_ids, c), tasks))
    assert folds == 1, f"S: the chain folded {folds} times"
    assert chain_err <= F32_PATH_TOL, f"S: f32 no-pruning chain vs request {chain_err}"
    del flat, params
    torch.cuda.empty_cache()

    d = np.asarray(lat_sess) - np.asarray(lat_req)
    wins = float((d < 0).sum() / max(int(np.count_nonzero(d)), 1))
    log(f"phase S: heads 4, window {window}, {items} items/sequence, {N_CANDIDATES} "
        f"candidates, delta mix {SESSION_DELTAS}, deployment profile | score_request "
        f"n={len(lat_req)} p50 {np.percentile(lat_req, 50):.3f} ms p99 "
        f"{np.percentile(lat_req, 99):.3f} ms; score_session n={len(lat_sess)} p50 "
        f"{np.percentile(lat_sess, 50):.3f} ms p99 {np.percentile(lat_sess, 99):.3f} ms; "
        f"paired delta p50 {np.percentile(d, 50):.3f} ms, session wins {wins:.3f} | "
        f"maintained {maintained}, refreshes {refreshes}, session memory "
        f"{memory_mb:.3f} MB | launches {got} | re-anchor session-vs-request bf16 "
        f"{bf16_err:.2e}, f32 {f32_err:.2e}; f32 no-pruning chain {chain_err:.2e} "
        f"| setup {setup_s:.1f} s [{CARD}]")


# ---------------------------------------------------------------------------
# phase K: trainer -> checkpoint -> engine -> push
# ---------------------------------------------------------------------------

K_ITEMS, K_BATCH = 116, 512  # TA's items per sequence and batch
K_WINDOW, K_HISTORY, K_SESSIONS = 64, 48, 4  # the engines: phase A's serving shape
# A resumed run against an unbroken one on the card. The sparse update sums
# duplicate lookups per segment of the sorted ids, with no atomics
# (ops/sparse_embed.py), so the two runs agree bit for bit; summed with
# CUDA's atomic index_add_ they differed by 1.4e-4 in the loss in one of
# three runs of this phase on an H100.
K_RESUME_LOSS_TOL = 1e-6  # relative
K_RESUME_PARAM_TOL = 1e-5  # of each parameter's largest |value|
K_DIR = Path(__file__).resolve().parent / "build" / "phase_k"


def timed(obj, name, seconds):
    """Wrap ``obj.name`` so that each call appends its seconds to
    ``seconds``."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds.append(time.perf_counter() - t)
        return out

    setattr(obj, name, wrapper)


def checkpoint_phase(fa, totals):
    """K: train 2 steps with checkpoints and a push tracker, start engine E0
    from the checkpoint and open sessions on it, resume to step 4 in a new
    trainer, hold the resumed run against an unbroken one, push steps 2->4
    into E0 (bit for bit against an engine from the step-4 checkpoint), and
    refuse a malformed push. Returns (config, the step-4 engine, the
    training batches) for phase D."""
    import shutil

    import numpy as np
    import torch

    from recommend_tpu_torch.data.pipeline import ranking_batches
    from recommend_tpu_torch.data.synthetic import make_ranking_data
    from recommend_tpu_torch.serving.param_push import (
        PushTracker, build_push, load_push, push_nbytes, save_push, table_keys)
    from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine
    from recommend_tpu_torch.training.checkpoint import CheckpointManager
    from recommend_tpu_torch.training.ranking_trainer import RankingTrainer

    t0 = time.perf_counter()
    cfg = training_config(2, K_BATCH, dropout_rate=0.1)  # TA's config, dropout on
    per_step = TRAIN_PHASES[0][4]  # TA's launches per step
    data = make_ranking_data(cfg, num_samples=4 * K_BATCH, max_seq_per_feature=K_ITEMS,
                             seed=SEED)
    it = ranking_batches(data, cfg, batch_size=K_BATCH, seed=SEED)
    batches = [next(it) for _ in range(4)]
    reqs = make_requests(cfg, np.random.default_rng(SEED), K_SESSIONS, K_HISTORY)
    shutil.rmtree(K_DIR, ignore_errors=True)
    ck = str(K_DIR)
    tracker = PushTracker(cfg)
    save_s, restore_s = [], []

    def trainer():
        tr = RankingTrainer(cfg, checkpoint_dir=ck, max_to_keep=2, device="cuda")
        timed(tr.ckpt, "save", save_s)
        return tr

    def add(got):
        for k in got:
            totals[k] += got[k]

    # 1. save: two steps, saved at the end; E0 starts from that checkpoint
    t1 = trainer()
    _, got = counted(fa, lambda: t1.train(tracker.wrap(iter(batches[:2])), 2, log_every=1),
                     per_step, 2)
    add(got)
    tracker.snapshot()  # the push's window starts at step 2
    del t1
    ck_bytes = os.path.getsize(CheckpointManager(ck).path(2))
    t = time.perf_counter()
    e0 = RankingInferenceEngine.from_checkpoint(ck, max_seq_len=K_WINDOW, device="cuda")
    torch.cuda.synchronize()
    engine_load_s = time.perf_counter() - t

    def open_sessions():
        for i, (_, seqs, _) in enumerate(reqs):
            e0.update_session(f"s{i}", seqs)

    add(counted(fa, open_sessions, {"band_attn_mh_fwd": 1}, K_SESSIONS)[1])

    # 2. resume to step 4, against steps 0-4 without a break
    t2 = trainer()
    timed(t2.ckpt, "restore", restore_s)
    state2, got = counted(fa, lambda: t2.train(tracker.wrap(iter(batches[2:])), 4,
                                               log_every=1), per_step, 2)
    add(got)
    assert [h["step"] for h in t2.history["train"]] == [3, 4], t2.history["train"]
    assert CheckpointManager(ck).steps() == [2, 4]
    t3 = RankingTrainer(cfg, device="cuda")
    state3, got = counted(fa, lambda: t3.train(iter(batches), 4, log_every=1), per_step, 4)
    add(got)
    loss2, loss3 = t2.history["train"][-1]["loss"], t3.history["train"][-1]["loss"]
    loss_err = abs(loss2 - loss3) / abs(loss3)
    param_err = max(((state2.params[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
                    for k, v in state3.params.items())
    assert loss_err <= K_RESUME_LOSS_TOL, f"K: resumed loss differs by {loss_err}"
    assert param_err <= K_RESUME_PARAM_TOL, f"K: resumed params differ by {param_err}"
    del t3, state3

    # 3. push steps 2->4 into E0, whose sessions are open
    push = build_push(state2.params, tracker.snapshot(), step=4)
    push_path = os.path.join(ck, "push_4.npz")
    push_bytes = save_push(push, push_path)
    tables = table_keys(cfg)
    loaded = load_push(push_path, e0.state_dict(), tables)
    del t2, state2, push
    t = time.perf_counter()
    _, got = counted(fa, lambda: e0.apply_push(loaded), {"band_attn_mh_fwd": 1}, K_SESSIONS)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t
    add(got)
    e4 = RankingInferenceEngine.from_checkpoint(ck, max_seq_len=K_WINDOW, device="cuda")
    mine, ref = e0.state_dict(), e4.state_dict()
    assert set(mine) == set(ref)
    unequal = [k for k in ref if not torch.equal(mine[k], ref[k])]
    assert not unequal, f"K: pushed state differs from step 4's in {unequal}"

    def score_both():
        return [(e0.score_request(*r), e4.score_request(*r)) for r in reqs]

    pairs, got = counted(fa, score_both, {"band_attn_mh_fwd": 2}, K_SESSIONS)
    add(got)
    push_err = max(max_diff(a, b, cfg.tasks) for a, b in pairs)
    assert push_err <= 1e-6, f"K: pushed engine vs step-4 engine {push_err}"
    sess_err = max(max_diff(e0.score_session(f"s{i}", user, cands), pairs[i][0], cfg.tasks)
                   for i, (user, _, cands) in enumerate(reqs))
    assert sess_err <= BF16_BATCH_TOL, f"K: refreshed session vs request {sess_err}"
    t = time.perf_counter()
    e4.reload(checkpoint_dir=ck)
    torch.cuda.synchronize()
    reload_s = time.perf_counter() - t

    # 4. a malformed push raises and leaves E0 as it was
    name = next(k for k in loaded["dense"] if k.startswith("blocks."))
    bad = dict(loaded, dense=dict(loaded["dense"], **{name: loaded["dense"][name][:-1]}))
    bad_path = os.path.join(ck, "push_bad.npz")
    save_push(bad, bad_path)
    for attempt in (lambda: e0.apply_push(bad),
                    lambda: e0.apply_push(load_push(bad_path, e0.state_dict(), tables))):
        try:
            attempt()
        except ValueError:
            pass
        else:
            raise AssertionError("K: a malformed push was applied")
    after, got = counted(fa, lambda: [e0.score_request(*r) for r in reqs],
                         {"band_attn_mh_fwd": 1}, K_SESSIONS)
    add(got)
    assert after == [a for a, _ in pairs], "K: a refused push changed E0's scores"
    assert all(torch.equal(e0.state_dict()[k], ref[k]) for k in ref)
    shutil.rmtree(K_DIR)

    log(f"phase K: OneTrans-S TA config (rowwise, bf16, dropout 0.1), batch {K_BATCH}, "
        f"{K_ITEMS} items/sequence | checkpoint {ck_bytes} bytes, save n={len(save_s)} "
        f"{', '.join(f'{x:.3f}' for x in save_s)} s, trainer restore "
        f"{restore_s[0]:.3f} s, engine from_checkpoint "
        f"{engine_load_s:.3f} s | resumed vs unbroken at step 4: loss {loss_err:.2e}, "
        f"params {param_err:.2e} | push 2->4: {push_bytes} bytes on disk "
        f"({push_nbytes(loaded)} in memory), checkpoint/push {ck_bytes / push_bytes:.2f}x, "
        f"apply_push {apply_s:.3f} s ({K_SESSIONS} sessions refreshed), reload "
        f"(checkpoint_dir) {reload_s:.3f} s | pushed state == step-4 state bit for bit; "
        f"score_request vs step-4 engine {push_err:.2e}, session vs request {sess_err:.2e}; "
        f"malformed push refused, scores unchanged | setup+run "
        f"{time.perf_counter() - t0:.1f} s [{CARD}]")
    del e0
    torch.cuda.empty_cache()
    return cfg, e4, batches, reqs


# ---------------------------------------------------------------------------
# phase D: the DIN baseline, offline evaluation, latency and MFU
# ---------------------------------------------------------------------------

N_DIN_WARMUP, N_DIN = 3, 10
DIN_CHECK_BATCH = 32
DIN_F32_LOSS_TOL = 1e-5  # relative, card against CPU
D_USERS = 64  # users of phase D's validation stream


def din_eval_phase(fa, totals, k_out, ta_examples_per_s):
    import dataclasses

    import numpy as np
    import torch

    from recommend_tpu_torch.convert import init_params
    from recommend_tpu_torch.data.pipeline import ranking_batches
    from recommend_tpu_torch.data.synthetic import make_ranking_data
    from recommend_tpu_torch.evaluation.benchmark import (
        latency_benchmark, mfu, peak_flops, ranking_model_flops)
    from recommend_tpu_torch.evaluation.ranking_eval import RankingEvaluator
    from recommend_tpu_torch.models.din import DINRankingModel
    from recommend_tpu_torch.models.ranking import RankingModel
    from recommend_tpu_torch.training.ranking_trainer import RankingTrainer

    t0 = time.perf_counter()
    cfg, e4, batches, reqs = k_out
    with torch.device("meta"):
        din = DINRankingModel(cfg)
    trainer = RankingTrainer(cfg, model=din, device="cuda")
    state = trainer.init_state(init_params(cfg, seed=SEED, device="cuda", model=din))
    dev = [trainer._put_batch(b) for b in batches]
    gen = torch.Generator().manual_seed(SEED)
    times, losses = [], []

    def run():
        nonlocal state
        for i in range(N_DIN_WARMUP + N_DIN):
            t = time.perf_counter()
            state, m = trainer._train_step(state, dev[i % len(dev)], gen)
            loss = float(m["loss"])  # waits for the step
            if i >= N_DIN_WARMUP:
                times.append((time.perf_counter() - t) * 1e3)
            losses.append(loss)

    add = lambda got: [totals.__setitem__(k, totals[k] + v) for k, v in got.items()]
    add(counted(fa, run, {}, 1)[1])  # DIN runs no kernel
    assert all(np.isfinite(losses)), f"D: non-finite DIN loss {losses}"

    # one float32 step on the card against the same step on the CPU, from
    # the same weights, at batch DIN_CHECK_BATCH (dropout off: the card's and
    # the CPU's generators draw different masks from one seed). The model
    # computes in its own config's dtype, so it is built from the f32 one.
    c32 = dataclasses.replace(cfg, use_mixed_precision=False, dropout_rate=0.0)
    with torch.device("meta"):
        din32 = DINRankingModel(c32)
    small = {g: ({k: v[:DIN_CHECK_BATCH] for k, v in batches[0][g].items()})
             for g in ("non_seq", "sequences", "seq_valid", "labels")}
    cpu_params = init_params(c32, seed=SEED + 1, device="cpu", model=din32)
    step_loss = {}
    for device in ("cuda", "cpu"):
        tr = RankingTrainer(c32, model=din32, device=device)
        st = tr.init_state(cpu_params)
        _, m = tr._train_step(st, tr._put_batch(small))
        step_loss[device] = float(m["loss"])
        del tr, st
    del cpu_params
    din_err = abs(step_loss["cuda"] - step_loss["cpu"]) / abs(step_loss["cpu"])
    assert din_err <= DIN_F32_LOSS_TOL, f"D: f32 DIN step, card vs CPU {din_err}"

    # offline evaluation of DIN and of phase K's step-4 OneTrans, same batches
    val = make_ranking_data(cfg, num_samples=4 * K_BATCH, max_seq_per_feature=K_ITEMS,
                            seed=SEED + 1)
    val_batches = list(ranking_batches(val, cfg, batch_size=K_BATCH, seed=SEED,
                                       num_epochs=1))[:4]
    for b in val_batches:
        # the generator draws each row's user from 1M: fold them onto
        # D_USERS, so each user has impressions of both labels and UAUC is
        # defined
        b["non_seq"]["user_id"] = b["non_seq"]["user_id"] % D_USERS
    with torch.device("meta"):
        onetrans = RankingModel(cfg)
    reports = {}
    for label, model, params, per_batch in (
            ("DIN", din, state.params, {}),
            ("OneTrans", onetrans, e4.state_dict(), TRAIN_PHASES[0][4])):
        ev = RankingEvaluator(cfg, model, params, device="cuda")
        ev.evaluate(iter(val_batches[:1]))  # first call outside the report
        fwd = {k: v for k, v in per_batch.items() if k.endswith("_fwd")}
        reports[label], got = counted(fa, lambda: ev.evaluate(iter(val_batches)), fwd,
                                      len(val_batches))
        add(got)
        r = reports[label]
        assert r["num_samples"] == len(val_batches) * K_BATCH
        assert all(0.0 <= r[f"{t}_auc"] <= 1.0 for t in cfg.tasks), r

    # latency of score_request on the step-4 engine
    user, seqs, cands = reqs[0]
    lat, got = counted(fa, lambda: latency_benchmark(
        lambda: e4.score_request(user, seqs, cands), n_iters=50, warmup=5,
        batch_size=N_CANDIDATES, device="cuda"), {"band_attn_mh_fwd": 55}, 1)
    add(got)

    # MFU of phase TA's step
    s_len = len(cfg.sequence_features) * (K_ITEMS + 1) - 1
    flops = ranking_model_flops(cfg, s_len, training=True)
    ta_mfu = mfu(ta_examples_per_s, flops)
    evals = " | ".join(
        f"eval {label}: ctr AUC {r['ctr_auc']:.4f} UAUC {r['ctr_uauc']:.4f}, cvr AUC "
        f"{r['cvr_auc']:.4f} UAUC {r['cvr_uauc']:.4f}, {r['throughput_samples_per_s']:.1f} "
        f"samples/s" for label, r in reports.items())
    log(f"phase D: DIN at the TA config (dropout 0.1), batch {K_BATCH} | train step "
        f"n={len(times)} p50 {np.percentile(times, 50):.3f} ms p99 "
        f"{np.percentile(times, 99):.3f} ms, loss first {losses[0]:.4f} last "
        f"{losses[-1]:.4f} | f32 step at batch {DIN_CHECK_BATCH}: card {step_loss['cuda']:.7f}, "
        f"CPU {step_loss['cpu']:.7f}, rel {din_err:.2e} | {evals} | score_request "
        f"latency_benchmark n=50 p50 {lat['latency_ms_p50']:.3f} ms p99 "
        f"{lat['latency_ms_p99']:.3f} ms | TA step: {ta_examples_per_s:.1f} examples/s x "
        f"{flops / 1e9:.4f} GFLOP/example (s_len {s_len}, training) = MFU {ta_mfu:.3f}% of "
        f"{peak_flops() / 1e12:.1f} TFLOP/s dense bf16 | {time.perf_counter() - t0:.1f} s "
        f"[{CARD}]")
    del trainer, state, e4
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase R: retrieval serving at the flagship corpus
# ---------------------------------------------------------------------------

R_CORPUS = 10_000_000  # retrieval_flagship's video vocabulary
R_BATCH, R_TOPK = 64, 100
R_SEARCH_CALLS = 20  # timed searches per variant and batch size
R_IVF_CLUSTERS, R_IVF_NPROBE, R_IVF_ITERS = 4096, 16, 5
R_IVF_QUERY_USERS = 16  # users per IVF probe gather ([64, 16, cap, D] int8)
# the IVF check: a full probe against the flat scan, two builds bit-equal
R_CHECK_ITEMS, R_CHECK_CLUSTERS = 100_000, 256
R_USERS, R_REC_CALLS = 8, 200  # recommender sessions and requests
R_APPEND = 1000  # items the update_items check appends
# The evaluator's corpus is cut to 100k videos: make_retrieval_data draws
# each user's history with an rng.choice over a V-entry p, O(V) host work
# per user, and evaluate_classification one per batch.
R_EVAL_USERS, R_EVAL_VIDEOS, R_EVAL_BATCHES = 1000, 100_000, 64
R_TOWER_TOL = 1e-5  # float32 tower, card against CPU, of max|ref|
R_SCORE_RTOL = 1e-6  # chunked against one-shot scans, relative
# Top-100 recall of the int8 searches against the exact scan: the int8 rows
# read 0.9841 on the H100 at this corpus; an index whose corpus is assigned
# once searched a top 0 here and read 0.
R_INT8_RECALL_MIN = 0.97


def _recall(ref_ids, got_ids) -> float:
    """Mean per-query overlap of the top-k id sets."""
    import numpy as np

    return float(np.mean([len(set(r.tolist()) & set(g.tolist())) / len(r)
                          for r, g in zip(np.asarray(ref_ids), np.asarray(got_ids))]))


def _same_topk(label, got, ref):
    """The same id set per row, and the sorted scores within R_SCORE_RTOL."""
    import numpy as np

    (gs, gi), (rs, ri) = [[np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in p]
                          for p in (got, ref)]
    for row, (a, b) in enumerate(zip(gi, ri)):
        assert set(a.tolist()) == set(b.tolist()), f"R: {label}: row {row} ids differ"
    gs, rs = np.sort(gs, axis=1), np.sort(rs, axis=1)
    err = float(np.max(np.abs(gs - rs) / np.maximum(np.abs(rs), 1e-30)))
    assert err <= R_SCORE_RTOL, f"R: {label}: scores differ by {err}"
    return err


def _ms(fn, calls):
    """Host-clock ms of ``calls`` calls after one warm-up; each call ends in
    a host copy or a synchronize."""
    import numpy as np

    fn()
    out = []
    for _ in range(calls):
        t = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t) * 1e3)
    return np.asarray(out)


def _corpus_and_histories(cfg, corpus, rng):
    """The JAX serving bench's synthetic corpus (examples/
    flagship_serving_bench.py:55-71) and R_BATCH left-padded histories of
    10..max_seq_len items."""
    import numpy as np

    feats = {
        "video_id": np.arange(corpus, dtype=np.int64),
        "category": rng.integers(1, cfg.category_vocab_size, corpus),
        "tag": rng.integers(1, cfg.tag_vocab_size, corpus),
        "duration": rng.uniform(5, 300, corpus).astype(np.float32),
        "timestamp": np.full(corpus, 1_700_000_000, np.int64),
    }
    l = cfg.max_seq_len
    watched = rng.integers(0, corpus, (R_BATCH, l))
    hist = {k: v[watched] for k, v in feats.items()}
    hist["timestamp"] = hist["timestamp"] + rng.integers(0, 86_400 * 30, (R_BATCH, l))
    valid = np.arange(l)[None, :] >= l - rng.integers(10, l + 1, (R_BATCH, 1))
    for k in hist:
        hist[k] = np.where(valid, hist[k], 0).astype(hist[k].dtype)
    return feats, hist, valid


def retrieval_phase(device="cuda", corpus=R_CORPUS, ivf_clusters=R_IVF_CLUSTERS,
                    check_items=R_CHECK_ITEMS, check_clusters=R_CHECK_CLUSTERS,
                    eval_videos=R_EVAL_VIDEOS, eval_users=R_EVAL_USERS):
    """R: the retrieval serving path at the flagship corpus, held to its
    gates (the sizes are arguments so the phase rehearses on the CPU)."""
    import dataclasses

    import numpy as np
    import torch

    from recommend_tpu_torch.config import get_config
    from recommend_tpu_torch.convert import init_retrieval_params
    from recommend_tpu_torch.data.pipeline import retrieval_batches
    from recommend_tpu_torch.data.synthetic import make_retrieval_data
    from recommend_tpu_torch.evaluation.retrieval_eval import RetrievalEvaluator
    from recommend_tpu_torch.models.retrieval import load_tower
    from recommend_tpu_torch.ops.ivf import build_ivf, ivf_search_interests
    from recommend_tpu_torch.ops.topk import (
        matmul_f32, quantize_corpus, score_items, topk_retrieval, topk_retrieval_quantized)
    from recommend_tpu_torch.serving.retrieval_service import (
        RealTimeRecommender, RetrievalIndex)

    t0 = time.perf_counter()
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = get_config("retrieval_flagship", dropout_rate=0.0, top_k=R_TOPK,
                     video_vocab_size=corpus)
    params = init_retrieval_params(cfg, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    corpus_feats, hist, valid = _corpus_and_histories(cfg, corpus, rng)
    feats = {k: torch.as_tensor(v, device=dev) for k, v in hist.items()}
    valid_t = torch.as_tensor(valid, device=dev)
    notes = []

    # the float32 tower: card against CPU, same state dict and histories
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.no_grad():
        on_card = load_tower(c32, params, dev)(feats, valid_t).cpu()
        cpu_params = {k: v.cpu() for k, v in params.items()}
        on_cpu = load_tower(c32, cpu_params, torch.device("cpu"))(
            {k: v.cpu() for k, v in feats.items()}, valid_t.cpu())
    del cpu_params
    tower_err = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
    assert tower_err <= R_TOWER_TOL, f"R: f32 tower, card vs CPU {tower_err}"

    # the flat index: the corpus through the item tower
    index = RetrievalIndex(cfg, params, embed_batch=8192, device=dev)
    t = time.perf_counter()
    index.build(corpus_feats)
    sync()
    build_s = time.perf_counter() - t
    items = index.item_embeddings
    with torch.no_grad():
        ints64 = index.model(feats, valid_t)
    ints1 = ints64[:1]

    # chunked scans against one-shot ones (the [64, V] float32 matrix)
    exact = topk_retrieval(ints64, items, R_TOPK)
    flat_err = _same_topk("flat scan", exact, torch.topk(score_items(ints64, items), R_TOPK))
    q_items, q_scales = quantize_corpus(items)
    b, ki, d = ints64.shape
    one_shot = matmul_f32(ints64.reshape(b * ki, d).to(torch.bfloat16),
                          q_items.to(torch.bfloat16).T).reshape(b, ki, -1).amax(dim=1)
    int8_err = _same_topk("int8 scan",
                          topk_retrieval_quantized(ints64, q_items, q_scales, R_TOPK),
                          torch.topk(one_shot * q_scales[None, :], R_TOPK))
    del one_shot
    exact_ids = exact[1].cpu().numpy()

    variants = [("flat exact", index)]
    for label, kw in (("int8", {}), ("int8 approx_recall=0.99", {"approx_recall": 0.99})):
        v = RetrievalIndex(cfg, params, quantize="int8", device=dev, **kw)
        v.item_embeddings, v.q_items, v.q_scales = items, q_items, q_scales
        variants.append((label, v))
    notes.append("approx_recall=0.99 runs the exact top k (no approx_max_k in PyTorch)")
    report = {}
    for label, v in variants:
        r = {"recall": _recall(exact_ids, v.search(ints64, R_TOPK)[1])}
        for tag, ints in (("b1", ints1), ("b64", ints64)):
            lat = _ms(lambda: v.search(ints, R_TOPK), R_SEARCH_CALLS)
            r[tag] = lat
        r["qps"] = R_BATCH * 1e3 / r["b64"].mean()

        def once():
            with torch.no_grad():
                return v.search(index.model({k: x[:1] for k, x in feats.items()},
                                            valid_t[:1]), R_TOPK)

        r["e2e"] = _ms(once, R_SEARCH_CALLS)
        report[label] = r
        if v.quantize == "int8":
            assert r["recall"] >= R_INT8_RECALL_MIN, \
                f"R: {label} top-100 recall vs exact {r['recall']:.4f} < {R_INT8_RECALL_MIN}"
    del variants

    # the scans alone on the card (CUDA events) against their bound: the
    # corpus (and, int8, its scales) read once over the memory rate, or the
    # bf16 products (int8 rows are multiplied as bf16) over the bf16 peak
    scans = {}
    for label, scan, nbytes in (
            ("flat", lambda x: topk_retrieval(x, items, R_TOPK),
             items.numel() * items.element_size()),
            ("int8", lambda x: topk_retrieval_quantized(x, q_items, q_scales, R_TOPK),
             q_items.numel() + 4 * q_scales.numel())):
        for tag, ints in (("b1", ints1), ("b64", ints64)):
            io = ints.numel() * ints.element_size() + ints.shape[0] * R_TOPK * (4 + 8)
            by_bytes = (nbytes + io) / PEAK_BYTES * 1e3
            by_ops = 2 * ints.shape[0] * ki * d * corpus / PEAK_FLOPS["bfloat16"] * 1e3
            ms = (cuda_ms(lambda: scan(ints), R_SEARCH_CALLS) if dev.type == "cuda"
                  else float("nan"))
            scans[f"{label} {tag}"] = (ms, max(by_bytes, by_ops),
                                       "bytes" if by_bytes >= by_ops else "operations")

    # IVF at the flagship corpus, then the check size
    cap = int(corpus / ivf_clusters * 2.5)
    t = time.perf_counter()
    ivf = build_ivf(items, n_clusters=ivf_clusters, capacity=cap, quantize="int8",
                    iters=R_IVF_ITERS)
    sync()
    ivf_build_s = time.perf_counter() - t

    def ivf_search(ints):
        return ivf_search_interests(ivf, ints, R_TOPK, nprobe=R_IVF_NPROBE,
                                    query_chunk=R_IVF_QUERY_USERS * ki)

    ivf_recall = _recall(exact_ids, ivf_search(ints64)[1])
    ivf_lat = {tag: _ms(lambda: ivf_search(ints), R_SEARCH_CALLS)
               for tag, ints in (("b1", ints1), ("b64", ints64))}
    ivf_gb = (ivf.bucket_embs.numel() + 4 * ivf.bucket_scales.numel()) / 1e9
    del ivf
    check = items[:check_items]
    first = build_ivf(check, n_clusters=check_clusters, iters=R_IVF_ITERS)
    again = build_ivf(check, n_clusters=check_clusters, iters=R_IVF_ITERS)
    for name, a, c in zip(first._fields, first, again):
        assert a is None and c is None or torch.equal(a, c), f"R: two IVF builds differ in {name}"
    full = ivf_search_interests(first, ints64, R_TOPK, nprobe=check_clusters, query_chunk=16)
    probe_err = _same_topk("full-probe IVF", full, topk_retrieval(ints64, check, R_TOPK))
    check_cap = first.capacity
    del first, again, check

    # the recommender: sessions from the histories, one new item a request
    rec = RealTimeRecommender(cfg, params, index, device=dev)
    for u in range(R_USERS):
        for p in np.nonzero(valid[u])[0]:
            rec.add_interaction(u, {k: hist[k][u, p].item() for k in hist})
    for n in range(R_REC_CALLS):
        u = n % R_USERS
        out = rec.get_recommendations(u, top_k=R_TOPK)
        seen = {it["video_id"] for it in rec.sessions[u]}
        assert len(out) == R_TOPK and not seen & {r["video_id"] for r in out}, \
            f"R: request {n} recommended a seen item"
        rec.add_interaction(u, {k: corpus_feats[k][out[0]["video_id"]].item()
                                for k in corpus_feats})
    rec_stats = rec.stats()
    u = 0
    seen = {it["video_id"] for it in rec.sessions[u]}
    got = rec.get_recommendations(u, top_k=R_TOPK)
    s, i = index.search(rec.user_interests(u), R_TOPK + len(seen))
    want = [(int(a), float(c)) for c, a in zip(s[0], i[0]) if int(a) not in seen][:R_TOPK]
    assert [(r["video_id"], r["score"]) for r in got] == want, \
        "R: the recommender's results differ from index.search"
    similar = rec.similar_to(0, top_k=10)
    assert len(similar) == 10 and all(r["video_id"] != 0 for r in similar)
    del rec  # the flat index stays for phase RT's hand-off

    # incremental update: an index over all but the last R_APPEND items
    # takes them as an append (new uploads), then a refresh re-embeds all
    part = RetrievalIndex(cfg, params, embed_batch=8192, device=dev)
    part.build({k: v[:corpus - R_APPEND] for k, v in corpus_feats.items()})
    t = time.perf_counter()
    part.update_items({k: v[corpus - R_APPEND:] for k, v in corpus_feats.items()})
    sync()
    update_s = time.perf_counter() - t
    # the appended rows went through the tower in another batch shape than a
    # build's, so a product may round differently: bf16 tolerance
    append_err = float((part.item_embeddings.float() - items.float()).abs().max()
                       / items.float().abs().max())
    assert append_err <= BF16_REL_TOL, f"R: build + append vs a build {append_err}"
    t = time.perf_counter()
    part.refresh(params)
    sync()
    refresh_s = time.perf_counter() - t
    assert torch.equal(part.item_embeddings, items), "R: refresh with the same weights changed rows"
    del part, items, q_items, q_scales

    # offline evaluation on a 100k-video corpus
    t = time.perf_counter()
    data = make_retrieval_data(cfg, num_users=eval_users, num_videos=eval_videos, seed=SEED)
    batches = list(retrieval_batches(data, cfg, batch_size=R_BATCH, seed=SEED,
                                     num_epochs=1))[:R_EVAL_BATCHES]
    data_s = time.perf_counter() - t
    ev = RetrievalEvaluator(cfg, params, device=dev)
    ev.evaluate_retrieval(data, batches[:1])  # builds the index, first call
    t = time.perf_counter()
    metrics = ev.evaluate_retrieval(data, batches)
    eval_s = time.perf_counter() - t
    t = time.perf_counter()
    cls = ev.evaluate_classification(data, batches[:16])
    cls_s = time.perf_counter() - t
    for name, x in {**metrics, **cls}.items():
        assert 0.0 <= x <= 1.0, f"R: evaluator {name} = {x}"
    assert metrics["recall@1"] <= metrics["recall@10"] <= metrics["recall@100"]
    lat = ev.benchmark_latency(batches[0], n_iters=20, warmup=3)
    del ev, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    p = lambda a, q: float(np.percentile(a, q))
    lines = [f"phase R: retrieval_flagship (d {cfg.embed_dim}, {cfg.num_layers} layers, "
             f"{cfg.num_heads} heads, {cfg.max_seq_len} items -> "
             f"{cfg.num_compressed_tokens} tokens + {cfg.num_query_tokens} queries, bf16), "
             f"corpus {corpus} items, batch {R_BATCH}, top {R_TOPK} | flat index build "
             f"{build_s:.3f} s ({corpus / build_s:.0f} items/s) | f32 tower card vs CPU "
             f"{tower_err:.2e} | chunked vs one-shot scan: flat ids equal, scores "
             f"{flat_err:.2e}; int8 ids equal, scores {int8_err:.2e} | " + "; ".join(notes)]
    for label, r in report.items():
        lines.append(
            f"phase R search {label}: top-100 recall vs exact {r['recall']:.4f} | batch 1 "
            f"n={R_SEARCH_CALLS} p50 {p(r['b1'], 50):.3f} ms p99 {p(r['b1'], 99):.3f} ms | "
            f"batch 64 p50 {p(r['b64'], 50):.3f} ms p99 {p(r['b64'], 99):.3f} ms, "
            f"{r['qps']:.1f} QPS | end to end (encode + search) batch 1 p50 "
            f"{p(r['e2e'], 50):.3f} ms p99 {p(r['e2e'], 99):.3f} ms")
    lines.append("phase R scan on the card (topk_retrieval / topk_retrieval_quantized, CUDA "
                 f"events, n={R_SEARCH_CALLS}): " + "; ".join(
                     f"{k} {ms:.3f} ms, bound {b:.4f} ms ({by}), {b / ms:.1%} of it"
                     for k, (ms, b, by) in scans.items()))
    lines.append(
        f"phase R IVF: {ivf_clusters} clusters, capacity {cap}, int8 ({ivf_gb:.2f} GB of "
        f"buckets), {R_IVF_ITERS} iterations, build {ivf_build_s:.3f} s | nprobe "
        f"{R_IVF_NPROBE}, query chunks of {R_IVF_QUERY_USERS} users: top-100 recall vs exact "
        f"{ivf_recall:.4f} (not gated) | batch 1 p50 {p(ivf_lat['b1'], 50):.3f} ms | batch 64 "
        f"p50 {p(ivf_lat['b64'], 50):.3f} ms, {R_BATCH * 1e3 / ivf_lat['b64'].mean():.1f} QPS "
        f"| check at {check_items} items, {check_clusters} clusters (capacity {check_cap}): "
        f"two builds bit-equal, full probe vs flat scan ids equal, scores {probe_err:.2e}")
    lines.append(
        f"phase R recommender: {rec_stats['requests']} requests over {R_USERS} sessions, "
        f"p50 {rec_stats['latency_ms_p50']:.3f} ms p99 {rec_stats['latency_ms_p99']:.3f} ms; "
        f"no seen item; scores == index.search | an index of {corpus - R_APPEND} items: "
        f"update_items append of the last {R_APPEND} {update_s:.3f} s, refresh (re-embeds "
        f"{corpus}) {refresh_s:.3f} s; appended rows vs a full build {append_err:.2e}, "
        f"refreshed rows bit-equal to it")
    lines.append(
        f"phase R evaluator: {eval_users} users, {eval_videos} videos (cut from the 10M "
        f"corpus: O(V) host draws per user; data + batches {data_s:.1f} s), "
        f"{len(batches)} batches of {R_BATCH} | "
        + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
        + f" | {len(batches) * R_BATCH / eval_s:.1f} samples/s | classification AUC "
        f"{cls['auc']:.4f}, AP {cls['average_precision']:.4f}, "
        f"{16 * R_BATCH / cls_s:.1f} samples/s | benchmark_latency batch {lat['batch_size']} "
        f"p50 {lat['latency_ms_p50']:.3f} ms p99 {lat['latency_ms_p99']:.3f} ms | "
        f"phase {time.perf_counter() - t0:.1f} s")
    for line in lines:
        log(f"{line} [{CARD}]")
    return cfg, index, feats, valid_t


# ---------------------------------------------------------------------------
# phase RT: the retrieval trainer at the flagship config, handed to phase R's
# index
# ---------------------------------------------------------------------------

# retrieval_flagship's own batch (256) and full widths, 10M-row video table.
# make_retrieval_data draws each user's history with an rng.choice over a
# V-entry p (O(V) host work per user): 200 users give ~5,000 examples, enough
# for RT_BATCHES batches of 256, which the timed steps cycle.
RT_USERS, RT_BATCHES = 200, 10
RT_CHECK_VOCAB = 100_000  # the card-vs-CPU and resume checks' video table
# One float32 step, dropout 0, card against CPU from one state: the loss and
# the dense gradient norm relative to their value, each dense gradient
# against its tensor's largest entry, the tables and accumulators (rowwise
# adagrad, smooth in the gradient) elementwise. Adam's first step moves an
# element by lr·g/(|g| + 1e-8), which takes the sign of a gradient within
# rounding of 0 (every attention key bias has a zero true gradient: it adds
# one constant to a softmax row): so the card's parameters are held to adamw
# applied on the CPU to the card's own gradients, and their distance from
# the CPU run's is printed.
RT_LOSS_RTOL, RT_NORM_RTOL = 1e-5, 1e-4
RT_STATE_ATOL, RT_STATE_RTOL = 1e-5, 1e-4
RT_GRAD_TOL = 1e-4
RT_DIR = Path(__file__).resolve().parent / "build" / "phase_rt"


def _spy_grads(trainer):
    """Keep the dense gradients each step hands the optimizer."""
    seen = {}
    step = trainer.optimizer.step

    def wrapper(params, grads, state):
        seen.update({k: v.detach().cpu() for k, v in grads.items()})
        return step(params, grads, state)

    trainer.optimizer.step = wrapper
    return seen


def _card_vs_cpu_step(cfg, mode, batch, device):
    """One float32 step of ``mode`` on ``device`` and on the CPU from the
    same state and masked positions -> the gate readings."""
    import numpy as np
    import torch

    from recommend_tpu_torch.convert import init_retrieval_params
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    params = init_retrieval_params(cfg, seed=SEED, device="cpu")
    pos = None
    out = {}
    for dev in (device, "cpu"):
        tr = RetrievalTrainer(cfg, mode=mode, device=dev)
        if pos is None and mode == "masked":
            pos = tr.draw_mask_positions(cfg.batch_size, torch.Generator().manual_seed(SEED))
        grads = _spy_grads(tr)
        st = tr.init_state(params)
        st, m = tr._train_step(st, tr._put_batch(batch), mask_positions=pos)
        out[dev] = ({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in st.params.items()},
                    {k: v.cpu() for k, v in st.opt_state[1].items()}, grads)
    (m1, p1, a1, g1), (m0, p0, a0, g0) = out[device], out["cpu"]
    assert np.isfinite(m1["loss"]), f"RT: {mode} f32 step loss {m1['loss']}"
    loss_err = abs(m1["loss"] - m0["loss"]) / abs(m0["loss"])
    norm_err = abs(m1["grad_norm"] - m0["grad_norm"]) / abs(m0["grad_norm"])
    assert loss_err <= RT_LOSS_RTOL, f"RT: {mode} f32 step loss, card vs CPU {loss_err}"
    assert norm_err <= RT_NORM_RTOL, f"RT: {mode} f32 step grad norm, card vs CPU {norm_err}"
    grad_err = max(float((g1[k] - g).abs().max() / g.abs().max()) for k, g in g0.items()
                   if not k.endswith("attn.k_proj.bias"))
    assert grad_err <= RT_GRAD_TOL, f"RT: {mode} f32 step gradients, card vs CPU {grad_err}"
    # adamw on the CPU from the same start, on the card's gradients
    expect = {k: params[k].clone() for k in g1}
    opt = tr.optimizer
    type(opt).step(opt, expect, g1, opt.init(expect))
    param_err = max(float(((p1[k] - v).abs() / (RT_STATE_ATOL + RT_STATE_RTOL * v.abs())).max())
                    for k, v in expect.items())
    assert param_err <= 1, f"RT: {mode} f32 step parameters vs adamw of the card's gradients"
    for name in a0:
        for got, ref, what in ((p1[name], p0[name], "table"), (a1[name], a0[name], "accumulator")):
            ok = (got - ref).abs() <= RT_STATE_ATOL + RT_STATE_RTOL * ref.abs()
            assert bool(ok.all()), f"RT: {mode} f32 step {what} {name}, card vs CPU"
    off = sum(int(((p1[k] - p0[k]).abs() > RT_STATE_ATOL + RT_STATE_RTOL * p0[k].abs()).sum())
              for k in g0)
    cpu_diff = max(float((p1[k] - p0[k]).abs().max()) for k in g0)
    return loss_err, norm_err, grad_err, param_err, off, cpu_diff


def _same_state(a, b) -> bool:
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same_state(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_state(x, y) for x, y in zip(a, b))
    return a == b


def _trace(fn, n):
    """(kernels, device-busy ms) per call of ``fn`` over ``n`` calls in a
    ``torch.profiler`` trace (CUDA activity; the CPU's alone elsewhere)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    kernels = [ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels) / n, sum(kernels) / 1e3 / n


def retrieval_training_phase(r_out, device="cuda", vocab=R_CORPUS, users=RT_USERS,
                             check_vocab=RT_CHECK_VOCAB, ivf_clusters=R_IVF_CLUSTERS,
                             timed_steps=N_TRAIN, batch_size=None):
    """RT: ``RetrievalTrainer`` at ``retrieval_flagship`` (the sizes are
    arguments so the phase rehearses on the CPU), held to its gates, then
    its state handed to phase R's flat index through ``refresh``."""
    import dataclasses
    import itertools
    import shutil

    import numpy as np
    import torch

    from recommend_tpu_torch.config import get_config
    from recommend_tpu_torch.data.pipeline import retrieval_batches
    from recommend_tpu_torch.data.synthetic import make_retrieval_data
    from recommend_tpu_torch.ops.ivf import build_ivf, ivf_search_interests
    from recommend_tpu_torch.serving.retrieval_service import RetrievalIndex
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    t0 = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    r_cfg, index, r_feats, r_valid = r_out
    cfg = get_config("retrieval_flagship", video_vocab_size=vocab)
    assert (cfg.batch_size, cfg.compute_dtype, cfg.dropout_rate, cfg.sparse_update_mode,
            cfg.sparse_scatter_budget) == (256, "bfloat16", 0.1, "rowwise", 16_384)
    if batch_size is not None:  # a CPU rehearsal
        cfg = dataclasses.replace(cfg, batch_size=batch_size)
    data = make_retrieval_data(cfg, num_users=users, num_videos=vocab, seed=SEED)
    it = retrieval_batches(data, cfg, batch_size=cfg.batch_size, seed=SEED)
    host = [next(it) for _ in range(RT_BATCHES)]
    data_s = time.perf_counter() - t0
    valid_rows = [int(b["history_valid"].sum()) + cfg.batch_size for b in host]

    # 1. one float32 step per mode, card against CPU, at the cut video table
    c32 = dataclasses.replace(cfg, video_vocab_size=check_vocab, compute_dtype="float32",
                              dropout_rate=0.0, warmup_steps=0)
    small = dict(host[0], history=dict(host[0]["history"]), target=dict(host[0]["target"]))
    small["history"]["video_id"] = host[0]["history"]["video_id"] % check_vocab
    small["target"]["video_id"] = host[0]["target"]["video_id"] % check_vocab
    checks = {mode: _card_vs_cpu_step(c32, mode, small, dev)
              for mode in ("single", "seq2seq", "masked")}
    check_s = time.perf_counter() - t0 - data_s

    # 2. three steps of train() twice from one seed: bit-equal
    runs = []
    for _ in range(2):
        tr = RetrievalTrainer(cfg, device=dev)
        st = tr.train(itertools.cycle(host), 3, log_every=1, seed=SEED)
        runs.append((tr.history["train"], st))
    (h1, trained), (h2, other) = runs
    assert [h["loss"] for h in h1] == [h["loss"] for h in h2], "RT: two seeded runs' losses differ"
    assert _same_state(trained.params, other.params), "RT: two seeded runs' parameters differ"
    assert _same_state(trained.opt_state, other.opt_state), "RT: two seeded runs' states differ"
    assert all(h["sparse_dropped_rows"] == 0 for h in h1), "RT: the scatter budget dropped rows"
    del runs, other, tr

    # 3. resume from a step-2 checkpoint at the cut video table, against an
    # unbroken run (the 10M-row table would make each checkpoint 5.2 GB)
    rcfg = dataclasses.replace(cfg, video_vocab_size=check_vocab)
    shutil.rmtree(RT_DIR, ignore_errors=True)
    saving = RetrievalTrainer(rcfg, checkpoint_dir=str(RT_DIR), max_to_keep=2, device=dev)
    saving.train(iter([small] * 2), 2, log_every=1, seed=SEED)
    ck_bytes = os.path.getsize(saving.ckpt.path(2))
    del saving
    resumed = RetrievalTrainer(rcfg, checkpoint_dir=str(RT_DIR), max_to_keep=2, device=dev)
    s_res = resumed.train(iter([small] * 2), 4, log_every=1, seed=SEED)
    whole = RetrievalTrainer(rcfg, device=dev)
    s_all = whole.train(iter([small] * 4), 4, log_every=1, seed=SEED)
    assert [h["step"] for h in resumed.history["train"]] == [3, 4]
    assert resumed.history["train"][-1]["loss"] == whole.history["train"][-1]["loss"], \
        "RT: the resumed run's loss differs from the unbroken run's"
    assert _same_state(s_res.params, s_all.params) and _same_state(
        s_res.opt_state, s_all.opt_state), "RT: the resumed state differs from the unbroken one"
    del resumed, whole, s_res, s_all
    shutil.rmtree(RT_DIR)

    # 4. timing: N_TRAIN_WARMUP + timed_steps steps on batches put on the
    # device once, each ending in reading its loss; at the preset's scatter
    # budget and with none
    timing = {}
    for budget in (cfg.sparse_scatter_budget, 0):
        tcfg = dataclasses.replace(cfg, sparse_scatter_budget=budget)
        tr = RetrievalTrainer(tcfg, device=dev)
        st = tr.init_state(seed=SEED)
        gen = torch.Generator().manual_seed(SEED)
        batches = [tr._put_batch(b) for b in host]
        times, losses, dropped = [], [], []
        for i in range(N_TRAIN_WARMUP + timed_steps):
            t = time.perf_counter()
            st, m = tr._train_step(st, batches[i % len(batches)], gen)
            loss = float(m["loss"])  # waits for the step
            if i >= N_TRAIN_WARMUP:
                times.append((time.perf_counter() - t) * 1e3)
            losses.append(loss)
            dropped.append(int(m.get("sparse_dropped_rows", 0)))
        assert all(np.isfinite(losses)), f"RT: non-finite loss {losses}"
        assert not any(dropped), f"RT: the scatter budget dropped rows {dropped}"

        def step():
            nonlocal st
            st, _ = tr._train_step(st, batches[st.step % len(batches)], gen)

        kernels, busy = _trace(step, 3)
        timing[budget] = (np.asarray(times), losses, kernels, busy)
        del tr, st, batches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")

    # 5. the hand-off: train()'s state into phase R's flat index
    t = time.perf_counter()
    index.refresh(trained.params)
    if on_card:
        torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t
    fresh = RetrievalIndex(r_cfg, trained.params, embed_batch=index.embed_batch, device=dev)
    fresh.build(index._last_corpus)
    assert torch.equal(index.item_embeddings, fresh.item_embeddings), \
        "RT: the refreshed corpus differs from a fresh build's"
    with torch.no_grad():
        ints = fresh.model(r_feats, r_valid)
    for tag, q in (("batch 1", ints[:1]), (f"batch {len(ints)}", ints)):
        (s_a, i_a), (s_b, i_b) = index.search(q, R_TOPK), fresh.search(q, R_TOPK)
        assert np.array_equal(i_a, i_b) and np.array_equal(s_a, s_b), \
            f"RT: {tag}: the refreshed index's top {R_TOPK} differs from a fresh index's"
    exact_ids = index.search(ints, R_TOPK)[1]
    del fresh
    ivf = build_ivf(index.item_embeddings, n_clusters=ivf_clusters,
                    capacity=int(len(index.item_embeddings) / ivf_clusters * 2.5),
                    quantize="int8", iters=R_IVF_ITERS)
    ivf_recall = _recall(exact_ids, ivf_search_interests(
        ivf, ints, R_TOPK, nprobe=R_IVF_NPROBE, query_chunk=R_IVF_QUERY_USERS * ints.shape[1])[1])
    del ivf, trained, index
    if on_card:
        torch.cuda.empty_cache()

    p = lambda a, q: float(np.percentile(a, q))
    lines = [f"phase RT: retrieval_flagship (d {cfg.embed_dim}, {cfg.num_layers} layers, "
             f"{cfg.num_heads} heads, ffn {cfg.ffn_dim}, {cfg.max_seq_len} items -> "
             f"{cfg.num_compressed_tokens} tokens + {cfg.num_query_tokens} queries, bf16, "
             f"dropout {cfg.dropout_rate}, single mode), video table {vocab} rows, rowwise "
             f"sparse updates, batch {cfg.batch_size} | data: {users} users, {RT_BATCHES} "
             f"batches ({min(valid_rows)}-{max(valid_rows)} valid [history ; target] rows "
             f"each) {data_s:.1f} s | one f32 step, dropout 0, video table cut to "
             f"{check_vocab}, card vs CPU ({check_s:.1f} s): " + "; ".join(
                 f"{mode} loss {c[0]:.2e}, grad norm {c[1]:.2e}, gradients {c[2]:.2e} of "
                 f"each tensor's largest, parameters {c[3]:.2f} of the 1e-5/1e-4 tolerance "
                 f"against adamw of the card's gradients (against the CPU run's: {c[4]} "
                 f"elements beyond it, max {c[5]:.2e}), tables and accumulators within it"
                 for mode, c in checks.items())]
    losses3 = ", ".join(f"{h['loss']:.4f}" for h in h1)
    lines.append(
        f"phase RT: train() 3 steps twice from seed {SEED}: losses {losses3} "
        f"bit-equal, every parameter, adamw moment and accumulator bit-equal, "
        f"sparse_dropped_rows 0 | resume at the {check_vocab}-row table: checkpoint "
        f"{ck_bytes} bytes, step 2 -> 4 equals steps 0-4 bit for bit")
    for budget, (tt, ll, kk, bb) in timing.items():
        lines.append(
            f"phase RT train step, scatter budget {budget}: n={len(tt)} p50 {p(tt, 50):.3f} ms "
            f"p99 {p(tt, 99):.3f} ms, {cfg.batch_size * len(tt) / (tt.sum() / 1e3):.1f} "
            f"examples/s | loss first {ll[0]:.4f} last {ll[-1]:.4f} | trace of 3 steps: "
            f"device busy {bb:.3f} ms/step, idle {1 - bb / p(tt, 50):.1%} of the p50, "
            f"{kk:.0f} kernels/step")
    on, off = timing[cfg.sparse_scatter_budget][0], timing[0][0]
    lines.append(
        f"phase RT: budget 0 / budget {cfg.sparse_scatter_budget} step p50 "
        f"{p(off, 50) / p(on, 50):.3f}x | peak memory allocated {peak_gb:.2f} GB (phase R's "
        f"index included) | hand-off: refresh of phase R's flat index ({len(r_valid)} "
        f"histories) {refresh_s:.3f} s, its corpus and its batch 1 / {len(r_valid)} top "
        f"{R_TOPK} (ids and scores) bit-equal to a fresh index's | IVF ({ivf_clusters} "
        f"clusters, int8, nprobe {R_IVF_NPROBE}) top-{R_TOPK} recall vs exact after 3 steps on "
        f"synthetic data {ivf_recall:.4f} (not gated) | phase {time.perf_counter() - t0:.1f} s")
    for line in lines:
        log(f"{line} [{CARD}]")
    return data


# ---------------------------------------------------------------------------
# phase L: LLM4Rec
# ---------------------------------------------------------------------------

# L, distillation: SemanticDistillConfig's own widths, a batch of seeded
# teacher vectors drawn on the card. One float32 forward + loss + backward,
# card against CPU: the loss relative to its value, each gradient against
# its tensor's largest entry (the in-batch softmax sums 4,096 columns in
# another order on each side).
L_DISTILL_BATCH = 4096
L_LOSS_RTOL, L_GRAD_TOL = 1e-5, 1e-4
# L, semantic ids: k-means over phase R's item vectors (the retrieval
# tower's, standing in for LLM item embeddings: no LLM weights are in the
# repository), all but the last L_HELD items, which then take their nearest
# centroid (the cold-start path). A held-back item's centroid is the nearest
# in float64 on the CPU up to the float32 rounding of the assignment's
# x·c - |c|²/2 (128 products): its squared distance exceeds the least by at
# most L_ASSIGN_TOL of |x|² + |c|².
L_CLUSTERS, L_ITERS, L_HELD = 1024, 10, 1000
L_ASSIGN_TOL = 1e-5
# L, intents: users precomputed into the cache; labels per intent axis
L_USERS, L_AXIS_LABELS = 10_000, 8
L_INTENT = "user_intent"


def distill_phase(device="cuda", batch=L_DISTILL_BATCH, passes=N_TRAIN):
    """L, distillation: the semantic-distillation student at its own
    widths, one float32 step held card against CPU, then ``passes`` timed
    forward + loss + backward passes. Returns the student (its user tower
    encodes the intents of ``intent_phase``)."""
    import numpy as np
    import torch

    from recommend_tpu_torch.convert import init_semantic_distill_params
    from recommend_tpu_torch.llm4rec import (
        SemanticDistillConfig,
        SemanticDistillModel,
        semantic_distill_loss,
    )

    t0 = time.perf_counter()
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = SemanticDistillConfig()
    assert (cfg.teacher_dim, cfg.hidden_dim, cfg.num_heads, cfg.head_dim) == (768, 256, 4, 32)
    params = init_semantic_distill_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    user = torch.randn(batch, cfg.teacher_dim, generator=gen, device=dev)
    item = torch.randn(batch, cfg.teacher_dim, generator=gen, device=dev)
    card, cpu = SemanticDistillModel(cfg).to(dev), SemanticDistillModel(cfg)
    card.load_state_dict(params)
    cpu.load_state_dict(params)

    def step(model, u, it):
        model.zero_grad(set_to_none=True)
        loss, metrics = semantic_distill_loss(cfg, model(u, it), u, it)
        loss.backward()
        return loss, metrics

    (l1, m1), (l0, _) = step(card, user, item), step(cpu, user.cpu(), item.cpu())
    l1, l0 = float(l1.detach()), float(l0.detach())
    loss_err = abs(l1 - l0) / abs(l0)
    grad_err = max(float((p1.grad.cpu() - p0.grad).abs().max() / p0.grad.abs().max())
                   for p1, p0 in zip(card.parameters(), cpu.parameters()))
    assert loss_err <= L_LOSS_RTOL, f"L: distill f32 step loss, card vs CPU {loss_err}"
    assert grad_err <= L_GRAD_TOL, f"L: distill f32 step gradients, card vs CPU {grad_err}"
    times = []
    for i in range(passes + 1):  # the first is a warm-up
        t = time.perf_counter()
        loss = float(step(card, user, item)[0].detach())
        assert np.isfinite(loss), f"L: distill loss {loss}"
        sync()
        if i:
            times.append((time.perf_counter() - t) * 1e3)
    card.zero_grad(set_to_none=True)
    p50, p99 = np.percentile(times, 50), np.percentile(times, 99)
    log(f"phase L distill: SemanticDistillConfig (teacher {cfg.teacher_dim}, hidden "
        f"{cfg.hidden_dim}, {cfg.num_heads} heads x {cfg.head_dim}), batch {batch} of seeded "
        f"teacher vectors, float32 | one step card vs CPU: loss {loss_err:.2e}, gradients "
        f"{grad_err:.2e} of each tensor's largest | forward + loss + backward n={len(times)} "
        f"p50 {p50:.3f} ms p99 {p99:.3f} ms, {batch / p50 * 1e3:.1f} examples/s | loss "
        f"{l1:.4f} (match {float(m1['match_loss']):.4f}, user distill "
        f"{float(m1['user_distill_loss']):.4f}, item distill "
        f"{float(m1['item_distill_loss']):.4f}) | phase {time.perf_counter() - t0:.1f} s "
        f"[{CARD}]")
    return card.eval()


def semantic_id_phase(r_out, rt_data, n_clusters=L_CLUSTERS, iters=L_ITERS, held=L_HELD,
                      timed_steps=N_TRAIN, batch_size=None):
    """L, semantic ids: ``build_semantic_ids`` twice over phase R's item
    vectors but the last ``held`` (bit-equal), ``assign`` of the held-back
    items, ``map_ids`` with the padding sentinel, ``remap_retrieval_data`` of
    phase RT's data, and timed ``RetrievalTrainer`` steps over the semantic
    vocabulary (the sizes are arguments so the phase rehearses on the CPU)."""
    import dataclasses

    import numpy as np
    import torch

    from recommend_tpu_torch.config import get_config
    from recommend_tpu_torch.data.pipeline import retrieval_batches
    from recommend_tpu_torch.llm4rec import SemanticIdMap, build_semantic_ids, remap_retrieval_data
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    t0 = time.perf_counter()
    items = r_out[1].item_embeddings  # [V, D], on the index's device
    dev = items.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    v = items.shape[0]
    assert v == rt_data.num_videos, (v, rt_data.num_videos)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    builds, build_s = [], []
    for _ in range(2):
        t = time.perf_counter()
        builds.append(build_semantic_ids(items[:v - held], n_clusters, iters, seed=SEED))
        sync()
        build_s.append(time.perf_counter() - t)
    sid_map, again = builds
    assert torch.equal(sid_map.centroids, again.centroids) and np.array_equal(
        sid_map.item_to_sid, again.item_to_sid), "L: two semantic-id builds differ"
    del builds, again
    sizes = np.bincount(sid_map.item_to_sid, minlength=n_clusters)

    # the cold-start path: the held-back items take their nearest centroid
    t = time.perf_counter()
    cold = sid_map.assign(items[v - held:])
    sync()
    assign_ms = (time.perf_counter() - t) * 1e3
    assert cold.device == dev and cold.dtype == torch.int32 and cold.shape == (held,)
    x, c = items[v - held:].double().cpu(), sid_map.centroids.double().cpu()
    d2 = torch.cdist(x, c).square()
    got = d2.gather(1, cold.cpu().long()[:, None])[:, 0]
    excess = float(((got - d2.min(dim=1).values)
                    / (x.square().sum(1) + c[cold.cpu().long()].square().sum(1))).max())
    assert excess <= L_ASSIGN_TOL, \
        f"L: a held-back item's semantic id is not its nearest centroid ({excess:.2e})"
    full = SemanticIdMap(sid_map.centroids,
                         np.concatenate([sid_map.item_to_sid, cold.cpu().numpy()]))
    ids = np.array([0, v - held - 1, v - held, v - 1, v])  # ..., the padding sentinel v
    mapped = full.map_ids(ids)
    assert list(mapped) == [*full.item_to_sid[ids[:-1]], n_clusters] and \
        sid_map.map_ids(np.array([v - held]))[0] == n_clusters, "L: map_ids"

    # next-semantic-id training on phase RT's data over the semantic ids
    t = time.perf_counter()
    sdata = remap_retrieval_data(rt_data, full)
    remap_s = time.perf_counter() - t
    assert sdata.num_videos == n_clusters and sdata.popularity.sum() == rt_data.popularity.sum()
    cfg = get_config("retrieval_flagship", video_vocab_size=n_clusters + 1,
                     warmup_steps=N_TRAIN_WARMUP)
    assert (cfg.batch_size, cfg.compute_dtype) == (256, "bfloat16")
    if batch_size is not None:  # a CPU rehearsal
        cfg = dataclasses.replace(cfg, batch_size=batch_size)
    it = retrieval_batches(sdata, cfg, cfg.batch_size, seed=SEED)
    host = [next(it) for _ in range(RT_BATCHES)]
    assert all(b["target"]["video_id"].max() < n_clusters for b in host)
    tr = RetrievalTrainer(cfg, device=dev)
    st = tr.init_state(seed=SEED)
    gen = torch.Generator().manual_seed(SEED)
    batches = [tr._put_batch(b) for b in host]
    times, losses = [], []
    for i in range(N_TRAIN_WARMUP + timed_steps):
        t = time.perf_counter()
        st, m = tr._train_step(st, batches[i % len(batches)], gen)
        loss = float(m["loss"])  # waits for the step
        if i >= N_TRAIN_WARMUP:
            times.append((time.perf_counter() - t) * 1e3)
        losses.append(loss)
    assert all(np.isfinite(losses)), f"L: non-finite next-semantic-id loss {losses}"
    del tr, st, batches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else float("nan")
    p50, p99 = np.percentile(times, 50), np.percentile(times, 99)
    log(f"phase L semantic ids: {v - held} of phase R's {v} item vectors ({items.shape[1]} "
        f"dims, {str(items.dtype).split('.')[1]}; the retrieval tower's, standing in for LLM "
        f"embeddings) -> {n_clusters} clusters, {iters} iterations: builds "
        f"{build_s[0]:.2f} / {build_s[1]:.2f} s, bit-equal; cluster sizes min {sizes.min()} "
        f"median {int(np.median(sizes))} max {sizes.max()} | assign of {held} held-back items "
        f"{assign_ms:.2f} ms, each at its nearest centroid (excess {excess:.1e}) | map_ids: "
        f"sentinel {v} -> {n_clusters} | remap of phase RT's data "
        f"({len(rt_data.user_sequences)} users, {rt_data.num_videos} videos) {remap_s:.2f} s | "
        f"next-semantic-id RetrievalTrainer (vocabulary {n_clusters + 1}, batch "
        f"{cfg.batch_size}, {cfg.compute_dtype}, single mode, {cfg.sparse_update_mode} sparse "
        f"updates): n={len(times)} p50 {p50:.3f} ms p99 {p99:.3f} ms, "
        f"{cfg.batch_size / p50 * 1e3:.1f} examples/s, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {len(losses)} steps | peak memory allocated {peak_gb:.2f} GB "
        f"(phase R's index included) | phase {time.perf_counter() - t0:.1f} s [{CARD}]")


def _stub_llm(vocab):
    """A deterministic stand-in for a served LLM (no model is downloaded):
    it names a label on each intent axis from a hash of the prompt, some in
    capitals (which the prompt spec snaps back onto its vocabulary), and
    leaves an axis out now and then (which the spec fills with its
    default)."""
    import hashlib

    from recommend_tpu_torch.llm4rec import INTENT_AXES

    def llm(prompt: str) -> str:
        h = hashlib.sha256(prompt.encode()).digest()
        lines = []
        for i, axis in enumerate(INTENT_AXES):
            label = vocab[axis][h[i] % len(vocab[axis])]
            if h[8 + i] % 7:
                lines.append(f"{axis}: {label.upper() if h[16 + i] % 3 == 0 else label}")
        return "\n".join(lines)

    return llm


def _payload(user: int) -> dict:
    return {"behavior_items": [f"video {(user * 7919 + k * 104729) % 1_000_003}: a title"
                               for k in range(6)]}


def intent_phase(fa, totals, student, device="cuda", batch_size=512, users=L_USERS,
                 steps=N_TRAIN, expected=None, **overrides):
    """L, intents into ranking: a stub LLM through ``IntentPromptGenerator``
    (the axis encoder: the student's user-tower head of each axis on a
    per-label teacher vector) into an ``IntentCache`` (``users``
    precomputed, then hits, synchronous misses and stale entries), whose
    ``batch_get`` feeds ``user_intent`` to ``RankingTrainer`` steps at phase
    TA's config (``overrides`` and ``expected`` launches for a CPU
    rehearsal)."""
    import numpy as np
    import torch

    from recommend_tpu_torch.convert import init_params
    from recommend_tpu_torch.data.pipeline import ranking_batches
    from recommend_tpu_torch.data.synthetic import make_ranking_data
    from recommend_tpu_torch.llm4rec import INTENT_AXES, IntentCache, IntentPromptGenerator
    from recommend_tpu_torch.training.ranking_trainer import RankingTrainer

    t0 = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _, heads, items, _, per_step = TRAIN_PHASES[0]  # TA
    per_step = per_step if expected is None else expected
    dim = len(INTENT_AXES) * student.cfg.head_dim
    cfg = training_config(heads, batch_size, semantic_features=((L_INTENT, dim),), **overrides)

    # the axis encoder: the student's user-tower head per (axis, label)
    vocab = {a: tuple(f"{a}_{i}" for i in range(L_AXIS_LABELS)) for a in INTENT_AXES}
    labels = [(a, label) for a in INTENT_AXES for label in vocab[a]]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    teacher = torch.randn(len(labels), student.cfg.teacher_dim, generator=gen, device=dev)
    with torch.no_grad():
        label_heads = student.user_tower(teacher)[1].float().cpu().numpy()  # [n, 4, 32]
    head_of = {(a, label): label_heads[i, INTENT_AXES.index(a)]
               for i, (a, label) in enumerate(labels)}
    cache = IntentCache(
        IntentPromptGenerator(_stub_llm(vocab), lambda a, label: head_of[(a, label)], vocab),
        default_intent=np.zeros(dim, np.float32), capacity=2 * users, async_updates=False)

    data = make_ranking_data(cfg, num_samples=4 * batch_size, max_seq_per_feature=items,
                             seed=SEED)
    it = ranking_batches(data, cfg, batch_size=batch_size, seed=SEED)
    host = [next(it) for _ in range(4)]
    batch_users = np.unique(np.concatenate([b["non_seq"]["user_id"] for b in host]))
    # three quarters of the batches' users precomputed (one in eight of them
    # then aged past max_age_s), the rest misses; other users fill the cache
    rng = np.random.default_rng(SEED)
    known = batch_users[rng.permutation(len(batch_users))[: 3 * len(batch_users) // 4]]
    others = np.setdiff1d(rng.choice(cfg.vocab_size("user_id"), 2 * users, replace=False),
                          batch_users)
    pre = np.concatenate([known, others[: users - len(known)]])
    t = time.perf_counter()
    cache.precompute({int(u): _payload(int(u)) for u in pre})
    pre_s = time.perf_counter() - t
    stale = known[::8]
    with cache._lock:  # aged by hand past max_age_s
        for u in stale:
            intent, ts = cache._store[int(u)]
            cache._store[int(u)] = (intent, ts - 2 * cache.max_age_s)
    before = dict(cache.stats)
    t = time.perf_counter()
    for b in host:  # a hit, a synchronous miss or a stale entry's refresh per row
        for u in b["non_seq"]["user_id"]:
            cache.get(int(u), _payload(int(u)))
    get_ms = (time.perf_counter() - t) * 1e3 / (4 * batch_size)
    got = {k: cache.stats[k] - before[k] for k in before}
    misses = len(batch_users) - len(known)
    assert (got["misses"], got["refreshes"], got["generated"]) == (
        misses, len(stale), misses + len(stale)) and got["hits"] == 4 * batch_size - misses \
        - len(stale), f"L: intent cache counts {got}"
    t = time.perf_counter()
    for b in host:
        b["non_seq"][L_INTENT] = cache.batch_get([int(u) for u in b["non_seq"]["user_id"]])
    batch_get_ms = (time.perf_counter() - t) * 1e3 / len(host)
    for b in host:
        x = b["non_seq"][L_INTENT]
        assert x.shape == (batch_size, dim) and x.dtype == np.float32 and np.isfinite(x).all()
        assert (np.abs(x).sum(1) > 0).all(), "L: a batch row took the default intent"

    params = init_params(cfg, seed=SEED, device=dev)
    trainer = RankingTrainer(cfg, device=dev)
    state = trainer.init_state(params)
    batches = [trainer._put_batch(b) for b in host]
    put = batches[0]["non_seq"][L_INTENT]
    assert put.dtype == torch.float32 and torch.equal(
        put.cpu(), torch.from_numpy(host[0]["non_seq"][L_INTENT])), \
        "L: the intent reached the trainer changed"
    with torch.no_grad():  # the intent moves the logits
        shifted = dict(batches[0], non_seq=dict(batches[0]["non_seq"]))
        shifted["non_seq"][L_INTENT] = put + 1.0
        a, b = trainer._logits(state.params, batches[0]), trainer._logits(state.params, shifted)
        move = max(float((a[k].float() - b[k].float()).abs().max()) for k in cfg.tasks)
    assert move > 1e-6, f"L: the intent does not move the logits ({move})"
    for i in range(N_TRAIN_WARMUP):
        state, m = trainer._train_step(state, batches[i % len(batches)])
        assert np.isfinite(float(m["loss"])), f"L: warm-up loss {m['loss']}"
    setup_s = time.perf_counter() - t0
    state, times, losses, launched = time_train_steps(fa, totals, trainer, state, batches,
                                                      per_step, steps)
    assert all(np.isfinite(losses)), f"L: non-finite loss {losses}"

    def step():
        nonlocal state
        state, _ = trainer._train_step(state, batches[0])

    kernels, busy = _trace(step, 3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else float("nan")
    del trainer, state, batches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    errs = step_vs_plain(cfg, params, host[0], mixed=False, device=dev)
    assert errs[0] <= F32_STEP_LOSS_TOL, f"L: f32 loss differs by {errs[0]}"
    assert errs[1] <= F32_STEP_NORM_TOL, f"L: f32 grad norm differs by {errs[1]}"
    assert errs[2] <= F32_STEP_TABLE_TOL, f"L: f32 table gradients differ by {errs[2]}"
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    p50, p99 = np.percentile(times, 50), np.percentile(times, 99)
    log(f"phase L intents: stub LLM -> IntentPromptGenerator (global_intent, {len(INTENT_AXES)} "
        f"axes x {L_AXIS_LABELS} labels) -> the student's user-tower heads ({dim} dims) -> "
        f"IntentCache: precompute {len(pre)} users {pre_s:.2f} s; {4 * batch_size} rows of 4 "
        f"batches: {got['hits']} hits, {got['misses']} synchronous misses, "
        f"{got['refreshes']} stale refreshed, {got['generated']} generated, "
        f"{get_ms:.3f} ms/row; batch_get [{batch_size}, {dim}] {batch_get_ms:.2f} ms | "
        f"RankingTrainer at phase TA's config + {L_INTENT} ({dim}), batch {batch_size}: "
        f"train step n={len(times)} p50 {p50:.3f} ms p99 {p99:.3f} ms, "
        f"{batch_size / p50 * 1e3:.1f} examples/s | loss first {losses[0]:.4f} last "
        f"{losses[-1]:.4f} | launches {launched} | trace of 3 steps: device busy {busy:.3f} "
        f"ms/step, idle {1 - busy / p50:.1%} of the p50, {kernels:.0f} kernels/step | peak "
        f"memory allocated {peak_gb:.2f} GB | intent + 1 moves the logits by {move:.2e} | kernels-vs-plain step: f32 loss "
        f"{errs[0]:.2e}, grad norm {errs[1]:.2e}, table gradient {errs[2]:.2e} (update "
        f"{errs[3]:.2e}) | setup "
        f"{setup_s:.1f} s, phase {time.perf_counter() - t0:.1f} s [{CARD}]")


# ---------------------------------------------------------------------------
# phase N: the data layer
# ---------------------------------------------------------------------------

N_BATCHES = 20  # retrieval batches per path, compared and timed
N_ALIAS_DRAWS = 4_000_000
N_ALIAS_P = 1e-4  # the chi-square test's p-value must exceed this
N_DIR = Path(__file__).resolve().parent / "build" / "phase_n"


def data_phase(rt_data, n_batches=N_BATCHES, ml1m_users=6040, onetrans=None,
               batch_size=None):
    """N: the port's batcher built with g++, ``retrieval_batches`` native
    against numpy on phase RT's data at ``retrieval_flagship``, the alias
    sampler against its probabilities, and the two replicas at full scale
    (the sizes are arguments so the phase rehearses on the CPU)."""
    import dataclasses
    import shutil

    import numpy as np
    from scipy.stats import chisquare

    from recommend_tpu_torch.config import get_config
    from recommend_tpu_torch.data import native
    from recommend_tpu_torch.data.pipeline import retrieval_batches
    from recommend_tpu_torch.data.replica import make_ml1m_replica, make_onetrans_replica

    t0 = time.perf_counter()
    shutil.rmtree(N_DIR, ignore_errors=True)
    t = time.perf_counter()
    native.load_native(N_DIR)  # a fresh build on this host
    build_s = time.perf_counter() - t
    shutil.rmtree(N_DIR)
    lib = native.load_native()

    cfg = get_config("retrieval_flagship", video_vocab_size=rt_data.num_videos)
    if batch_size is not None:  # a CPU rehearsal
        cfg = dataclasses.replace(cfg, batch_size=batch_size)
    paths = {}
    for use_native in (True, False):
        it = retrieval_batches(rt_data, cfg, cfg.batch_size, seed=SEED, use_native=use_native)
        t = time.perf_counter()
        out = [next(it)]
        first = time.perf_counter() - t
        ms = []
        for _ in range(n_batches - 1):
            t = time.perf_counter()
            out.append(next(it))
            ms.append((time.perf_counter() - t) * 1e3)
        paths[use_native] = (out, first, np.asarray(ms))
    for i, (a, b) in enumerate(zip(paths[True][0], paths[False][0])):
        assert _same_state(a, b), f"N: native batch {i} differs from the numpy path's"

    t = time.perf_counter()
    ml = make_ml1m_replica(get_config("retrieval_base", video_vocab_size=4000,
                                      category_vocab_size=20, tag_vocab_size=512),
                           num_users=ml1m_users, seed=SEED)
    ml_s = time.perf_counter() - t
    events = sum(len(s["video_id"]) for s in ml.user_sequences)

    # the alias sampler's draws against its probabilities: chi-square over
    # the items expected 5 times or more, the rest pooled
    probs = ml.popularity.astype(np.float64) / ml.popularity.sum(dtype=np.float64)
    draws = native.AliasSampler(lib, probs, seed=SEED).sample(N_ALIAS_DRAWS)
    counts = np.bincount(draws, minlength=len(probs))
    expect = probs * N_ALIAS_DRAWS
    big = expect >= 5
    obs, exp = counts[big], expect[big]
    if not big.all():
        obs, exp = np.append(obs, counts[~big].sum()), np.append(exp, expect[~big].sum())
    p = float(chisquare(obs, exp).pvalue)
    freq_err = float(np.abs(counts / N_ALIAS_DRAWS - probs).max())
    assert p > N_ALIAS_P, f"N: alias sampler draws against the probabilities, p = {p}"

    t = time.perf_counter()
    parts = make_onetrans_replica(training_config(2, 512), **(onetrans or {}))
    ot_s = time.perf_counter() - t
    (nat, nat_first, nat_ms), (py, py_first, py_ms) = paths[True], paths[False]
    log(f"phase N: batcher g++ {build_s:.2f} s (a fresh build on this host) | "
        f"retrieval_batches on phase RT's data ({len(rt_data.user_sequences)} users, "
        f"{rt_data.num_videos} videos) at retrieval_flagship (batch {cfg.batch_size}, "
        f"max_seq_len {cfg.max_seq_len}): native == numpy for {n_batches} batches, bit for bit "
        f"| native: first {nat_first:.2f} s, then p50 {np.median(nat_ms):.3f} ms, "
        f"{1e3 / nat_ms.mean():.1f} batches/s; numpy: first {py_first:.2f} s, then p50 "
        f"{np.median(py_ms):.3f} ms, {1e3 / py_ms.mean():.1f} batches/s ("
        f"{py_ms.mean() / nat_ms.mean():.1f}x) | AliasSampler over the ML-1M replica's "
        f"popularity ({len(probs)} items), {N_ALIAS_DRAWS} draws: chi-square p {p:.3f} "
        f"({len(obs)} bins: the items expected 5 times or more, the rest pooled), max "
        f"|frequency - p| {freq_err:.2e} | "
        f"make_ml1m_replica {ml1m_users} users: {events} events, {ml.num_videos} items, "
        f"{ml_s:.1f} s | make_onetrans_replica ({'defaults' if not onetrans else onetrans}): "
        f"{' / '.join(str(d.num_samples) for d in parts)} train / eval impressions, "
        f"{ot_s:.1f} s | phase {time.perf_counter() - t0:.1f} s [{CARD}]")


# ---------------------------------------------------------------------------
# phase P: the mesh paths at world size 1 over NCCL
# ---------------------------------------------------------------------------

P_DIR = Path(__file__).resolve().parent / "build" / "phase_p"
P_STEPS = 3  # ranking steps compared at TA's config
P_TIMED = 10  # timed steps or searches per side after the compared ones
P_LOSS_RTOL, P_STATE_ATOL = 1e-5, 2e-5  # the CPU mesh tests' (JAX's mesh tests')
P_NORM_RTOL = 1e-4
P_SCORE_ATOL = 1e-5
P_LOOKUP_ROWS, P_LOOKUP_IDS = 1 << 20, 8192
# a table gradient against the plain one, of its largest: the popular row
# sums 1,024 float32 lookups in another order (the a2a path dedups first;
# 8.5e-7 read on the H100)
P_LOOKUP_TOL = 1e-5


def _to_host(params):
    return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}


def _state_diff(a, b) -> float:
    assert set(a) == set(b), "P: the two runs' parameter names differ"
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def _p_ranking(mesh, dev, fa, batch_size, items, per_step, overrides):
    """P (a): RankingTrainer steps at TA's config without and with the mesh,
    from one state on the same batches -> per side (losses, the state after
    P_STEPS steps on the host, ms of P_TIMED more steps, launches)."""
    import numpy as np
    import torch

    from recommend_tpu_torch.convert import init_params
    from recommend_tpu_torch.data.pipeline import ranking_batches
    from recommend_tpu_torch.data.synthetic import make_ranking_data
    from recommend_tpu_torch.training.ranking_trainer import RankingTrainer

    cfg = training_config(2, batch_size, **overrides)
    data = make_ranking_data(cfg, num_samples=4 * batch_size, max_seq_per_feature=items,
                             seed=SEED)
    it = ranking_batches(data, cfg, batch_size=batch_size, seed=SEED)
    host = [next(it) for _ in range(4)]
    params = init_params(cfg, seed=SEED, device=dev)
    sides = {}
    for label, m in (("plain", None), ("mesh", mesh)):
        trainer = RankingTrainer(cfg, device=None if m else dev, mesh=m)
        state = trainer.init_state(params)
        gen = torch.Generator().manual_seed(SEED)
        batches = [trainer._put_batch(b) for b in host]
        losses, times, snap = [], [], {}

        def run():
            nonlocal state
            for i in range(P_STEPS + P_TIMED):
                t = time.perf_counter()
                state, metrics = trainer._train_step(state, batches[i % len(batches)], gen)
                losses.append(float(metrics["loss"]))  # waits for the step
                if i >= P_STEPS:
                    times.append((time.perf_counter() - t) * 1e3)
                if i == P_STEPS - 1:
                    snap.update(_to_host(state.params))

        _, got = counted(fa, run, per_step, P_STEPS + P_TIMED)
        sides[label] = (losses[:P_STEPS], snap, np.asarray(times), got)
        assert all(np.isfinite(losses)), f"P: non-finite ranking loss ({label}) {losses}"
        del trainer, state, batches
        _free(dev)
    del params
    _free(dev)
    return sides


def _p_retrieval_trainer(mesh, dev, rt_data, batch_size):
    """P (b): RetrievalTrainer at retrieval_flagship on RT's data without
    and with the mesh, from one state: one step in float32 (the gate: in
    bf16 the mesh's all-gather hands the backward a contiguous gradient
    where the plain path's is a transposed view, so the matrix products
    take other kernels and round otherwise), then P_TIMED timed steps at
    the preset (bf16) -> per side (loss, grad norm, the state after the
    float32 step on the host, its accumulators, ms)."""
    import dataclasses

    import numpy as np
    import torch

    from recommend_tpu_torch.config import get_config
    from recommend_tpu_torch.convert import init_retrieval_params
    from recommend_tpu_torch.data.pipeline import retrieval_batches
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    cfg = get_config("retrieval_flagship", video_vocab_size=rt_data.num_videos)
    if batch_size is not None:  # a CPU rehearsal
        cfg = dataclasses.replace(cfg, batch_size=batch_size)
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    it = retrieval_batches(rt_data, cfg, batch_size=cfg.batch_size, seed=SEED)
    host = [next(it) for _ in range(4)]
    params = init_retrieval_params(cfg, seed=SEED, device=dev)
    sides = {}
    for label, m in (("plain", None), ("mesh", mesh)):
        trainer = RetrievalTrainer(c32, device=None if m else dev, mesh=m)
        state = trainer.init_state(params)
        state, metrics = trainer._train_step(state, trainer._put_batch(host[0]),
                                             torch.Generator().manual_seed(SEED))
        first = (float(metrics["loss"]), float(metrics["grad_norm"]))
        snap, accums = _to_host(state.params), _to_host(state.opt_state[1])
        del trainer, state
        _free(dev)
        trainer = RetrievalTrainer(cfg, device=None if m else dev, mesh=m)
        state = trainer.init_state(params)
        gen = torch.Generator().manual_seed(SEED)
        batches = [trainer._put_batch(b) for b in host]
        times = []
        for i in range(1 + P_TIMED):
            t = time.perf_counter()
            state, metrics = trainer._train_step(state, batches[i % len(batches)], gen)
            assert np.isfinite(float(metrics["loss"])), f"P: non-finite retrieval loss ({label})"
            times.append((time.perf_counter() - t) * 1e3)
        sides[label] = (first, snap, accums, np.asarray(times[1:]))
        del trainer, state, batches
        _free(dev)
    del params
    _free(dev)
    return cfg, sides


def _p_index(mesh, dev, corpus):
    """P (c): RetrievalIndex without and with the mesh at the flagship
    corpus -> per side (search at batch 1 and R_BATCH, fetch_items,
    similar_items, ms of the two searches, build seconds)."""
    import numpy as np
    import torch

    from recommend_tpu_torch.config import get_config
    from recommend_tpu_torch.convert import init_retrieval_params
    from recommend_tpu_torch.serving.retrieval_service import RetrievalIndex

    cfg = get_config("retrieval_flagship", dropout_rate=0.0, top_k=R_TOPK,
                     video_vocab_size=corpus)
    params = init_retrieval_params(cfg, seed=SEED, device=dev)
    feats, hist, valid = _corpus_and_histories(cfg, corpus, np.random.default_rng(SEED))
    seeds = np.random.default_rng(SEED + 1).integers(0, corpus, 37)  # pads on any mesh
    sides, interests = {}, None
    for label, m in (("plain", None), ("mesh", mesh)):
        index = RetrievalIndex(cfg, params, mesh=m, device=None if m else dev)
        t = time.perf_counter()
        index.build(feats)
        _sync(dev)
        build_s = time.perf_counter() - t
        assert index.sharded == (m is not None), f"P: {label} index sharded {index.sharded}"
        if interests is None:
            with torch.no_grad():
                interests = index.model({k: torch.as_tensor(v, device=dev)
                                         for k, v in hist.items()},
                                        torch.as_tensor(valid, device=dev))
        out = {"search1": index.search(interests[:1], R_TOPK),
               "search64": index.search(interests, R_TOPK),
               "fetch": index.fetch_items(seeds).cpu(),
               "similar": index.similar_items(seeds, 10)}
        ms = (_ms(lambda: index.search(interests[:1], R_TOPK), P_TIMED),
              _ms(lambda: index.search(interests, R_TOPK), P_TIMED))
        sides[label] = (out, ms, build_s)
        del index
        _free(dev)
    del params
    _free(dev)
    return sides


def _p_lookups(mesh, dev):
    """P (d): the three sharded lookups and their table gradients over the
    process group against a plain gather -> the largest differences."""
    import torch
    import torch.nn.functional as F

    from recommend_tpu_torch.parallel import (
        shard_table, shard_table_column, sharded_lookup, sharded_lookup_a2a,
        sharded_lookup_column)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    v, d = P_LOOKUP_ROWS, 128
    table = torch.randn(v, d, generator=gen, device=dev)
    ids = torch.randint(0, v, (P_LOOKUP_IDS,), generator=gen, device=dev)
    ids[: P_LOOKUP_IDS // 8] = ids[0]  # a popular id, duplicated
    ids[-1] = v  # the padding sentinel: a zero row
    w = torch.randn(P_LOOKUP_IDS, d, generator=gen, device=dev)
    t = table.clone().requires_grad_()
    ok = (ids < v)[:, None]
    ref = torch.where(ok, F.embedding(ids.clamp_max(v - 1), t), 0.0)
    (ref_g,) = torch.autograd.grad((ref * w).sum(), [t])
    out = {}
    for name, place, lookup in (
            ("sharded_lookup", shard_table, lambda b: sharded_lookup(mesh, b, ids)),
            ("sharded_lookup_a2a", lambda m, x: shard_table(m, x, axis="data"),
             lambda b: sharded_lookup_a2a(mesh, b, ids, axis="data")),
            ("sharded_lookup_column", shard_table_column,
             lambda b: sharded_lookup_column(mesh, b, ids))):
        blk = place(mesh, table).requires_grad_()
        rows = lookup(blk)
        (g,) = torch.autograd.grad((rows * w).sum(), [blk])
        fwd = float((rows - ref).detach().abs().max())
        grad = float((g - ref_g).abs().max() / ref_g.abs().max())
        assert fwd == 0.0, f"P: {name} differs from the plain gather by {fwd}"
        assert grad <= P_LOOKUP_TOL, f"P: {name}'s table gradient differs by {grad}"
        out[name] = (fwd, grad)
    return out


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _free(dev) -> None:
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def mesh_phase(rt_data, fa, totals, device="cuda", corpus=R_CORPUS, batch_size=512,
               items=SG_ITEMS, per_step=None, ranking_overrides=None, rt_batch=None):
    """P: the mesh paths at world size 1 (one rank over NCCL on the card;
    the sizes and the CPU's gloo are arguments so the phase rehearses on the
    CPU): RankingTrainer at TA's config, RetrievalTrainer at
    retrieval_flagship, RetrievalIndex at the flagship corpus and the three
    sharded lookups, each against its path without a mesh."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from recommend_tpu_torch.parallel import make_mesh, multihost_init

    t0 = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    per_step = TRAIN_PHASES[0][4] if per_step is None else per_step
    shutil.rmtree(P_DIR, ignore_errors=True)
    P_DIR.mkdir(parents=True)
    multihost_init(init_method=f"file://{P_DIR}/store", world_size=1, rank=0,
                   backend=None if on_card else "gloo")
    mesh = make_mesh(device=None if on_card else "cpu")
    backend = dist.get_backend()
    assert backend == ("nccl" if on_card else "gloo"), f"P: the process group runs {backend}"
    assert mesh.shape == {"data": 1, "model": 1}, f"P: mesh {mesh.shape}"

    rk = _p_ranking(mesh, dev, fa, batch_size, items, per_step, ranking_overrides or {})
    (l0, s0, t_plain, _), (l1, s1, t_mesh, got) = rk["plain"], rk["mesh"]
    for name, n in got.items():
        totals[name] += n
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(l0, l1))
    rk_diff = _state_diff(s0, s1)
    rk_equal = l0 == l1 and rk_diff == 0.0
    assert loss_err <= P_LOSS_RTOL, f"P: mesh ranking losses differ by {loss_err}"
    assert rk_diff <= P_STATE_ATOL, f"P: mesh ranking parameters differ by {rk_diff}"
    del rk, s0, s1
    a_s = time.perf_counter() - t0

    r_cfg, rt = _p_retrieval_trainer(mesh, dev, rt_data, rt_batch)
    ((rl0, rn0), rs0, ra0, rt_plain), ((rl1, rn1), rs1, ra1, rt_mesh) = rt["plain"], rt["mesh"]
    rt_loss_err = abs(rl0 - rl1) / abs(rl0)
    rt_norm_err = abs(rn0 - rn1) / abs(rn0)
    rt_diff = _state_diff(rs0, rs1)
    rt_acc_err = max(float(((ra0[k] - ra1[k]).abs() / ra0[k].abs()).max()) for k in ra0)
    rt_equal = rl0 == rl1 and rn0 == rn1 and rt_diff == 0.0 and rt_acc_err == 0.0
    assert rt_loss_err <= P_LOSS_RTOL, f"P: mesh retrieval loss differs by {rt_loss_err}"
    assert rt_norm_err <= P_NORM_RTOL, f"P: mesh retrieval grad norm differs by {rt_norm_err}"
    assert rt_diff <= P_STATE_ATOL, f"P: mesh retrieval parameters differ by {rt_diff}"
    assert rt_acc_err <= P_NORM_RTOL, f"P: mesh retrieval accumulators differ by {rt_acc_err}"
    del rt, rs0, rs1, ra0, ra1
    b_s = time.perf_counter() - t0 - a_s

    ix = _p_index(mesh, dev, corpus)
    (o0, (i1_plain, i64_plain), build0), (o1, (i1_mesh, i64_mesh), build1) = \
        ix["plain"], ix["mesh"]
    score_err = 0.0
    for key in ("search1", "search64", "similar"):
        (s_a, i_a), (s_b, i_b) = o0[key], o1[key]
        assert np.array_equal(i_a, i_b), f"P: mesh index {key} ids differ"
        score_err = max(score_err, float(np.abs(s_a - s_b).max()))
    fetch_err = float((o0["fetch"] - o1["fetch"]).abs().max())
    assert score_err <= P_SCORE_ATOL, f"P: mesh index scores differ by {score_err}"
    assert fetch_err == 0.0, f"P: mesh fetch_items differs by {fetch_err}"
    del ix, o0, o1
    c_s = time.perf_counter() - t0 - a_s - b_s

    lk = _p_lookups(mesh, dev)
    dist.destroy_process_group()
    shutil.rmtree(P_DIR)

    def p50(x):
        return f"{np.percentile(x, 50):.3f}"

    log(f"phase P: world 1 over {backend}, mesh {mesh.shape} on {mesh.device} | "
        f"(a) RankingTrainer at TA's config (batch {batch_size}, {items} items): "
        f"{P_STEPS} steps, losses {[round(x, 6) for x in l1]}, largest loss difference "
        f"{loss_err:.2e} relative, parameters {rk_diff:.2e}, bit-equal {rk_equal}; "
        f"launches {got} ({P_STEPS + P_TIMED} steps); step p50 {p50(t_plain)} ms without, "
        f"{p50(t_mesh)} ms with the mesh (n={P_TIMED} each), {a_s:.1f} s | "
        f"(b) RetrievalTrainer at retrieval_flagship (video table {r_cfg.video_vocab_size}, "
        f"batch {r_cfg.batch_size}, dropout {r_cfg.dropout_rate}): one float32 step, loss "
        f"{rt_loss_err:.2e}, grad norm {rt_norm_err:.2e} relative, parameters {rt_diff:.2e}, "
        f"accumulators {rt_acc_err:.2e} relative, bit-equal {rt_equal}; bf16 step p50 "
        f"{p50(rt_plain)} ms without, {p50(rt_mesh)} ms with (n={P_TIMED}), {b_s:.1f} s | (c) RetrievalIndex at {corpus} items: search, "
        f"fetch_items, similar_items ids equal, scores {score_err:.2e}, rows {fetch_err:.2e}; "
        f"search p50 batch 1 {p50(i1_plain)} / {p50(i1_mesh)} ms, batch {R_BATCH} "
        f"{p50(i64_plain)} / {p50(i64_mesh)} ms without / with (n={P_TIMED}); build "
        f"{build0:.2f} / {build1:.2f} s, {c_s:.1f} s | (d) lookups [{P_LOOKUP_ROWS}, 128] x "
        f"{P_LOOKUP_IDS} ids vs a plain gather (forward, gradient of its largest): "
        + ", ".join(f"{k} {f:.1e} / {g:.1e}" for k, (f, g) in lk.items())
        + f" | phase {time.perf_counter() - t0:.1f} s [{CARD}]")


# ---------------------------------------------------------------------------
# phase E: the entry points (examples_torch/) and the OneTrans quality track
# ---------------------------------------------------------------------------

E_DIR = Path(__file__).resolve().parent / "build" / "phase_e"
E_AUC_TOL = 1e-6  # evaluate's offline AUC on the checkpoint against in-process
# each model's test CTR AUC after the small-scale epoch: clear of chance (0.5)
# with room below the readings (0.576-0.665 on the H100) for another seed's luck
E_QUALITY_AUC_FLOOR = 0.56


def _driven(fa, totals, label, fn):
    """Run ``fn`` with every launch count at 0 first; add its launches to
    the main path's totals and return (its result, its launches)."""
    fa.reset_launch_counts()
    result = fn()
    got = {k: v for k, v in fa.LAUNCHES.items() if v}
    for k, v in got.items():
        totals[k] += v
    log(f"phase {label}: launches {got or 'none'}")
    return result, got


def _run(script, argv):
    """What an ``examples_torch`` script's ``run`` returns, as its
    ``main(argv)`` runs it."""
    return script.run(script.parse_args(argv))


def _files(root: Path, names) -> None:
    missing = [n for n in names if not list(root.glob(n))]
    assert not missing, f"E: {root} lacks {missing}"


def entry_points_phase(fa, totals, device="cuda", ranking_argv=(), retrieval_argv=(),
                       serving_argv=(), online_argv=(), quality_argv=()):
    """E: each ``examples_torch`` script as its ``main`` runs it
    (``run(parse_args(argv))``, which returns what the run made) and
    ``quality_torch.main`` on ``device`` at small flags (the ``*_argv`` add
    flags, so the phase rehearses on the CPU): ``train_ranking --flash
    --push-dir``, then ``evaluate ranking --eval_type all`` on its
    checkpoint, ``train_retrieval --quick-start`` then ``evaluate
    retrieval``, ``serving_demo`` and ``online_learning_demo`` at their
    defaults, and the OneTrans replica track at its small scale for one
    epoch. Gates: every script writes the JAX script's files; each model of
    the quality track ends its epoch with a test CTR AUC above
    ``E_QUALITY_AUC_FLOOR``; the offline AUCs of ``evaluate ranking`` equal
    ``RankingEvaluator``'s on the trainer's final params over the same
    batches; an engine at the trainer's initial params holds the
    checkpoint's state bit for bit after the push; the ranking
    run with ``--flash`` launched the kernels."""
    import json
    import shutil

    import numpy as np
    import torch

    import quality_torch
    from examples_torch import (evaluate, online_learning_demo, serving_demo,
                                train_ranking, train_retrieval)
    from recommend_tpu_torch.convert import init_params
    from recommend_tpu_torch.evaluation.ranking_eval import RankingEvaluator
    from recommend_tpu_torch.serving.param_push import load_push, table_keys
    from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine
    from recommend_tpu_torch.training.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    dev = torch.device(device)
    shutil.rmtree(E_DIR, ignore_errors=True)
    on = ["--device", device]
    secs = {}

    # train_ranking --flash with a push, then evaluate ranking on its checkpoint
    rank_dir, push_dir = E_DIR / "ranking", E_DIR / "push"
    t = time.perf_counter()
    tr, tr_launch = _driven(fa, totals, "E train_ranking", lambda: _run(train_ranking, [
        "--config", "ranking_small", "--steps", "200", "--flash", "--tame-optimizer",
        "--model_dir", str(rank_dir), "--push-dir", str(push_dir), *on, *ranking_argv]))
    secs["train_ranking"] = time.perf_counter() - t
    _files(rank_dir, ["ckpt/ckpt_*.pt", "ckpt/config.json", "ckpt/history.json",
                      "logs/train.jsonl", "eval.json"])
    _files(push_dir, ["push_*.npz"])
    cfg, state = tr["cfg"], tr["state"]
    if dev.type == "cuda":
        # layer 0 only (101 kept queries; layer 1 keeps 50 < 64): per step
        # one B4f and one B4b, per evaluation batch (4 a validation, the 8
        # offline ones) and per score_request one B4f
        n_val = len(tr["trainer"].history["val"])
        want = {"band_attn_bh_fwd": state.step + 4 * n_val + 8 + 1,
                "band_attn_bh_bwd": state.step}
        assert tr_launch == want, f"E: train_ranking --flash launched {tr_launch}, not {want}"
    ev_dir = E_DIR / "ranking_eval"
    t = time.perf_counter()
    ev, ev_launch = _driven(fa, totals, "E evaluate ranking", lambda: _run(evaluate, [
        "ranking", "--checkpoint", str(rank_dir / "ckpt"), "--eval_type", "all",
        "--output", str(ev_dir), *on]))
    secs["evaluate ranking"] = time.perf_counter() - t
    _files(ev_dir, ["ranking_eval.json"])
    assert set(ev) == {"offline", "ab_test", "feature_importance", "benchmark"}, sorted(ev)
    if dev.type == "cuda":
        # a B4f per batch: offline 4, A/B 4 + 4, importance 2 x (1 + one per
        # feature); the benchmark's 5 + 20 requests
        want = {"band_attn_bh_fwd": 4 + 8 + 2 * (1 + len(cfg.non_seq_features)) + 25}
        assert ev_launch == want, f"E: evaluate launched {ev_launch}, not {want}"

    # the same batches through RankingEvaluator on the trainer's final params
    data = evaluate.ranking_eval_data(cfg, 4)
    ref = RankingEvaluator(cfg, tr["trainer"].model, state.params, device=dev).evaluate(
        evaluate.ranking_eval_batches(data, cfg, 4, seed=7))
    auc_diff = max(abs(ev["offline"][f"{t}_auc"] - ref[f"{t}_auc"]) for t in cfg.tasks)
    assert auc_diff <= E_AUC_TOL, f"E: evaluate's offline AUC differs by {auc_diff}"
    # the push applied to an engine at the initial params: the checkpoint
    ckpt = CheckpointManager(str(rank_dir / "ckpt")).restore(map_location=dev)
    assert ckpt.step == state.step, (ckpt.step, state.step)
    engine = RankingInferenceEngine(cfg, init_params(cfg, seed=0, device=dev), device=dev)
    engine.apply_push(load_push(tr["push_path"], engine.state_dict(), table_keys(cfg)))
    pushed = engine.state_dict()
    push_bytes = os.path.getsize(tr["push_path"])
    differ = [k for k, v in ckpt.params.items() if not torch.equal(pushed[k], v)]
    assert not differ, f"E: the pushed engine's state differs from the checkpoint's: {differ}"
    del tr, ev, engine, ckpt, pushed
    _free(dev)

    # train_retrieval --quick-start, then evaluate retrieval on its checkpoint
    ret_dir = E_DIR / "retrieval"
    t = time.perf_counter()
    rt, _ = _driven(fa, totals, "E train_retrieval", lambda: _run(
        train_retrieval, ["--quick-start", "--model_dir", str(ret_dir), *on, *retrieval_argv]))
    secs["train_retrieval"] = time.perf_counter() - t
    _files(ret_dir, ["config.json", "ckpt/ckpt_*.pt", "ckpt/config.json", "logs/train.jsonl",
                     "eval.json"])
    t = time.perf_counter()
    rev, _ = _driven(fa, totals, "E evaluate retrieval", lambda: _run(evaluate, [
        "retrieval", "--checkpoint", str(ret_dir / "ckpt"), "--output",
        str(E_DIR / "retrieval_eval"), *on]))
    secs["evaluate retrieval"] = time.perf_counter() - t
    _files(E_DIR / "retrieval_eval", ["retrieval_eval.json"])
    assert set(rev) == {"retrieval", "classification", "latency"}, sorted(rev)
    del rt
    _free(dev)

    t = time.perf_counter()
    sv, _ = _driven(fa, totals, "E serving_demo",
                    lambda: _run(serving_demo, [*on, *serving_argv]))
    secs["serving_demo"] = time.perf_counter() - t
    assert len(sv["recs"]) == 5 and all(np.isfinite(r["score"]) for r in sv["recs"]), sv["recs"]
    del sv
    _free(dev)

    t = time.perf_counter()
    ol, _ = _driven(fa, totals, "E online_learning_demo", lambda: _run(
        online_learning_demo, ["--model_dir", str(E_DIR / "online"), *on, *online_argv]))
    secs["online_learning_demo"] = time.perf_counter() - t
    _files(E_DIR / "online", ["ckpt_*.pt", "config.json"])
    assert ol["new_items_indexed"], "E: the appended items left the index after refresh"
    assert int(ol["state"].step) == 2 * ol["first_step"], "E: training did not go on"
    online = (ol["first_step"], int(ol["state"].step), ol["changed"])
    del ol
    _free(dev)

    q_out = E_DIR / "quality_torch_onetrans_small.json"
    t = time.perf_counter()
    rc, _ = _driven(fa, totals, "E quality_torch --track onetrans", lambda: quality_torch.main(
        ["--track", "onetrans", "--scale", "small", "--epochs", "1", "--output", str(q_out),
         *on, *quality_argv]))
    secs["quality_torch"] = time.perf_counter() - t
    assert rc == 0, f"E: quality_torch returned {rc}"
    q = json.loads(q_out.read_text())["onetrans_replica"]
    q_auc = {m: q[k]["ctr_auc"] for m, k in (("onetrans", "onetrans"), ("din", "din_baseline"),
                                             ("ns_only", "ns_only_baseline"))}
    low = {m: v for m, v in q_auc.items() if not v > E_QUALITY_AUC_FLOOR}
    assert not low, f"E: quality AUCs {low} not above {E_QUALITY_AUC_FLOOR}"
    shutil.rmtree(E_DIR)

    log(f"phase E: train_ranking ranking_small --flash {state.step} steps, batch "
        f"{cfg.batch_size} (push {push_bytes / 2**20:.2f} MB), evaluate ranking --eval_type all: "
        f"offline AUC {ref[f'{cfg.tasks[0]}_auc']:.5f}, |evaluate - in-process| {auc_diff:.1e}, "
        f"pushed engine == checkpoint (step {state.step}) bit for bit | train_retrieval "
        f"--quick-start, "
        f"evaluate retrieval | serving_demo, online_learning_demo (steps {online[0]} -> "
        f"{online[1]}, {online[2]} ids moved) | quality_torch onetrans small, 1 epoch: "
        f"test CTR AUC " + ", ".join(f"{m} {v:.4f}" for m, v in q_auc.items())
        + " | seconds " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f" | phase {time.perf_counter() - t0:.1f} s [{CARD}]")


# ---------------------------------------------------------------------------
# phase AB: the compression ablation (examples_torch/ablation_compression.py)
# ---------------------------------------------------------------------------

AB_ARGV = ("--steps", "200", "--num_users", "1000")
AB_ARM_KEYS = {"label", "tokens", "ms_per_step", "recall@10", "ndcg@10", "recall@50",
               "ndcg@50", "mrr", "map"}
AB_SUMMARY_KEYS = {"compression_token_reduction", "step_time_speedup", "recall@50_delta"}


def ablation_phase(device="cuda", argv=()):
    """AB: ``examples_torch/ablation_compression.py`` as its ``main`` runs it
    on ``device`` at small flags (``argv`` adds flags, so the phase rehearses
    on the CPU), both arms at the script's L = 64. Gates: each printed line
    carries the JAX script's keys, the arms compress 64 items to 22 tokens
    and leave 64, and every recall is finite and in [0, 1]. The retrieval
    tower reaches no band-attention kernel: main runs the phase under
    ``counted(fa, ..., {}, 1)``."""
    import contextlib
    import io

    from examples_torch import ablation_compression

    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = ablation_compression.main([*AB_ARGV, "--device", device, *argv])
    assert rc == 0, f"AB: ablation_compression returned {rc}"
    lines = [json.loads(line) for line in printed.getvalue().splitlines()
             if line.startswith("{")]
    assert len(lines) == 3, f"AB: {len(lines)} JSON lines, not 3"
    comp, raw, summary = lines
    for arm in (comp, raw):
        assert set(arm) == AB_ARM_KEYS, f"AB: {arm['label']} keys {sorted(arm)}"
    assert set(summary) == AB_SUMMARY_KEYS, f"AB: summary keys {sorted(summary)}"
    assert (comp["label"], comp["tokens"], raw["label"], raw["tokens"]) == (
        "compressed", 22, "raw", 64), f"AB: arms {comp['tokens']} / {raw['tokens']} tokens"
    recalls = {f"{arm['label']} {k}": arm[k] for arm in (comp, raw)
               for k in ("recall@10", "recall@50")}
    bad = {k: v for k, v in recalls.items() if not 0.0 <= v <= 1.0}
    assert not bad, f"AB: recalls {bad} not finite in [0, 1]"
    log("phase AB: ablation_compression " + " ".join([*AB_ARGV, *argv]) + ": " + " | ".join(
        f"{arm['label']} {arm['tokens']} tokens {arm['ms_per_step']} ms a step, recall@10 "
        f"{arm['recall@10']}, @50 {arm['recall@50']}" for arm in (comp, raw))
        + f" | speedup {summary['step_time_speedup']}, recall@50 delta "
        f"{summary['recall@50_delta']} | phase {time.perf_counter() - t0:.1f} s [{CARD}]")
    return lines


# ---------------------------------------------------------------------------
# phase M: the measurement scripts (examples_torch/*_bench.py) and
# graft_entry_torch, each as its main runs it
# ---------------------------------------------------------------------------

M_DIR = Path(__file__).resolve().parent / "build" / "phase_m"
# The cuts against each script's defaults (phase R runs the 10M corpus;
# phase RT's 200 users: the synthetic data draws each user's history over
# the whole 10M-entry popularity, ~0.13 s a user on the host)
M_FLAGSHIP_SERVING_ARGV = ("--corpus", "1000000")
M_FLAGSHIP_ARGV = ("--steps", "20", "--num_users", "200")
M_SERVING_ARGV = ("--requests", "100")
M_SERVING_DEVICE_ARGV = ("--device-side", "--chains", "10")
M_SCALING_ARGV = ("--steps", "10")
M_RECALL_MIN = R_INT8_RECALL_MIN  # the int8 rows against the exact scan
M_FLAGSHIP_VARIANTS = {"flat_exact", "int8_exact", "int8_approx99"}
M_SERVING_KEYS = {"device", "transport_rtt_ms_p50", "reference_claims", "ranking",
                  "retrieval", "retrieval_throughput"}
M_DEVICE_SIDE_KEYS = {"kv_cached_request_device", "session_delta_kv_append_device",
                      "kv_cached_request_device_scanned",
                      "session_delta_kv_append_device_scanned", "config",
                      "transport_rtt_ms_p50"}


def _only(label, got, allowed):
    """The script launched no kernel outside ``allowed``."""
    other = {k: v for k, v in got.items() if k not in allowed}
    assert not other, f"M: {label} launched {other}"


def measurement_phase(fa, totals, device="cuda", flagship_serving_argv=(), flagship_argv=(),
                      serving_argv=(), lookup_argv=(), scaling_argv=()):
    """M: each measurement script as its ``main`` runs it
    (``run(parse_args(argv))``) on ``device`` (the ``*_argv`` add flags, so
    the phase rehearses on the CPU): ``flagship_serving_bench`` at a 1M
    corpus, ``flagship_bench``, ``serving_bench`` host-observed and
    ``--device-side``, ``lookup_bench`` and ``scaling_bench`` at their
    card's world (one rank over NCCL here) and full widths, then
    ``graft_entry_torch``'s ``entry()`` forward and ``dryrun_multichip(1)``.
    Gates: each report carries the JAX script's keys; the flat search's
    recall against the exact scan is 1 and the int8 searches' at least
    ``M_RECALL_MIN``; losses and times finite; no script launches a
    band-attention kernel (the JAX scripts' configs leave
    ``use_flash_attention`` off). Their launches would go into the
    kernels' totals."""
    import math
    import shutil

    import numpy as np
    import torch

    import graft_entry_torch
    from examples_torch import (flagship_bench, flagship_serving_bench, lookup_bench,
                                scaling_bench, serving_bench)

    t0 = time.perf_counter()
    shutil.rmtree(M_DIR, ignore_errors=True)
    M_DIR.mkdir(parents=True)
    on = ["--device", device]
    secs, launches = {}, {}

    def drive(label, fn):
        t = time.perf_counter()
        result, launches[label] = _driven(fa, totals, f"M {label}", fn)
        secs[label] = time.perf_counter() - t
        return result

    fsb = drive("flagship_serving_bench", lambda: _run(flagship_serving_bench, [
        *M_FLAGSHIP_SERVING_ARGV, "--output", str(M_DIR / "flagship_serving.json"), *on,
        *flagship_serving_argv]))
    assert set(fsb) == {"flat", "ivf", "checkpoint"}, f"M: flagship_serving phases {sorted(fsb)}"
    assert M_FLAGSHIP_VARIANTS <= set(fsb["flat"]), f"M: flat phase keys {sorted(fsb['flat'])}"
    recalls = {name: fsb["flat"][name]["top100_recall_vs_exact"] for name in M_FLAGSHIP_VARIANTS}
    assert recalls["flat_exact"] == 1.0, f"M: the flat search's recall {recalls['flat_exact']}"
    low = {k: v for k, v in recalls.items() if k != "flat_exact" and not v >= M_RECALL_MIN}
    assert not low, f"M: int8 top-100 recall vs exact {low} < {M_RECALL_MIN}"
    assert 0.0 <= fsb["ivf"]["top100_recall_vs_exact"] <= 1.0
    _only("flagship_serving_bench", launches["flagship_serving_bench"], ())

    fb = drive("flagship_bench", lambda: _run(flagship_bench, [
        *M_FLAGSHIP_ARGV, "--output", str(M_DIR / "flagship_bench.json"), *on,
        *flagship_argv]))
    arms = ("flagship_budget_16384", "flagship_budget_off")
    for arm in arms:
        assert math.isfinite(fb[arm]["loss"]), f"M: flagship_bench {arm} loss {fb[arm]['loss']}"
    assert fb[arms[0]]["sparse_dropped_rows"] == 0, "M: the scatter budget dropped rows"
    _only("flagship_bench", launches["flagship_bench"], ())

    sb = drive("serving_bench", lambda: _run(serving_bench, [*M_SERVING_ARGV, *on,
                                                             *serving_argv]))
    assert set(sb) == M_SERVING_KEYS, f"M: serving_bench keys {sorted(sb)}"
    sd = drive("serving_bench --device-side", lambda: _run(serving_bench, [
        *M_SERVING_DEVICE_ARGV, *on, *serving_argv]))
    assert set(sd["ranking_device_side"]) == M_DEVICE_SIDE_KEYS, \
        f"M: serving_bench --device-side keys {sorted(sd['ranking_device_side'])}"
    # ranking_base leaves use_flash_attention off, as the JAX scripts run it:
    # serving_bench's and scaling_bench's ranking paths take the plain
    # attention, and no script of this phase launches a kernel
    _only("serving_bench", launches["serving_bench"], ())
    _only("serving_bench --device-side", launches["serving_bench --device-side"], ())

    lb = drive("lookup_bench", lambda: _run(lookup_bench, [*on, *lookup_argv]))
    assert all(np.isfinite(v) and v > 0 for v in lb["wall_ms"].values()), lb["wall_ms"]
    _only("lookup_bench", launches["lookup_bench"], ())

    sc = drive("scaling_bench", lambda: _run(scaling_bench, [*M_SCALING_ARGV, *on,
                                                             *scaling_argv]))
    assert sc["model"] == "ranking" and all(
        r["examples_per_s"] > 0 for r in sc["results"].values()), sc
    _only("scaling_bench", launches["scaling_bench"], ())

    def graft():
        fn, args = graft_entry_torch.entry(device)
        out = fn(*args)
        dry = graft_entry_torch.dryrun_multichip(1, device)
        return out, dry

    out, dry = drive("graft_entry_torch", graft)
    assert all(bool(torch.isfinite(v).all()) for v in out.values()), "M: entry() not finite"
    assert math.isfinite(dry["loss"]) and math.isfinite(dry["sparse_loss"]), dry
    _only("graft_entry_torch", launches["graft_entry_torch"], ())
    shutil.rmtree(M_DIR)

    flat, i8 = fsb["flat"]["flat_exact"], fsb["flat"]["int8_exact"]
    req = sb["ranking"]["kv_cached_request"]
    ds = sd["ranking_device_side"]
    log(f"phase M: flagship_serving_bench {' '.join(M_FLAGSHIP_SERVING_ARGV)}: flat batch 1 / "
        f"64 p50 {flat['search_ms_p50_batch1']:.3f} / {flat['search_ms_p50_batch64']:.3f} ms, "
        f"int8 {i8['search_ms_p50_batch1']:.3f} / {i8['search_ms_p50_batch64']:.3f} ms, "
        f"recall {recalls} | flagship_bench {' '.join(M_FLAGSHIP_ARGV)}: "
        + ", ".join(f"{arm} {fb[arm]['ms_per_step']:.3f} ms {fb[arm]['examples_per_s']:.1f} "
                    f"ex/s" for arm in arms)
        + f" | serving_bench {' '.join(M_SERVING_ARGV)}: kv_cached_request p50 "
        f"{req['p50_ms']:.3f} ms p99 {req['p99_ms']:.3f} ms; --device-side: "
        f"kv_cached_request_device p50 {ds['kv_cached_request_device']['p50_ms']:.3f} ms, "
        f"scanned {ds['kv_cached_request_device_scanned']['per_request_ms_p50']:.3f} ms | "
        f"lookup_bench {lb['devices']} rank(s): psum fwd {lb['wall_ms']['psum_fwd']:.3f} ms "
        f"| scaling_bench {' '.join(M_SCALING_ARGV)}: " + ", ".join(
            f"{n} rank(s) {r['examples_per_s']:.1f} ex/s" for n, r in sc["results"].items())
        + f" | graft_entry_torch: entry {sorted(out)}, dryrun_multichip(1) loss "
        f"{dry['loss']:.4f} / {dry['sparse_loss']:.4f} | launches {launches} | seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f" | phase {time.perf_counter() - t0:.1f} s [{CARD}]")


def ptxas_label(line: str) -> str:
    """``name<template ints and bools>`` of the kernel whose mangled name a
    ptxas 'Compiling entry function' line gives, e.g. band_attn_kernel<128>
    or band_attn_fwd_sm90_kernel<128, true>."""
    import re

    m = re.search(r"(band_attn_\w*?kernel)I(\w*?)EE", line)
    if not m:
        return line.strip()
    targs = m.group(2) + "E"  # e.g. Li128E, Li128ELb1E
    args = [v if k == "i" else ("true" if v == "1" else "false")
            for k, v in re.findall(r"L([ib])(\d+)E", targs)]
    return f"{m.group(1)}<{', '.join(args)}>"


def main() -> int:
    global CARD
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from recommend_tpu_torch.ops import _build
    from recommend_tpu_torch.ops import flash_attention as fa

    # full float32 products on the plain side and in the float32 engines
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CARD = card_line()
    log(CARD)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    libs = _build.build_all()
    log(f"built {[lib.name for lib in libs]} in {time.perf_counter() - t:.1f} s")
    for lib in libs:
        kernel = ""
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = ptxas_label(line)
            elif "registers" in line or "spill" in line:
                log(f"ptxas {lib.stem.split('-')[0]} {kernel}: " + line.strip())

    sg = s_trunk_kernel_shapes(training_config(2, SG_BATCH), SG_ITEMS, SG_BATCH)
    log(f"phase SG's model-layout shapes from pyramid_keep_lengths: {sg}")
    fwd, bwd = ([(name, replaces, sg + shapes if name in SG_KERNELS else shapes)
                 for name, replaces, shapes in kernels]
                for kernels in (KERNELS, BWD_KERNELS))
    entries = check_kernels(fa, fwd)
    entries.update(check_backward_kernels(fa, bwd))
    totals = {name: 0 for name in fa.LAUNCHES}
    # per call: score_request (encode_s) and batch_inference (full forward)
    serve_phase("A", 2, 64, 48,
                {"band_attn_mh_fwd": 1}, {"band_attn_segkv_fwd": 1}, fa, totals)
    serve_phase("B", 2, 400, 400,
                {"band_attn_blocked_fwd": 1, "band_attn_mh_fwd": 3},
                {"band_attn_blocked_fwd": 1, "band_attn_segkv_fwd": 3}, fa, totals)
    serve_phase("C", 4, 64, 48,
                {"band_attn_bh_fwd": 1}, {"band_attn_bh_fwd": 1}, fa, totals)
    examples_per_s = {}
    for label, heads, items, batch_size, per_step in TRAIN_PHASES:
        examples_per_s[label] = train_phase(label, heads, items, batch_size, per_step, fa,
                                            totals)
    s_trunk_phase(fa, totals)
    session_phase(fa, totals)
    din_eval_phase(fa, totals, checkpoint_phase(fa, totals), examples_per_s["TA"])
    # no band-attention kernel in R, RT, L's distillation and semantic ids, or N
    r_out, _ = counted(fa, retrieval_phase, {}, 1)
    rt_data, _ = counted(fa, lambda: retrieval_training_phase(r_out), {}, 1)
    student, _ = counted(fa, distill_phase, {}, 1)
    counted(fa, lambda: semantic_id_phase(r_out, rt_data), {}, 1)
    del r_out  # phase R's index
    intent_phase(fa, totals, student)
    counted(fa, lambda: data_phase(rt_data), {}, 1)
    del student
    mesh_phase(rt_data, fa, totals)
    del rt_data
    entry_points_phase(fa, totals)
    counted(fa, ablation_phase, {}, 1)  # no band-attention kernel in AB
    measurement_phase(fa, totals)
    for name, n in totals.items():
        assert n > 0, f"{name} never launched on the main path"
        entries[name]["launches"] = n
    torch.cuda.synchronize()
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s [{CARD}]")

    print(json.dumps({"kernels": [entries[name] for name, _, _ in KERNELS + BWD_KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
