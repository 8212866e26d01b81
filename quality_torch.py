#!/usr/bin/env python3
"""The replica quality runs of the PyTorch/CUDA port.

    python3 quality_torch.py                        # ML-1M, full scale, on the card
    python3 quality_torch.py --scale small --device cpu
    python3 quality_torch.py --track onetrans --replica v2 --v2-w-match 4.0 \
        --v2-order 1.4 --v2-cross 1.8 --v2-alpha -3.0 --models din --epochs 3
    python3 quality_torch.py --track onetrans --scale small --device cpu

The port's counterpart of ``examples/quality_parity.py``, both tracks.

``--track ml1m`` (the default): the KuaiFormer tower at ``retrieval_base``
(video vocabulary 4000, 20 categories, 512 tags, dropout 0.1, top 100)
trained by ``RetrievalTrainer`` for 8,000 steps of batch 256 (1,000 warm-up
steps) on the full-scale MovieLens-1M statistical replica
(``data/replica.make_ml1m_replica``, 6,040 users), with each user's last
event held out (``leave_one_out_split``); batches from the native batcher
through ``prefetch``. Then ``RetrievalEvaluator.evaluate_retrieval`` over
the held-out events (``leave_one_out_batches``, one per user, the whole
3,706-item corpus searched) at k = 1, 5, 10, 50, 100, and the popularity
baseline under the same protocol. ``--scale small`` is the recipe's smoke
size: 300 users, 120 steps of batch 64, a 2-layer d-64 tower. The trainer
saves a checkpoint every 500 steps into ``--checkpoint-dir`` (under
``build/`` by default); a run started again with the same arguments resumes
from the newest one and skips the batches already trained on, so a run cut
short carries on where it stopped and ends as an unbroken run would (the
retrieval trainer's resume is bit-equal).

``--track onetrans``: the OneTrans industrial replica
(``data/replica.make_onetrans_replica``; full scale 5,000 users, 2,000
items, 5M impressions, batch 512; small scale 150 / 400 / 50,000, batch
128), the recipe and protocol of ``quality_parity.run_onetrans``: geometry S
(6 layers, d 256) or L (8 layers, d 384), 12 NS tokens, adam at a constant
lr with no warm-up, clip 90, rowwise touched-row adagrad at sparse lr 0.02,
dropout 0; replica v1 or v2 (``REPLICA_V2``, ``--v2-*`` overrides: the JAX
quality board ran v2 at match 4.0, order 1.4, cross 1.8, alpha -3.0); the
four oracle anchors by ``exact_auc`` on the test split; a time-ordered
validation split (``--val-frac``) evaluated every epoch on 100 capped
batches, whose best epoch's params are kept; ``RankingEvaluator`` over the
whole test split at the final and at the selected params; OneTrans, then
the DCNv2+DIN comparator (``--din-epochs`` caps it), then the
sequence-blind NS-only anchor (at most 3 epochs), and their lifts. On the
card it computes in bf16 with the band-attention kernels on, as the JAX
recipe does on the TPU; on the CPU in float32 on the plain path.
``--models`` trains a subset. It saves no checkpoint, as the JAX recipe
saves none: a model's state with adam's two moments is ~0.75 GB at S and
~2.1 GB at L, so a run is one unbroken invocation, and
``RankingTrainer.train`` starts its selection afresh on a resume.
``--max-steps`` caps each model's steps (a throughput probe: no epoch ends,
so nothing is selected); ``--float32`` computes in float32 on the card too.
There is no ``--mesh``: the mesh trainer is held by ``chip_smoke.py`` phase
P, and a chip call has one card.

Each writes its JSON to ``--output`` (``quality_torch_<track>.json`` by
default) with the device and, on the card, its name and power limit from
``nvidia-smi``. It runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import resource
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

KS = (1, 5, 10, 50, 100)
CHECKPOINT_EVERY = 500
ROOT = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# ML-1M replica track

def recipe(scale: str) -> dict:
    full = scale == "full"
    steps = 8000 if full else 120
    return dict(
        num_users=6040 if full else 300,
        steps=steps,
        batch=256 if full else 64,
        cfg=dict(
            video_vocab_size=4000, category_vocab_size=20, tag_vocab_size=512,
            batch_size=256 if full else 64, warmup_steps=min(1000, steps // 4),
            dropout_rate=0.1, top_k=100,
            **({} if full else dict(embed_dim=64, num_layers=2, num_heads=2, ffn_dim=128,
                                    max_seq_len=64,
                                    compression_schedule=((32, 16), (32, 1))))),
    )


def popularity_baseline(data, test) -> dict:
    """recall@k of ranking every user's held-out item by corpus popularity."""
    order = np.argsort(-data.popularity)
    pop_rank = np.empty(len(order), dtype=np.int64)
    pop_rank[order] = np.arange(len(order))
    targets = np.array([s["video_id"][-1] for s in test.user_sequences
                        if len(s["video_id"]) >= 2])
    return {f"recall@{k}": float((pop_rank[targets] < k).mean()) for k in KS}


def run_ml1m(scale: str, seed: int, device, checkpoint_dir: Path) -> dict:
    from recommend_tpu_torch.config import get_config
    from recommend_tpu_torch.data.datasets import leave_one_out_split
    from recommend_tpu_torch.data.pipeline import prefetch, retrieval_batches
    from recommend_tpu_torch.data.replica import leave_one_out_batches, make_ml1m_replica
    from recommend_tpu_torch.evaluation.retrieval_eval import RetrievalEvaluator
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    r = recipe(scale)
    cfg = get_config("retrieval_base", **r["cfg"])
    t0 = time.perf_counter()
    data = make_ml1m_replica(cfg, num_users=r["num_users"], seed=seed)
    n_events = sum(len(s["video_id"]) for s in data.user_sequences)
    train, test = leave_one_out_split(data)
    data_s = time.perf_counter() - t0
    log(f"ml1m replica: {r['num_users']} users, {n_events} events, {data.num_videos} items "
        f"({data_s:.1f} s)")

    # one checkpoint kept (37.8 MB at full scale): small enough to carry
    # from one chip call to the next
    trainer = RetrievalTrainer(cfg, total_steps=r["steps"], checkpoint_dir=str(checkpoint_dir),
                               max_to_keep=1, device=device)
    start = trainer.ckpt.latest_step() or 0
    # the batches already trained on are skipped, so a resumed run sees the
    # stream an unbroken one does
    batches = itertools.islice(
        retrieval_batches(train, cfg, r["batch"], seed=seed, use_native=True), start, None)
    log(f"training steps {start}-{r['steps']} (checkpoints every {CHECKPOINT_EVERY} steps in "
        f"{checkpoint_dir})")
    t0 = time.perf_counter()
    state = trainer.train(prefetch(batches, size=4), num_steps=r["steps"],
                          eval_every=CHECKPOINT_EVERY, log_every=max(r["steps"] // 10, 1),
                          seed=seed)
    _sync(trainer.device)
    train_s = time.perf_counter() - t0
    for h in trainer.history["train"]:
        log(f"step {h['step']}: loss {h['loss']:.4f}, {h['steps_per_s']:.2f} steps/s")

    evaluator = RetrievalEvaluator(cfg, state.params, device=trainer.device)
    t0 = time.perf_counter()
    metrics = evaluator.evaluate_retrieval(test, leave_one_out_batches(test, cfg, r["batch"]),
                                           ks=KS)
    eval_s = time.perf_counter() - t0
    return {
        "config": f"KuaiFormer retrieval_base {cfg.num_layers}L d={cfg.embed_dim} "
                  f"seq{cfg.max_seq_len}->{cfg.num_compressed_tokens} on the ML-1M replica "
                  f"({r['num_users']} users, {n_events} events, leave-one-out)",
        "scale": scale,
        "seed": seed,
        "train_steps": r["steps"],
        "start_step": start,
        "train_seconds": train_s,
        "steps_per_s": (r["steps"] - start) / train_s,
        "data_seconds": data_s,
        "eval_seconds": eval_s,
        "metrics": metrics,
        "popularity_baseline": popularity_baseline(data, test),
    }


# ---------------------------------------------------------------------------
# OneTrans industrial replica track

# Replica v2's weights, calibrated at the board's full scale (seed 0) in the
# JAX recipe: signal mass moved from the DIN-form match term onto the order
# and cross-behavior axes.
REPLICA_V2 = dict(
    signal_weights=(3.5, 2.0, -0.8, 0.5, -3.3),
    signal_weights_v2=(2.2, 2.8),
)
# S: OneTrans-S-like (6 layers, d 256); L: the paper's OneTrans-L (8 layers,
# d 384, FFN 1536; 3 heads, Dh 128)
ONETRANS_GEOMETRY = {
    "S": dict(embed_dim=256, num_layers=6, num_heads=2, ffn_dim=1024,
              pyramid_ratios=(0.5, 0.3, 0.2, 0.1, 0.05, 0.03)),
    "L": dict(embed_dim=384, num_layers=8, num_heads=3, ffn_dim=1536,
              pyramid_ratios=(0.5, 0.3, 0.2, 0.1, 0.05, 0.03, 0.02, 0.01)),
}
ONETRANS_MODELS = ("onetrans", "din", "ns_only")
CURVE_BATCHES = 100  # validation batches per epoch


def onetrans_sizes(scale: str) -> dict:
    """The replica's cardinalities, impressions and batch at ``scale``:
    density-matched at full scale (~1,000 impressions a user, ~2,500 an
    item)."""
    full = scale == "full"
    return dict(
        num_users=5_000 if full else 150,
        num_items=2_000 if full else 400,
        num_impressions=5_000_000 if full else 50_000,
        stream_kw=dict(stream_len_loc=4.8, stream_len_scale=0.8) if full else {},
        batch=512 if full else 128,
    )


def onetrans_base(scale: str, geometry: str, on_card: bool, dense_lr: float = 1e-3,
                  clip_norm: float = 90.0, sparse_lr: float = 0.02,
                  sparse_lr_init: float = 0.0, weight_decay: float = 0.0) -> dict:
    """``ranking_base``'s overrides of the recipe: bf16 and the kernels on
    the card, float32 and the plain path elsewhere; adam at a constant lr
    (adamw when ``weight_decay`` > 0)."""
    s = onetrans_sizes(scale)
    return dict(
        **ONETRANS_GEOMETRY[geometry],
        num_ns_tokens=12,
        batch_size=s["batch"], use_mixed_precision=on_card, dropout_rate=0.0,
        feature_embed_dim=128, seq_item_feature_dim=128,
        use_sparse_embedding_updates=True, sparse_update_mode="rowwise",
        use_flash_attention=on_card,
        feature_vocab_sizes=(
            ("user_id", s["num_users"] + 1), ("age_bucket", 16), ("gender", 4),
            ("city", 32), ("item_id", s["num_items"] + 1), ("category", 200),
            ("brand", 500), ("price_bucket", 16), ("hour", 24),
            ("weekday", 7), ("device", 8),
        ),
        dense_optimizer="adamw" if weight_decay > 0 else "adam",
        dense_weight_decay=weight_decay,
        dense_lr=dense_lr, dense_momentum=0.9,
        gradient_clip_norm=clip_norm,
        sparse_lr=sparse_lr,
        sparse_lr_init=sparse_lr_init,
    )


def replica_kwargs(replica_version: str, v2_overrides: Optional[dict] = None) -> dict:
    """The generator's signal weights: v1's defaults, or ``REPLICA_V2`` with
    its match / alpha / order / cross weights overridden."""
    if replica_version != "v2":
        return {}
    aff, match, price, hour, alpha = REPLICA_V2["signal_weights"]
    order, cross = REPLICA_V2["signal_weights_v2"]
    o = v2_overrides or {}
    return dict(signal_weights=(aff, o.get("match", match), price, hour, o.get("alpha", alpha)),
                signal_weights_v2=(o.get("order", order), o.get("cross", cross)))


def make_replica(cfg, scale: str, seed: int, replica_version: str, val_frac: float,
                 v2_overrides: Optional[dict] = None):
    """(train, val, test, anchors): the replica's splits (val is the test
    split when ``val_frac`` is 0) and the four oracle AUCs on the test
    split (latent Bayes and observable ceiling, CTR and CVR)."""
    from recommend_tpu_torch.data.replica import make_onetrans_replica
    from recommend_tpu_torch.training.metrics import exact_auc

    s = onetrans_sizes(scale)
    dbg = {}
    datasets = make_onetrans_replica(
        cfg, num_users=s["num_users"], num_items=s["num_items"],
        num_impressions=s["num_impressions"], seed=seed, debug_out=dbg, val_frac=val_frac,
        **replica_kwargs(replica_version, v2_overrides), **s["stream_kw"])
    if val_frac > 0:
        tr_data, val_data, ev_data = datasets
    else:
        tr_data, ev_data = datasets
        val_data = ev_data  # the curve's source; nothing is selected
    ev = dbg["is_eval"]
    anchors = {
        "latent_bayes_ctr_auc": exact_auc(dbg["bayes_logit"][ev], dbg["y_ctr"][ev]),
        "observable_ceiling_ctr_auc": exact_auc(dbg["observable_logit"][ev], dbg["y_ctr"][ev]),
        "latent_bayes_cvr_auc": exact_auc(dbg["bayes_cvr_score"][ev], dbg["y_cvr"][ev]),
        "observable_ceiling_cvr_auc": exact_auc(dbg["observable_cvr_score"][ev],
                                                dbg["y_cvr"][ev]),
    }
    return tr_data, val_data, ev_data, anchors


def lift_block(a, b) -> dict:
    """Relative lift of ``a`` over ``b`` in percent, per task metric both
    hold (a NaN or zero baseline is skipped)."""
    out = {}
    for k in ("ctr_auc", "ctr_uauc", "cvr_auc", "cvr_uauc"):
        if a and b and k in a and k in b and b[k] == b[k] and b[k] != 0:
            out[k] = round((a[k] - b[k]) / abs(b[k]) * 100, 3)
    return out


# the keys of a model's entry that describe its run, not its test metrics
RUN_KEYS = ("train_seconds", "train_epochs", "train_steps", "examples_per_s", "eval_seconds",
            "num_params", "state_bytes", "convergence_curve")


def _nbytes(obj) -> int:
    """Bytes of every tensor in a nest of dicts, tuples and lists."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(v) for v in obj)
    return 0


def run_onetrans(
    scale: str,
    device,
    seed: int = 0,
    epochs: int = 3,
    geometry: str = "S",
    baselines: tuple = ("ns_only", "din"),
    models: tuple = ONETRANS_MODELS,
    dense_lr: float = 1e-3,
    clip_norm: float = 90.0,
    sparse_lr: float = 0.02,
    sparse_lr_init: float = 0.0,
    sparse_warmup_epochs: float = 0.0,
    weight_decay: float = 0.0,
    replica_version: str = "v1",
    val_frac: float = 0.05,
    v2_overrides: Optional[dict] = None,
    bias_init: bool = False,
    din_epochs: int = 0,
    max_steps: int = 0,
    float32: bool = False,
) -> dict:
    """``float32`` computes in float32 on the card too (the recipe's card
    dtype is bf16): it tells a bf16 effect from the rest of the port."""
    import torch

    from recommend_tpu_torch.config import get_config
    from recommend_tpu_torch.data.pipeline import prefetch, ranking_batches
    from recommend_tpu_torch.evaluation.ranking_eval import RankingEvaluator
    from recommend_tpu_torch.models.din import DINRankingModel
    from recommend_tpu_torch.training.ranking_trainer import RankingTrainer

    device = torch.device(device)
    on_card = device.type == "cuda"
    sizes = onetrans_sizes(scale)
    batch = sizes["batch"]
    geo = ONETRANS_GEOMETRY[geometry]
    base = onetrans_base(scale, geometry, on_card, dense_lr, clip_norm, sparse_lr,
                         sparse_lr_init, weight_decay)
    if float32:
        base["use_mixed_precision"] = False
    cfg = get_config("ranking_base", **base)
    log(f"onetrans replica: generating ({sizes['num_users']}u/{sizes['num_items']}i/"
        f"{sizes['num_impressions']} impressions, {replica_version})")
    t0 = time.perf_counter()
    tr_data, val_data, ev_data, anchors = make_replica(cfg, scale, seed, replica_version,
                                                       val_frac, v2_overrides)
    gen_s = time.perf_counter() - t0
    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    steps_per_epoch = tr_data.num_samples // batch
    log(f"onetrans replica: train={tr_data.num_samples} val="
        f"{val_data.num_samples if val_frac > 0 else 0} eval={ev_data.num_samples} "
        + " ".join(f"{k}={v:.4f}" for k, v in anchors.items())
        + f" gen={gen_s:.1f}s peak host RSS {peak_rss_gb:.2f} GB; {steps_per_epoch} "
          f"steps/epoch x batch {batch}")
    sparse_warmup_steps = int(round(sparse_warmup_epochs * steps_per_epoch))
    if sparse_warmup_steps:
        # into `base` too, so the NS-only config inherits it
        base["sparse_lr_warmup_steps"] = sparse_warmup_steps
        cfg = get_config("ranking_base", **base)
    if bias_init:
        # every model's task logits start at the train split's base-rate logit
        rates = [float(tr_data.labels[t].mean()) for t in cfg.tasks]
        base["task_logit_bias_init"] = tuple(
            float(np.log(max(r, 1e-6) / max(1.0 - r, 1e-6))) for r in rates)
        cfg = get_config("ranking_base", **base)
        log(f"label-prior head bias init: {dict(zip(cfg.tasks, base['task_logit_bias_init']))}")
    curve_batches = min(CURVE_BATCHES, val_data.num_samples // batch)

    def train_and_eval(cfg, tag, n_epochs, model=None):
        steps = n_epochs * steps_per_epoch
        if max_steps:
            steps = min(steps, max_steps)
        # no dense-lr warm-up: the sparse tables would train at full lr
        # against a near-idle dense net
        cfg = dataclasses.replace(cfg, lr_warmup_steps=0)
        t0 = time.perf_counter()
        trainer = RankingTrainer(cfg, model=model, total_steps=steps, device=device)

        def val_fn():
            return itertools.islice(
                ranking_batches(val_data, cfg, batch, seed=1, num_epochs=1), curve_batches)

        state = trainer.train(
            prefetch(ranking_batches(tr_data, cfg, batch, seed=seed), size=4),
            num_steps=steps,
            val_fn=val_fn,
            eval_every=steps_per_epoch,
            log_every=max(steps // 10, 1),
            track_best_params=val_frac > 0,
        )
        _sync(device)
        train_s = time.perf_counter() - t0
        for h in trainer.history["train"]:
            log(f"{tag} step {h['step']}: loss {h['loss']:.4f}")
        n_eval_batches = ev_data.num_samples // batch

        def full_test_eval(params):
            ev = RankingEvaluator(cfg, trainer.model, params, device=device)
            return ev.evaluate(itertools.islice(
                ranking_batches(ev_data, cfg, batch, seed=1, num_epochs=1), n_eval_batches))

        t0 = time.perf_counter()
        m = full_test_eval(state.params)
        eval_s = time.perf_counter() - t0
        log(f"{tag} (final): " + json.dumps(
            {k: round(v, 5) for k, v in m.items()
             if "auc" in k or "uauc" in k or k == "num_samples"}))
        m["train_seconds"] = round(train_s, 1)
        m["train_epochs"] = n_epochs
        m["train_steps"] = steps
        m["examples_per_s"] = round(steps * batch / train_s, 1)
        m["eval_seconds"] = round(eval_s, 1)
        # what a checkpoint of this model would hold: params, optimizer state
        m["num_params"] = sum(t.numel() for t in state.params.values())
        m["state_bytes"] = _nbytes(state.params) + _nbytes(state.opt_state)
        if trainer.best_params is not None:
            # the best validation epoch's params, evaluated on the test split
            sel_epoch = trainer.best_val_step // steps_per_epoch
            if trainer.best_val_step == steps:
                sel = {k: v for k, v in m.items() if k not in RUN_KEYS}
            else:
                sel = full_test_eval(trainer.best_params)
            m["selected"] = sel
            m["selected_epoch"] = sel_epoch
            log(f"{tag} (selected @ep{sel_epoch}): " + json.dumps(
                {k: round(v, 5) for k, v in sel.items() if "auc" in k or "uauc" in k}))
        m["convergence_curve"] = [
            {"epoch": j + 1, **{k: round(h[k], 5) for k in ("ctr_auc", "cvr_auc") if k in h}}
            for j, h in enumerate(trainer.history["val"])
        ]
        for j, c in enumerate(m["convergence_curve"]):
            log(f"{tag} epoch {j + 1}: val " + json.dumps(c))
        del trainer, state
        if on_card:
            torch.cuda.empty_cache()
        return m

    tag = f"OneTrans-{geometry}"
    full = None
    if "onetrans" in models:
        full = train_and_eval(cfg, f"{tag} (full, sequences)", epochs)
    results = {}
    if "din" in baselines and "din" in models:
        # the paper's Table-2 comparator class, sequence-aware; its budget
        # capped by --din-epochs, the selection rule the same for every model
        with torch.device("meta"):
            din = DINRankingModel(cfg)
        results["din"] = train_and_eval(
            cfg, "DCNv2+DIN baseline (sequence-aware)",
            min(epochs, din_epochs) if din_epochs else epochs, model=din)
    if "ns_only" in baselines and "ns_only" in models:
        # the sequence-blind lower anchor
        cfg_ns = get_config("ranking_base", **dict(base, sequence_features=()))
        results["ns_only"] = train_and_eval(
            cfg_ns, "NS-only anchor (sequence-blind)", min(epochs, 3))
    ns = results.get("din") or results.get("ns_only") or {}
    lifts = lift_block(full, ns)
    lifts_selected = (lift_block(full["selected"], ns["selected"])
                      if full and "selected" in full and "selected" in ns else None)
    return {
        "config": f"OneTrans-{geometry} ({geo['num_layers']}L d={geo['embed_dim']}, 12 NS, "
                  "pyramid, flash, sparse) on the industrial replica, "
                  "train-on-past/eval-on-future",
        "scale": scale,
        "geometry": geometry,
        "replica_version": replica_version,
        "recipe": {
            "seed": seed, "dense_lr": dense_lr, "clip": clip_norm,
            "sparse_lr": sparse_lr, "sparse_lr_init": sparse_lr_init,
            "sparse_warmup_epochs": sparse_warmup_epochs,
            "weight_decay": weight_decay, "val_frac": val_frac,
            "v2_overrides": v2_overrides, "float32": not cfg.use_mixed_precision,
        },
        "dataset": {
            "num_users": sizes["num_users"], "num_items": sizes["num_items"],
            "train_impressions": tr_data.num_samples,
            "val_impressions": val_data.num_samples if val_frac > 0 else 0,
            "eval_impressions": ev_data.num_samples,
            **{k: round(float(v), 5) for k, v in anchors.items()},
            "generation_seconds": gen_s,
            "peak_host_rss_gb": peak_rss_gb,
            "scale_note": "density-matched replica of the paper's setting"
                          " (29.1B/27.9M/10.2M, translation:168-175):"
                          " impressions/user and impressions/item preserved"
                          " at ~5800x lower cardinality; replica statistics,"
                          " not real logs. The observable ceiling (oracle"
                          " that sees history latents) is calibrated to the"
                          " paper's CTR-AUC band; the meaningful comparisons"
                          " are distance-to-ceiling and full-vs-NS-only"
                          " lift. Embedding-table cardinality is exercised"
                          " by the perf benches (V=1M/10M), not here.",
        },
        "onetrans": full,
        "din_baseline": results.get("din"),
        "ns_only_baseline": results.get("ns_only"),
        "lift_vs_baseline_pct": lifts,
        "lift_vs_baseline_pct_selected": lifts_selected,
        "lift_baseline": ("din" if "din" in results else "ns_only"),
        "reference_anchors": {
            "baseline_ctr_auc": 0.79623, "baseline_ctr_uauc": 0.71927,
            "baseline_cvr_auc": 0.90361, "baseline_cvr_uauc": 0.71955,
            "onetrans_L_lift_pct": {"ctr_auc": 1.53, "ctr_uauc": 2.79,
                                    "cvr_auc": 1.14, "cvr_uauc": 3.23},
            "source": "translation/complete_translation.md:199-207 (Table 2)",
        },
    }


# ---------------------------------------------------------------------------

def _models(value: str) -> tuple:
    models = tuple(m for m in value.split(",") if m)
    unknown = set(models) - set(ONETRANS_MODELS)
    if unknown:
        raise argparse.ArgumentTypeError(f"unknown models {sorted(unknown)}; "
                                         f"choose from {','.join(ONETRANS_MODELS)}")
    return models


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--track", choices=("ml1m", "onetrans", "both"), default="ml1m")
    ap.add_argument("--scale", choices=("full", "small"), default="full")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless given (cpu for a rehearsal)")
    ap.add_argument("--checkpoint-dir", type=Path, default=None,
                    help="ml1m: default build/quality_torch/ml1m_<scale>_seed<seed>")
    ap.add_argument("--output", type=Path, default=None,
                    help="default: quality_torch_<track>.json at the repository root")
    ot = ap.add_argument_group("onetrans track (examples/quality_parity.py's flags)")
    ot.add_argument("--epochs", type=int, default=3, help="training epochs")
    ot.add_argument("--geometry", choices=("S", "L"), default="S",
                    help="OneTrans geometry (L = the paper's 8L d=384)")
    ot.add_argument("--baselines", default="ns_only,din",
                    help="comma list from {ns_only,din}; empty for none")
    ot.add_argument("--models", type=_models, default=ONETRANS_MODELS,
                    help="comma list from {onetrans,din,ns_only}: the models trained "
                         "(default all three, in that order)")
    ot.add_argument("--lr", type=float, default=1e-3, help="dense (adam) lr, constant")
    ot.add_argument("--clip", type=float, default=90.0, help="global-norm gradient clip")
    ot.add_argument("--sparse-lr", type=float, default=0.02,
                    help="touched-row adagrad lr of the embedding tables")
    ot.add_argument("--sparse-lr-init", type=float, default=0.0,
                    help="sparse-lr ramp start (with --sparse-warmup-epochs)")
    ot.add_argument("--sparse-warmup-epochs", type=float, default=0.0,
                    help="ramp the sparse lr from --sparse-lr-init to --sparse-lr over "
                         "this many epochs (0 = constant)")
    ot.add_argument("--wd", type=float, default=0.0,
                    help=">0: adamw with masked decoupled weight decay (matrices only)")
    ot.add_argument("--replica", choices=("v1", "v2"), default="v1",
                    help="v2 plants long-range-order and cross-behavior signal")
    ot.add_argument("--v2-w-match", type=float, default=None,
                    help="override REPLICA_V2's match weight")
    ot.add_argument("--v2-order", type=float, default=None,
                    help="override REPLICA_V2's order weight")
    ot.add_argument("--v2-cross", type=float, default=None,
                    help="override REPLICA_V2's cross-behavior weight")
    ot.add_argument("--v2-alpha", type=float, default=None,
                    help="override REPLICA_V2's intercept (base rate)")
    ot.add_argument("--din-epochs", type=int, default=0,
                    help="epoch cap of the DIN comparator (0 = --epochs)")
    ot.add_argument("--bias-init", action="store_true",
                    help="start every model's task logits at the train split's base rate")
    ot.add_argument("--val-frac", type=float, default=0.05,
                    help="time-ordered validation slice for the curves and the "
                         "selection; 0 = none")
    ot.add_argument("--float32", action="store_true",
                    help="compute in float32 on the card too (the recipe's card dtype is bf16)")
    ot.add_argument("--max-steps", type=int, default=0,
                    help="cap each model's steps (a throughput probe; 0 = no cap)")
    args = ap.parse_args(argv)
    import torch

    if args.device is None and not torch.cuda.is_available():
        print("quality_torch: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1
    device = torch.device(args.device or "cuda")
    on_card = device.type == "cuda"
    if on_card:
        from chip_smoke import card_line  # nvidia-smi's name and power limit
    where = {"device": torch.cuda.get_device_name(device) if on_card else "cpu",
             "card": card_line() if on_card else "not measured (CPU run)"}
    log(f"{where['device']} | {where['card']}")
    result = dict(where)
    output = args.output or ROOT / f"quality_torch_{args.track}.json"
    if args.track in ("ml1m", "both"):
        ckpt = args.checkpoint_dir or (ROOT / "build" / "quality_torch"
                                       / f"ml1m_{args.scale}_seed{args.seed}")
        result["ml1m_replica"] = run_ml1m(args.scale, args.seed, device, ckpt)
        m, pop = result["ml1m_replica"]["metrics"], result["ml1m_replica"]["popularity_baseline"]
        log(f"recall@10 {m['recall@10']:.4f} (popularity {pop['recall@10']:.4f}), recall@100 "
            f"{m['recall@100']:.4f} (popularity {pop['recall@100']:.4f}), ndcg@10 "
            f"{m['ndcg@10']:.4f}, mrr {m['mrr']:.4f}")
    if args.track in ("onetrans", "both"):
        result["seed"] = args.seed
        result["onetrans_replica"] = run_onetrans(
            args.scale, device, args.seed, args.epochs, args.geometry,
            tuple(b for b in args.baselines.split(",") if b),
            models=args.models,
            dense_lr=args.lr,
            clip_norm=args.clip,
            sparse_lr=args.sparse_lr,
            sparse_lr_init=args.sparse_lr_init,
            sparse_warmup_epochs=args.sparse_warmup_epochs,
            weight_decay=args.wd,
            replica_version=args.replica,
            val_frac=args.val_frac,
            v2_overrides={
                k: v for k, v in (
                    ("match", args.v2_w_match), ("order", args.v2_order),
                    ("cross", args.v2_cross), ("alpha", args.v2_alpha),
                ) if v is not None
            } or None,
            bias_init=args.bias_init,
            din_epochs=args.din_epochs,
            max_steps=args.max_steps,
            float32=args.float32,
        )
    output.parent.mkdir(parents=True, exist_ok=True)
    output.write_text(json.dumps(result, indent=2, default=float) + "\n")
    log(f"wrote {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
