"""Serving benchmark on the PyTorch/CUDA port: the counterpart of
``examples/serving_bench.py``. Measured counterparts of the reference's
serving claims (KuaiFormer: 23.5 ms average, 1,250 QPS; OneTrans: p99 13.2
ms at serve batch 100).

Host-observed request latency percentiles and QPS for:
  - ranking ``score_request`` (the KV-cached request) against
    ``batch_inference`` (uncached) at 100 candidates a request, and the
    cross-request session's Δ-append (``score_session``), interleaved with
    the requests pair by pair;
  - retrieval ``RealTimeRecommender.get_recommendations`` over the flat and
    IVF indexes, and batched encode + scan + top k (QPS).

The ranking engine is the JAX script's OneTrans-S-like config
(``ranking_base`` at 6 layers, d 256, 4 heads), bf16, random weights from
seed 0. ``ranking_base`` leaves ``use_flash_attention`` off, as the JAX
script runs it, so attention takes the plain path and no band-attention
kernel runs. The traffic draws from numpy seed 0 as the JAX script does, with one
difference: each feature id is drawn below ``min(100, its vocabulary)``
(the JAX script draws every id below 100, past the 24-, 7- and 8-row hour,
weekday and device tables, where its lookup reads outside the table; the
port's engine raises there).

``--device-side``: JAX chains fetch-free dispatches and runs K requests in
one ``lax.scan`` program. The port chains ``score_request_device`` /
``score_session_device`` calls with one ``torch.cuda.synchronize`` a chain;
its ``*_device_scanned`` rows issue the K requests back to back in the same
way (a ``note`` says so): no graph capture is involved, and each request's
host preprocessing runs inside the timer. ``transport_rtt_ms_p50`` is the
round trip of a one-element device tensor to the host.

Usage:
    python examples_torch/serving_bench.py [--requests 500] [--ranking-only]
    python examples_torch/serving_bench.py --device-side [--chains 40 --chain-len 32]

It runs on the card unless given ``--device cpu``; without CUDA and without
``--device`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.config import get_config
from recommend_tpu_torch.convert import init_params, init_retrieval_params
from recommend_tpu_torch.data.pipeline import retrieval_batches
from recommend_tpu_torch.data.synthetic import make_retrieval_data
from recommend_tpu_torch.models.retrieval import load_tower
from recommend_tpu_torch.serving.ranking_service import RankingInferenceEngine
from recommend_tpu_torch.serving.retrieval_service import RealTimeRecommender, RetrievalIndex

# the JAX script's OneTrans-S-like serving config (examples/serving_bench.py:63-70)
RANKING = dict(
    embed_dim=256, num_layers=6, num_heads=4, ffn_dim=1024, num_ns_tokens=12,
    pyramid_ratios=(0.5, 0.3, 0.2, 0.1, 0.05, 0.03), dropout_rate=0.0,
    feature_embed_dim=128, seq_item_feature_dim=128,
)
DELTA_MIX = (1, 2, 4, 8)  # per-request Δ-append sizes, cycled
SCANNED_NOTE = ("the K requests are issued back to back and synchronized once "
                "(no graph capture; each request's host preprocessing inside the "
                "timer); (elapsed - rtt)/K")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_rtt(device: torch.device, n: int = 30) -> float:
    """p50 ms of a one-element device tensor's round trip to the host."""
    x = torch.zeros((1,), dtype=torch.float32, device=device)
    float((x + 1.0)[0])
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        float((x + 1.0)[0])
        ts.append(time.perf_counter() - t0)
    return float(np.percentile(np.asarray(ts) * 1000.0, 50))


def pctile(lats_ms) -> dict:
    a = np.asarray(lats_ms)
    return {
        "p50_ms": float(np.percentile(a, 50)),
        "p95_ms": float(np.percentile(a, 95)),
        "p99_ms": float(np.percentile(a, 99)),
        "mean_ms": float(a.mean()),
        "qps": float(1000.0 / a.mean()),
    }


def _ranking_engine_setup(device: torch.device):
    """The JAX script's serving config with window 64, and its numpy rng
    after the same draws (the JAX script draws its init inputs from it)."""
    cfg = get_config("ranking_base", **RANKING)
    rng = np.random.default_rng(0)
    for _ in cfg.sequence_features:  # the JAX script's init inputs
        rng.integers(0, 1000, size=(1, 64))
    vocab = dict(cfg.feature_vocab_sizes)
    for f in cfg.non_seq_features:
        rng.integers(0, min(100, vocab[f]), size=(1,))
    engine = RankingInferenceEngine(cfg, init_params(cfg, seed=0, device=device),
                                    max_seq_len=64, device=device)
    return cfg, engine, rng


def _traffic(cfg, rng, n_candidates: int):
    """(user context, 48-item histories, a candidate-list maker): ids below
    ``min(100, vocabulary)``, items below 1000."""
    vocab = dict(cfg.feature_vocab_sizes)
    draw = lambda f: int(rng.integers(0, min(100, vocab[f])))  # noqa: E731
    user_ctx = {f: draw(f) for f in cfg.user_features + cfg.context_features}
    user_seqs = {sf: rng.integers(0, 1000, size=48).tolist() for sf in cfg.sequence_features}

    def make_cands():
        return [{f: draw(f) for f in cfg.item_features} for _ in range(n_candidates)]

    return user_ctx, user_seqs, make_cands


def bench_ranking(n_requests: int, n_candidates: int, device=None) -> dict:
    device = resolve_device(device, "serving_bench")
    cfg, engine, rng = _ranking_engine_setup(device)
    # every serving path once, the session ladder and every Δ of the mix
    # included, before the timers
    engine.warmup(n_candidates, deltas=DELTA_MIX)
    # the engine's default "deployment" profile: re-anchors and near-full
    # folds run in engine.maintain() between requests, never in a timer
    assert engine.auto_maintain is False
    assert engine.fold_headroom >= max(DELTA_MIX)
    user_ctx, user_seqs, make_cands = _traffic(cfg, rng, n_candidates)

    # uncached: every candidate runs the full S+NS forward (capped samples)
    rows = [(dict(user_ctx, **c), user_seqs) for c in make_cands()]
    engine.batch_inference(rows)
    lats = []
    for _ in range(min(n_requests, 50)):
        t0 = time.perf_counter()
        engine.batch_inference(rows)
        lats.append((time.perf_counter() - t0) * 1000)
    uncached = pctile(lats)

    # the KV-cached request and the session's Δ-append, interleaved pair by
    # pair, so drift on the host or the card falls on both alike
    engine.score_request(user_ctx, user_seqs, make_cands())
    engine.update_session("u1", {sf: user_seqs[sf] for sf in cfg.sequence_features})
    lat_req, lat_sess = [], []
    maint_ms, maint_count = [], 0
    for i in range(n_requests):
        t0 = time.perf_counter()
        engine.score_request(user_ctx, user_seqs, make_cands())
        lat_req.append((time.perf_counter() - t0) * 1000)
        delta = DELTA_MIX[i % len(DELTA_MIX)]
        t0 = time.perf_counter()
        engine.score_session(
            "u1", user_ctx, make_cands(),
            new_items={cfg.sequence_features[0]:
                       [int(x) for x in rng.integers(0, 1000, size=delta)]},
        )
        lat_sess.append((time.perf_counter() - t0) * 1000)
        # idle-time maintenance, outside both timers; its cost reported apart
        t0 = time.perf_counter()
        if engine.maintain():
            maint_ms.append((time.perf_counter() - t0) * 1000)
            maint_count += 1
    cached = pctile(lat_req)
    session = pctile(lat_sess)
    session["session_kv_memory_mb"] = engine.session_memory_mb()
    session["delta_mix"] = list(DELTA_MIX)
    session["maintenance_refreshes"] = maint_count
    session["maintenance_rate_per_request"] = maint_count / max(n_requests, 1)
    if maint_ms:
        session["maintenance_dispatch_ms_p50"] = float(np.percentile(maint_ms, 50))
    # the paired per-sample delta (negative: the session beats the request)
    # and the sign test over the pairs, exact ties dropped
    d = np.asarray(lat_sess) - np.asarray(lat_req)
    for p in (1, 5, 25, 50, 75, 95, 99):
        session[f"paired_delta_ms_p{p:02d}"] = float(np.percentile(d, p))
    n_eff = int(np.count_nonzero(d))
    wins = float((d < 0).sum() / max(n_eff, 1))
    session["session_win_fraction"] = wins
    session["sign_test_n_effective"] = n_eff
    session["sign_test_z"] = float((wins - 0.5) * 2 * np.sqrt(max(n_eff, 1)))

    return {
        "config": f"OneTrans-S-like (6L, d=256), {n_candidates} candidates/"
                  f"request, {n_requests} interleaved request/session pairs",
        "uncached_batch": uncached,
        "kv_cached_request": cached,
        "session_delta_kv_append": session,
    }


def _scanned(samples_ms, rtt_ms: float, k: int) -> dict:
    per_req = (np.asarray(samples_ms) - rtt_ms) / k
    return {
        "per_request_ms_p50": float(np.percentile(per_req, 50)),
        "per_request_ms_p95": float(np.percentile(per_req, 95)),
        "per_request_ms_p99": float(np.percentile(per_req, 99)),
        "k_per_dispatch": int(k),
        "samples": len(samples_ms),
        "note": SCANNED_NOTE,
    }


def bench_ranking_device_side(n_chains: int, chain_len: int, n_candidates: int,
                              device=None) -> dict:
    """Chains of ``chain_len`` requests through the fetch-free engine paths
    (``score_request_device`` / ``score_session_device``), one synchronize
    at each chain's end, each request charged chain time / chain_len;
    ``rtt_adjusted_*`` removes the one measured round trip a chain.
    Percentiles are over chains."""
    device = resolve_device(device, "serving_bench")
    cfg, engine, rng = _ranking_engine_setup(device)
    engine.warmup(n_candidates, deltas=DELTA_MIX)
    user_ctx, user_seqs, make_cands = _traffic(cfg, rng, n_candidates)
    rtt_ms = measure_rtt(device)

    def run_chains(dispatch_one, between_chains=None) -> dict:
        for _ in range(chain_len):  # one warm chain
            dispatch_one(0)
        _sync(device)
        per_req = []
        for c in range(n_chains):
            if between_chains is not None:
                between_chains()  # idle-time maintenance, outside the timer
            t0 = time.perf_counter()
            for k in range(chain_len):
                dispatch_one(c * chain_len + k)
            _sync(device)
            per_req.append((time.perf_counter() - t0) * 1000.0 / chain_len)
        r = pctile(per_req)
        adj = np.asarray(per_req) - rtt_ms / chain_len
        for p in (50, 95, 99):
            r[f"rtt_adjusted_p{p}_ms"] = float(np.percentile(adj, p))
        r["chains"] = n_chains
        r["chain_len"] = chain_len
        return r

    report = {
        "config": f"{n_candidates} candidates/request, {n_chains} chains × "
                  f"{chain_len} chained dispatches, single sync per chain",
        "transport_rtt_ms_p50": rtt_ms,
    }
    report["kv_cached_request_device"] = run_chains(
        lambda i: engine.score_request_device(user_ctx, user_seqs, make_cands()))
    engine.update_session("d1", {sf: user_seqs[sf] for sf in cfg.sequence_features})
    sf0 = cfg.sequence_features[0]

    def session_one(i):
        delta = DELTA_MIX[i % len(DELTA_MIX)]
        return engine.score_session_device(
            "d1", user_ctx, make_cands(),
            new_items={sf0: [int(x) for x in rng.integers(0, 1000, size=delta)]})

    report["session_delta_kv_append_device"] = run_chains(session_one,
                                                          between_chains=engine.maintain)

    # K requests, each with its own 48-item histories and candidates, back
    # to back and synchronized once a sample
    k = chain_len
    requests = [({sf: rng.integers(0, 1000, size=48).tolist() for sf in cfg.sequence_features},
                 make_cands()) for _ in range(k)]

    def requests_once():
        for seqs, cands in requests:
            engine.score_request_device(user_ctx, seqs, cands)
        _sync(device)

    requests_once()
    samples = []
    for _ in range(max(n_chains // 2, 10)):
        t0 = time.perf_counter()
        requests_once()
        samples.append((time.perf_counter() - t0) * 1000.0)
    report["kv_cached_request_device_scanned"] = _scanned(samples, rtt_ms, k)

    # the session path: Δ = 1 appends and cached scoring, K = slack of them
    # from a fresh session (one extension window, no fold), the session
    # opened outside the timer for each sample
    ks = engine.slack
    appends = [[int(x) for x in rng.integers(0, 1000, size=1)] for _ in range(ks)]
    cands_k = [make_cands() for _ in range(ks)]

    def session_once() -> float:
        engine.update_session("scan", {sf: user_seqs[sf] for sf in cfg.sequence_features})
        _sync(device)
        t0 = time.perf_counter()
        for new, cands in zip(appends, cands_k):
            engine.score_session_device("scan", user_ctx, cands, new_items={sf0: new})
        _sync(device)
        elapsed = (time.perf_counter() - t0) * 1000.0
        engine._sessions.pop("scan")
        engine._pending.discard("scan")
        return elapsed

    session_once()
    samples = [session_once() for _ in range(max(n_chains // 2, 10))]
    scanned = _scanned(samples, rtt_ms, ks)
    scanned["delta_per_request"] = 1
    report["session_delta_kv_append_device_scanned"] = scanned
    return report


def _retrieval_cfg(corpus: int, top_k: int):
    return get_config("retrieval_base", video_vocab_size=max(corpus + 1, 1000),
                      dropout_rate=0.0, top_k=top_k)


def bench_retrieval(n_requests: int, corpus: int, top_k: int, device=None) -> dict:
    device = resolve_device(device, "serving_bench")
    cfg = _retrieval_cfg(corpus, top_k)
    data = make_retrieval_data(cfg, num_users=50, num_videos=corpus, seed=0)
    params = init_retrieval_params(cfg, seed=0, device=device)

    out = {"config": f"KuaiFormer-base (6L, d=128, 256-seq), corpus {corpus}, top_k {top_k}"}
    rng = np.random.default_rng(0)
    for index_type in ("flat", "ivf"):
        index = RetrievalIndex(cfg, params, index_type=index_type,
                               ivf_clusters=min(1024, corpus // 64), ivf_nprobe=32,
                               device=device)
        index.build(data.corpus_features())
        rec = RealTimeRecommender(cfg, params, index, device=device)
        for vid in rng.integers(0, corpus, size=30):
            rec.add_interaction("u1", {
                "video_id": int(vid), "category": 1, "tag": 2,
                "duration": 30.0, "timestamp": 1700000000 + int(vid),
            })
        rec.get_recommendations("u1", top_k=top_k)  # warm
        lats = []
        for _ in range(n_requests):
            t0 = time.perf_counter()
            rec.get_recommendations("u1", top_k=top_k)
            lats.append((time.perf_counter() - t0) * 1000)
        out[index_type] = pctile(lats)
        del index, rec
    return out


def bench_retrieval_throughput(corpus: int, top_k: int, batch_sizes=(64, 256),
                               n_iters: int = 20, device=None) -> dict:
    """Batched retrieval QPS: each iteration encodes a batch of user
    histories, scans the corpus and takes the top k, ending in the host copy
    of the ids; QPS is users scored per host-clock second."""
    device = resolve_device(device, "serving_bench")
    cfg = _retrieval_cfg(corpus, top_k)
    data = make_retrieval_data(cfg, num_users=max(batch_sizes), num_videos=corpus, seed=0)
    batch = next(iter(retrieval_batches(data, cfg, batch_size=max(batch_sizes),
                                        num_epochs=1)))
    feats_all = {k: torch.as_tensor(v, device=device) for k, v in batch["history"].items()}
    valid_all = torch.as_tensor(batch["history_valid"], device=device)
    params = init_retrieval_params(cfg, seed=0, device=device)
    tower = load_tower(cfg, params, device)

    out = {"config": f"KuaiFormer-base (6L, d=128, 256-seq), corpus {corpus},"
                     f" top_k {top_k}, batched encode+scan+topk"}
    variants = [
        ("flat_exact", dict()),
        ("int8_approx99", dict(quantize="int8", approx_recall=0.99)),
    ]
    for name, kw in variants:
        index = RetrievalIndex(cfg, params, device=device, **kw)
        index.build(data.corpus_features())
        for bs in batch_sizes:
            feats = {k: v[:bs] for k, v in feats_all.items()}
            valid = valid_all[:bs]
            with torch.no_grad():
                index.search(tower(feats, valid), top_k)  # warm
                t0 = time.perf_counter()
                for _ in range(n_iters):
                    index.search(tower(feats, valid), top_k)
                dt = time.perf_counter() - t0
            entry = {"qps": float(bs * n_iters / dt), "ms_per_batch": float(dt * 1000 / n_iters)}
            if kw.get("approx_recall") is not None:
                entry["note"] = ("approx_recall=0.99 runs the exact top k "
                                 "(no approx_max_k in PyTorch)")
            out[f"{name}_batch{bs}"] = entry
        del index
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--ranking-only", action="store_true",
                    help="skip the retrieval sections")
    ap.add_argument("--candidates", type=int, default=100)
    ap.add_argument("--corpus", type=int, default=100_000)
    ap.add_argument("--top-k", type=int, default=100)
    ap.add_argument("--device-side", action="store_true",
                    help="chained-dispatch latency, one synchronize a chain, instead of "
                         "the host-observed loops")
    ap.add_argument("--chains", type=int, default=40)
    ap.add_argument("--chain-len", type=int, default=32)
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless given (cpu to run on the CPU)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    device = resolve_device(args.device, "serving_bench")
    report = {
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device)),
        "transport_rtt_ms_p50": measure_rtt(device),
        "reference_claims": {
            "kuaiformer_avg_latency_ms": 23.5,
            "kuaiformer_qps": 1250,
            "onetrans_p99_ms_batch100": 13.2,
        },
    }
    print(f"device={report['device']} rtt={report['transport_rtt_ms_p50']:.1f} ms",
          flush=True)
    if args.device_side:
        report["ranking_device_side"] = bench_ranking_device_side(
            args.chains, args.chain_len, args.candidates, device=device)
        print(json.dumps(report["ranking_device_side"], indent=2), flush=True)
    else:
        report["ranking"] = bench_ranking(args.requests, args.candidates, device=device)
        print(json.dumps(report["ranking"], indent=2), flush=True)
        if not args.ranking_only:
            report["retrieval"] = bench_retrieval(min(args.requests, 50), args.corpus,
                                                  args.top_k, device=device)
            print(json.dumps(report["retrieval"], indent=2), flush=True)
            report["retrieval_throughput"] = bench_retrieval_throughput(
                args.corpus, args.top_k, device=device)
            print(json.dumps(report["retrieval_throughput"], indent=2), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.output}")
    return report


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
