"""Flagship-scale retrieval serving benchmark on the PyTorch/CUDA port: the
counterpart of ``examples/flagship_serving_bench.py``, the 10M-item corpus
row.

  - index build time: all 10M items through the item tower;
  - query latency: the flat exact scan, the int8 corpus and int8 with
    ``approx_recall=0.99``, single request and batch 64, with top-100 recall
    against the exact scan, and one request end to end (encode + search);
  - an int8 IVF index (4096 clusters, nprobe 16): build time, recall and
    latency;
  - checkpoint save and restore of the parameters (the 5.12 GB video
    table) and the incremental parameter push at flagship size.

The config, corpus and histories are the JAX script's (``retrieval_flagship``,
dropout 0, top 100, the corpus and 64 histories from numpy seed 0); the
weights are random from seed 0 (``convert.init_retrieval_params``), so
recalls and times are the port's own. The int8 indexes are given the flat
index's corpus and its int8 copy by assignment, as the JAX script does.

Where the port computes a quantity otherwise, the key stays and a ``note``
says how: ``approx_recall`` runs the exact top k (PyTorch has no
``lax.approx_max_k``); ``CheckpointManager.save`` is synchronous
(``torch.save``), so the save returns when the bytes are written and no
device step overlaps the write.

Usage:
    python examples_torch/flagship_serving_bench.py --output flagship_serving.json
    python examples_torch/flagship_serving_bench.py --corpus 3000 --device cpu

With no ``--phase`` every phase runs in turn in this process, each
releasing its tensors before the next (the card's 80 GB hold each phase;
the JAX script ran each in its own process to fit a 16 GB TPU). It runs on
the card unless given ``--device cpu``; without CUDA and without
``--device`` it raises.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.config import get_config
from recommend_tpu_torch.convert import init_retrieval_params
from recommend_tpu_torch.ops.ivf import build_ivf, ivf_search_interests
from recommend_tpu_torch.ops.topk import quantize_corpus, topk_retrieval
from recommend_tpu_torch.serving.param_push import build_push, save_push
from recommend_tpu_torch.serving.retrieval_service import RetrievalIndex
from recommend_tpu_torch.training.checkpoint import CheckpointManager

APPROX_NOTE = "approx_recall=0.99 runs the exact top k (no approx_max_k in PyTorch)"
SAVE_NOTE = ("CheckpointManager.save is synchronous (torch.save): it returns when the "
             "checkpoint is written, so no device step overlaps the write")


def _log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def _release(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _setup(corpus: int, device: torch.device):
    """The JAX script's config, synthetic corpus features and 64 histories
    (numpy seed 0), and a random state dict (seed 0) on ``device``."""
    cfg = get_config("retrieval_flagship", dropout_rate=0.0, top_k=100,
                     video_vocab_size=corpus)
    rng = np.random.default_rng(0)
    corpus_features = {
        "video_id": np.arange(corpus, dtype=np.int64),
        "category": rng.integers(1, cfg.category_vocab_size, corpus),
        "tag": rng.integers(1, cfg.tag_vocab_size, corpus),
        "duration": rng.uniform(5, 300, corpus).astype(np.float32),
        "timestamp": np.full(corpus, 1_700_000_000, np.int64),
    }
    hist = {
        "video_id": rng.integers(0, corpus, (64, cfg.max_seq_len)),
        "category": rng.integers(1, cfg.category_vocab_size, (64, cfg.max_seq_len)),
        "tag": rng.integers(1, cfg.tag_vocab_size, (64, cfg.max_seq_len)),
        "duration": rng.uniform(5, 300, (64, cfg.max_seq_len)).astype(np.float32),
        "timestamp": np.full((64, cfg.max_seq_len), 1_700_000_000, np.int64),
    }
    feats = {k: torch.as_tensor(v, device=device) for k, v in hist.items()}
    valid = torch.ones((64, cfg.max_seq_len), dtype=torch.bool, device=device)
    params = init_retrieval_params(cfg, seed=0, device=device)
    return cfg, params, corpus_features, feats, valid


def _recall(ref_ids: np.ndarray, got_ids: np.ndarray) -> float:
    """Mean per-query overlap of the top-k id sets."""
    hits = [len(set(map(int, r)) & set(map(int, g))) / len(r)
            for r, g in zip(ref_ids, got_ids)]
    return float(np.mean(hits))


def _p50_ms(fn, calls: int) -> tuple:
    """(p50, mean) host-clock ms of ``calls`` calls after one warm-up call;
    each call ends in a host copy."""
    fn()
    lats = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        lats.append((time.perf_counter() - t0) * 1000)
    return float(np.percentile(lats, 50)), float(np.mean(lats))


def _build_index(cfg, params, corpus_features, device, report) -> RetrievalIndex:
    index = RetrievalIndex(cfg, params, device=device)
    t0 = time.perf_counter()
    index.build(corpus_features)
    _sync(device)
    report["index_build_s"] = time.perf_counter() - t0
    _log(f"build took {report['index_build_s']:.2f}s")
    return index


def phase_flat(corpus: int, out_path: str, device=None) -> dict:
    device = resolve_device(device, "flagship_serving_bench")
    cfg, params, corpus_features, feats, valid = _setup(corpus, device)
    report = {"corpus": corpus, "device": _device_name(device)}

    _log(f"flat phase: building the index over {corpus} items")
    index = _build_index(cfg, params, corpus_features, device, report)
    encode = index.model  # the tower the index holds, on the same weights
    with torch.no_grad():
        interests64 = encode(feats, valid)
    interests1 = interests64[:1]
    _, ref_ids = index.search(interests64, 100)  # exact reference

    variants = [("flat_exact", dict())]
    variants += [("int8_exact", dict(quantize="int8"))]
    variants += [("int8_approx99", dict(quantize="int8", approx_recall=0.99))]
    for name, kw in variants:
        if kw:
            vindex = RetrievalIndex(cfg, params, device=device, **kw)
            # reuse the already-embedded matrix (quantization derives from it)
            vindex.item_embeddings = index.item_embeddings
            vindex.q_items, vindex.q_scales = quantize_corpus(index.item_embeddings)
        else:
            vindex = index
        entry = {}
        _, got = vindex.search(interests64, 100)
        entry["top100_recall_vs_exact"] = _recall(ref_ids, got)
        for tag, ints, b in (("batch1", interests1, 1), ("batch64", interests64, 64)):
            p50, mean = _p50_ms(lambda: vindex.search(ints, 100), 20)
            entry[f"search_ms_p50_{tag}"] = p50
            if b > 1:
                entry[f"search_qps_{tag}"] = b * 1000 / mean

        def once():
            with torch.no_grad():
                ints = encode({k: v[:1] for k, v in feats.items()}, valid[:1])
            return vindex.search(ints, 100)

        entry["end_to_end_ms_p50_batch1"] = _p50_ms(once, 20)[0]
        if kw.get("approx_recall") is not None:
            entry["note"] = APPROX_NOTE
        report[name] = entry
        _log(f"{name}: {entry}")
        del vindex
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    return report


def phase_ivf(corpus: int, out_path: str, clusters: int = 4096, nprobe: int = 16,
              device=None) -> dict:
    device = resolve_device(device, "flagship_serving_bench")
    cfg, params, corpus_features, feats, valid = _setup(corpus, device)
    report = {"corpus": corpus, "clusters": clusters, "nprobe": nprobe,
              "device": _device_name(device)}

    # embed the corpus, capture the query interests, then drop the tower
    index = _build_index(cfg, params, corpus_features, device, report)
    with torch.no_grad():
        ints64 = index.model(feats, valid)
    items = index.item_embeddings
    del params, index, feats, valid
    _release(device)

    # mean bucket = corpus / clusters; the capacity caps the tail (overflow
    # items fall out of the probe set and count against recall). 4096
    # clusters x nprobe 16 probe ~1% of a 10M corpus a query; batch-64
    # queries go in chunks of 16 users, as the JAX script sends them.
    capacity = int(corpus / clusters * 2.5)
    _log(f"ivf build: {clusters} clusters, capacity {capacity}")
    t0 = time.perf_counter()
    ivf = build_ivf(items, n_clusters=clusters, capacity=capacity, quantize="int8", iters=5)
    _sync(device)
    report["ivf_build_s"] = time.perf_counter() - t0
    _log(f"ivf build took {report['ivf_build_s']:.2f}s")

    ints1 = ints64[:1]
    _, ref_ids = topk_retrieval(ints64, items, 100)  # exact reference
    ref_ids = ref_ids.cpu().numpy()
    del items
    _release(device)

    def chunked_search(ints, chunk=16):
        return np.concatenate([ivf_search_interests(ivf, ints[i:i + chunk], 100,
                                                    nprobe=nprobe)[1]
                               for i in range(0, ints.shape[0], chunk)])

    report["top100_recall_vs_exact"] = _recall(ref_ids, chunked_search(ints64))
    for tag, ints, b in (("batch1", ints1, 1), ("batch64", ints64, 64)):
        p50, mean = _p50_ms(lambda: chunked_search(ints), 10)
        report[f"search_ms_p50_{tag}"] = p50
        if b > 1:
            report[f"search_qps_{tag}"] = b * 1000 / mean
    _log(json.dumps(report))
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    return report


def phase_checkpoint(corpus: int, out_path: str, device=None) -> dict:
    """Flagship parameter persistence: a checkpoint save (synchronous, so
    its return time is its write time), its restore (held equal), and the minute-level incremental push: the dense trunk and
    16,384 drawn video rows (one scatter-budget window), every other table
    left out, as the JAX script's push carries its touched tables only."""
    device = resolve_device(device, "flagship_serving_bench")
    cfg, params, *_ = _setup(corpus, device)
    nbytes = sum(v.numel() * v.element_size() for v in params.values())
    report = {"corpus": corpus, "params_gb": nbytes / 2**30, "device": _device_name(device),
              "note": SAVE_NOTE}
    with tempfile.TemporaryDirectory() as d:
        mngr = CheckpointManager(d, max_to_keep=1)
        _sync(device)
        t0 = time.perf_counter()
        mngr.save(0, params, {})
        report["orbax_save_return_s"] = time.perf_counter() - t0
        mngr.wait()
        report["orbax_save_total_s"] = report["orbax_save_return_s"]
        report["overlapped_device_steps_during_write"] = 0
        t0 = time.perf_counter()
        restored = mngr.restore(map_location=device)
        _sync(device)
        report["orbax_restore_s"] = time.perf_counter() - t0
        differ = [k for k, v in params.items() if not torch.equal(restored.params[k], v)]
        if differ:
            raise RuntimeError(f"the restored checkpoint differs in {differ}")
        del restored
        mngr.close()
        rng = np.random.default_rng(0)
        ids = np.unique(rng.integers(0, corpus, 16_384)).astype(np.int64)
        touched = {k: np.zeros(0, np.int64) for k in params if k.startswith("embed.tables.")}
        touched["embed.tables.video_id.weight"] = ids
        t0 = time.perf_counter()
        push = build_push(params, touched, step=0)
        report["push_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        wire = save_push(push, os.path.join(d, "push.npz"))
        report["push_save_s"] = time.perf_counter() - t0
        report["push_mb"] = wire / 2**20
        report["push_rows"] = int(ids.size)
        report["push_vs_full_checkpoint"] = nbytes / max(wire, 1)
    _log(json.dumps(report))
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    return report


PHASES = {"flat": phase_flat, "ivf": phase_ivf, "checkpoint": phase_checkpoint}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", type=int, default=10_000_000)
    ap.add_argument("--phase", choices=sorted(PHASES), default=None)
    ap.add_argument("--output", default="flagship_serving.json")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless given (cpu to run on the CPU)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Returns the phase's report, or with no ``--phase`` every phase's."""
    device = resolve_device(args.device, "flagship_serving_bench")
    if args.phase:
        return PHASES[args.phase](args.corpus, args.output, device=device)
    report = {}
    for phase in ("flat", "ivf", "checkpoint"):
        part = f"{args.output}.{phase}"
        _log(f"=== phase {phase} ===")
        report[phase] = PHASES[phase](args.corpus, part, device=device)
        os.remove(part)
        _release(device)
    print(json.dumps(report, indent=2))
    with open(args.output, "w") as f:
        json.dump(report, f, indent=2)
    _log(f"wrote {args.output}")
    return report


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
