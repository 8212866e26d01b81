"""Retrieval serving: the corpus index (flat, int8 or IVF) and the real-time
session recommender, the port of the JAX package's
``serving/retrieval_service.py``.

- ``RetrievalIndex`` embeds the whole corpus through the item tower in
  batches and searches it: exact brute-force scoring (``index_type="flat"``),
  over a per-row int8 copy (``quantize="int8"``), or through an IVF index
  (``index_type="ivf"``). ``search()`` takes IVF first, then int8, then the
  flat scan. ``approx_recall`` has no approximate top k to select here (no
  ``lax.approx_max_k`` in PyTorch): the exact one runs, which meets any
  recall target.
- ``update_items`` re-embeds the given items only and writes their rows into
  the live corpus (appends must be contiguous from the current end), its
  int8 copy and, in place, the IVF buckets; ``refresh(params)`` validates a
  new state dict, copies it into the tower's own tensors and re-embeds the
  live corpus.
- ``RealTimeRecommender``: per-user sliding-window sessions, interests from
  the tower, per-interest top k, union, re-rank by max score (the paper's
  strategy; mean-pooling the interests is an option).

``search`` returns host numpy after one device-to-host wait, as the JAX
index returns numpy. Every entry point runs on CUDA unless given
``device="cpu"``; with no device given and no CUDA available it raises.

With a ``mesh`` (``parallel.make_mesh``; every rank builds the same index
and makes the same calls) a flat, unquantized corpus whose size divides the
``data`` axis is row-sharded over it, placed once at ``build``: each rank
holds V/n rows, ``search`` runs ``sharded_topk_retrieval``, ``fetch_items``
serves the ids by the all-to-all protocol (``sharded_lookup_a2a``) and
returns every row on every rank, and ``update_items`` writes each rank's
own rows in place. IVF and int8 take precedence over the sharded scan
(IVF > int8 > sharded > exact) and keep the whole corpus on every rank; a
corpus that does not divide falls back to the replicated scan, as JAX's
does. ``num_items`` is the corpus size whatever the layout, derived from
the corpus the index holds (as JAX bounds k by its held corpus), so an
index whose tensors are assigned rather than built searches it too.
"""

from __future__ import annotations

import time
import warnings
from collections import deque
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.config import RetrievalConfig
from recommend_tpu_torch.parallel.embedding_sharding import shard_table, sharded_lookup_a2a
from recommend_tpu_torch.parallel.sharding import block
from recommend_tpu_torch.data.pipeline import FEATURE_KEYS
from recommend_tpu_torch.models.retrieval import load_tower
from recommend_tpu_torch.ops.ivf import build_ivf, ivf_search_interests
from recommend_tpu_torch.ops.topk import (
    quantize_corpus,
    sharded_topk_retrieval,
    to_host,
    topk_retrieval,
    topk_retrieval_quantized,
)


class RetrievalIndex:
    """Corpus item-embedding matrix + top-k search."""

    def __init__(
        self,
        cfg: RetrievalConfig,
        params: Mapping[str, torch.Tensor],
        mesh=None,
        embed_batch: int = 8192,
        index_type: str = "flat",
        ivf_clusters: int = 1024,
        ivf_nprobe: int = 32,
        ivf_iters: int = 10,
        quantize: Optional[str] = None,
        approx_recall: Optional[float] = None,
        device=None,
    ):
        """``params``: a state dict of ``RetrievalTower(cfg)``, copied into
        the index's own tower; ``refresh`` is the only way new weights
        reach it. ``mesh``: the corpus is row-sharded over its ``data``
        axis (the index runs on the mesh's device)."""
        assert index_type in ("flat", "ivf"), index_type
        assert quantize in (None, "int8"), quantize
        if mesh is not None and quantize is not None:
            # search() precedence: the int8 scan runs on the whole corpus on
            # every rank; there is no sharded quantized scan
            warnings.warn(
                "RetrievalIndex: both mesh and quantize set — the int8 "
                "quantized scan takes precedence and runs on one device; "
                "sharded_topk_retrieval is NOT used",
                stacklevel=2,
            )
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device, "RetrievalIndex")
        self.model = load_tower(cfg, params, self.device)
        self.embed_batch = embed_batch
        self.index_type = index_type
        self.ivf_clusters = ivf_clusters
        self.ivf_nprobe = ivf_nprobe
        self.ivf_iters = ivf_iters
        self.quantize = quantize
        self.approx_recall = approx_recall
        self.item_embeddings: Optional[torch.Tensor] = None
        self.q_items: Optional[torch.Tensor] = None
        self.q_scales: Optional[torch.Tensor] = None
        self.ivf_index = None
        self.sharded = False  # item_embeddings holds this rank's rows only
        self._last_corpus: Optional[Dict[str, np.ndarray]] = None

    @torch.no_grad()
    def _embed(self, features: Mapping[str, np.ndarray]) -> torch.Tensor:
        """Item-tower rows [N, D] of the given items, ``embed_batch`` at a
        time. An id outside its table raises (JAX clamps it to the last row;
        on CUDA the lookup would fault on the device)."""
        cfg = self.cfg
        for k, vocab in (("video_id", cfg.video_vocab_size),
                         ("category", cfg.category_vocab_size), ("tag", cfg.tag_vocab_size)):
            ids = np.asarray(features[k])
            if len(ids) and (ids.min() < 0 or ids.max() >= vocab):
                raise ValueError(f"{k} outside [0, {vocab}): {ids.min()}..{ids.max()}")
        cols = {k: torch.as_tensor(np.asarray(features[k])).to(self.device)
                for k in FEATURE_KEYS}
        n = len(cols["video_id"])
        out = None
        for i in range(0, n, self.embed_batch):
            e = self.model.item_embeddings({k: c[i:i + self.embed_batch]
                                            for k, c in cols.items()})
            if out is None:
                out = torch.empty((n, e.shape[1]), dtype=e.dtype, device=self.device)
            out[i:i + self.embed_batch] = e
        return out

    def build(self, corpus_features: Mapping[str, np.ndarray]) -> None:
        """Embed every corpus item (row index == video id)."""
        # a copy that update_items folds deltas into, so refresh() re-embeds
        # the live corpus
        self._last_corpus = {k: np.array(v) for k, v in corpus_features.items()}
        self._place(self._embed(corpus_features))
        if self.quantize == "int8":
            self.q_items, self.q_scales = quantize_corpus(self.item_embeddings)
        if self.index_type == "ivf":
            self.ivf_index = build_ivf(self.item_embeddings, n_clusters=self.ivf_clusters,
                                       iters=self.ivf_iters, quantize=self.quantize)

    @property
    def num_items(self) -> int:
        """The corpus size: the rows of ``item_embeddings``, times the
        ``data`` axis when they are this rank's block of a sharded corpus
        (0 before there is a corpus)."""
        if self.item_embeddings is None:
            return 0
        v = self.item_embeddings.shape[0]
        return v * self.mesh.shape["data"] if self.sharded else v

    def _place(self, corpus: torch.Tensor) -> None:
        """Hold the [V, D] corpus: this rank's row block when it shards,
        whole otherwise."""
        n = 1 if self.mesh is None else self.mesh.shape["data"]
        self.sharded = (self.mesh is not None and self.index_type == "flat"
                        and self.quantize is None and corpus.shape[0] % n == 0)
        self.item_embeddings = (shard_table(self.mesh, corpus, axis="data")
                                if self.sharded else corpus)

    def _whole(self) -> torch.Tensor:
        """The [V, D] corpus (gathered from every rank when sharded)."""
        if not self.sharded:
            return self.item_embeddings
        return self.mesh.all_gather(self.item_embeddings, "data")

    @torch.no_grad()
    def update_items(self, item_features: Mapping[str, np.ndarray]) -> None:
        """Re-embed only the given items and write their rows into the live
        corpus, its int8 copy and the IVF buckets. ``video_id`` selects the
        rows; a duplicated id takes its last row. Ids past the corpus end
        append, and must run contiguously from it. IVF: rows of existing ids
        are rewritten in their buckets in place (assignments are not
        revisited; ``build()`` rebalances), and appends raise. On a sharded
        corpus each rank writes the rows it holds; an append gathers the
        corpus and places it again."""
        assert self.item_embeddings is not None, "call build() first"
        ids = np.asarray(item_features["video_id"], np.int64)
        # dedup, keep the LAST occurrence
        _, last_idx = np.unique(ids[::-1], return_index=True)
        keep = np.sort(len(ids) - 1 - last_idx)
        if len(keep) != len(ids):
            ids = ids[keep]
            item_features = {k: np.asarray(item_features[k])[keep] for k in item_features}
        rows = self._embed(item_features)
        v = self.num_items
        if self.sharded and ids.max() < v:
            lv = self.item_embeddings.shape[0]
            mine = ids // lv == self.mesh.rank("data")
            own = torch.as_tensor(np.flatnonzero(mine), device=self.device)
            self.item_embeddings[torch.as_tensor(ids[mine] % lv, device=self.device)] = rows[own]
            self._record(ids, item_features)
            return
        if self.sharded:  # an append: the corpus whole, placed again below
            self.item_embeddings, self.sharded = self._whole(), False
        if ids.max() >= v:  # append-grow
            if self.ivf_index is not None:
                raise ValueError(
                    "appending new ids to an IVF index requires build(); "
                    "update_items only refreshes existing rows in place")
            # a gap would leave zero rows that outrank real items (0 > negative scores)
            new_ids = np.unique(ids[ids >= v])
            if not np.array_equal(new_ids, np.arange(v, int(ids.max()) + 1)):
                missing = sorted(set(range(v, int(ids.max()) + 1)) - set(new_ids.tolist()))
                raise ValueError(
                    f"append must be contiguous from current size {v}; "
                    f"missing ids {missing[:10]}{'...' if len(missing) > 10 else ''}")
            grow = int(ids.max()) + 1 - v
            self.item_embeddings = torch.cat(
                [self.item_embeddings, self.item_embeddings.new_zeros((grow, rows.shape[1]))])
        ids_t = torch.as_tensor(ids, device=self.device)
        self.item_embeddings[ids_t] = rows
        self._place(self.item_embeddings)
        if self.quantize == "int8":
            self.q_items, self.q_scales = (
                quantize_corpus(self.item_embeddings)
                if ids.size > v // 4 else self._update_quantized(ids_t, rows))
        if self.ivf_index is not None:
            self._update_buckets(ids_t, rows)
        self._record(ids, item_features)

    def _record(self, ids: np.ndarray, item_features: Mapping[str, np.ndarray]) -> None:
        """Fold an update into the live corpus that ``refresh`` re-embeds."""
        if self._last_corpus is not None:
            cur = len(self._last_corpus["video_id"])
            need = int(ids.max()) + 1
            for k in FEATURE_KEYS:
                col = self._last_corpus[k]
                if need > cur:
                    col = np.concatenate([col, np.zeros(need - cur, dtype=col.dtype)])
                col[ids] = np.asarray(item_features[k])
                self._last_corpus[k] = col

    def _update_quantized(self, ids: torch.Tensor,
                          rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        q_rows, s_rows = quantize_corpus(rows)
        q_items, q_scales = self.q_items, self.q_scales
        grow = int(ids.max()) + 1 - q_items.shape[0]
        if grow > 0:
            q_items = torch.cat([q_items, q_items.new_zeros((grow, q_items.shape[1]))])
            q_scales = torch.cat([q_scales, q_scales.new_zeros((grow,))])
        q_items[ids] = q_rows
        q_scales[ids] = s_rows
        return q_items, q_scales

    def _update_buckets(self, ids: torch.Tensor, rows: torch.Tensor) -> None:
        """Write the rows of ``ids`` (unique) into their bucket slots."""
        ivf = self.ivf_index
        slot_ids = ivf.bucket_ids.reshape(-1)
        slots = torch.isin(slot_ids, ids).nonzero().squeeze(1)
        sorted_ids, perm = torch.sort(ids)
        row = perm[torch.searchsorted(sorted_ids, slot_ids[slots])]
        embs = ivf.bucket_embs.view(-1, ivf.bucket_embs.shape[-1])
        if ivf.bucket_scales is None:
            embs[slots] = rows[row].to(embs.dtype)
            return
        q_rows, s_rows = quantize_corpus(rows)
        embs[slots] = q_rows[row]
        ivf.bucket_scales.view(-1)[slots] = s_rows[row]

    @torch.no_grad()
    def refresh(self, params: Mapping[str, torch.Tensor]) -> None:
        """Full parameter push: the new state dict must have the tower's
        names, shapes and dtypes, or this raises before writing anything;
        it is then copied into the tower's tensors and the live corpus is
        re-embedded."""
        own = self.model.state_dict()
        if set(params) != set(own):
            raise ValueError(f"refresh: names differ: missing {sorted(set(own) - set(params))}, "
                             f"unknown {sorted(set(params) - set(own))}")
        new = {k: torch.as_tensor(v) for k, v in params.items()}
        for k, t in own.items():
            if tuple(new[k].shape) != tuple(t.shape) or new[k].dtype != t.dtype:
                raise ValueError(f"refresh {k}: {tuple(new[k].shape)} {new[k].dtype}, "
                                 f"tower {tuple(t.shape)} {t.dtype}")
        for k, t in own.items():
            t.copy_(new[k])
        if self._last_corpus is not None:
            self.build(self._last_corpus)

    def fetch_items(self, item_ids) -> torch.Tensor:
        """Embedding rows of the given item ids -> [N, D]. On a sharded
        corpus the ids, padded to a multiple of the ranks with the sentinel
        V, are served by the all-to-all protocol, each rank fetching for its
        block of them, and every rank gets all N rows."""
        assert self.item_embeddings is not None, "call build() first"
        ids = np.asarray(item_ids, dtype=np.int64)
        if not self.sharded:
            return self.item_embeddings[torch.as_tensor(ids, device=self.device)]
        n = self.mesh.shape["data"]
        padded = np.concatenate([ids, np.full((-len(ids)) % n, self.num_items, np.int64)])
        mine = torch.as_tensor(block(padded, n, self.mesh.rank("data")), device=self.device)
        rows = sharded_lookup_a2a(self.mesh, self.item_embeddings, mine, axis="data")
        return self.mesh.all_gather(rows, "data")[: len(ids)]

    def similar_items(self, item_ids,
                      top_k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Item-to-item channel: the given items' rows as queries over the
        corpus. The seed item itself ranks first (score |v|²)."""
        return self.search(self.fetch_items(item_ids)[:, None, :], top_k)

    @torch.no_grad()
    def search(self, interests, top_k: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """interests [B, k, D] -> (scores [B, K] float32, item ids [B, K]
        int64), host numpy."""
        assert self.item_embeddings is not None, "call build() first"
        interests = torch.as_tensor(interests, device=self.device)
        k = min(top_k or self.cfg.top_k, self.num_items)
        if self.ivf_index is not None:
            return ivf_search_interests(self.ivf_index, interests, k, nprobe=self.ivf_nprobe)
        if self.q_items is not None:
            s, i = topk_retrieval_quantized(interests, self.q_items, self.q_scales, k,
                                            self.approx_recall)
        elif self.sharded:
            s, i = sharded_topk_retrieval(self.mesh, interests, self.item_embeddings, k)
        else:
            s, i = topk_retrieval(interests, self.item_embeddings, k)
        return to_host(s, i)


class RealTimeRecommender:
    """Per-user sliding-window session store + recommendation API."""

    def __init__(
        self,
        cfg: RetrievalConfig,
        params: Mapping[str, torch.Tensor],
        index: RetrievalIndex,
        window: Optional[int] = None,
        device=None,
    ):
        """``params``: the tower's state dict, copied: the recommender keeps
        its own weights, which ``index.refresh`` does not change."""
        self.cfg = cfg
        self.device = resolve_device(device, "RealTimeRecommender")
        if index.device != self.device:
            raise ValueError(f"RealTimeRecommender on {self.device}, index on {index.device}")
        self.model = load_tower(cfg, params, self.device)
        self.index = index
        self.window = window or cfg.max_seq_len
        self.sessions: Dict[object, deque] = {}
        self._latencies: deque = deque(maxlen=1000)

    def add_interaction(self, user_id, item: Mapping[str, float]) -> None:
        """item: dict with video_id/category/tag/duration/timestamp."""
        q = self.sessions.setdefault(user_id, deque(maxlen=self.window))
        q.append({k: item[k] for k in FEATURE_KEYS})

    def _pad_session(self, user_id) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Left-pad the session to max_seq_len."""
        l = self.cfg.max_seq_len
        sess = list(self.sessions.get(user_id, ()))[-l:]
        n = len(sess)
        feats = {}
        for k in FEATURE_KEYS:
            arr = np.zeros((1, l), dtype=np.float32 if k == "duration" else np.int64)
            if n:
                arr[0, l - n:] = [it[k] for it in sess]
            feats[k] = torch.as_tensor(arr, device=self.device)
        valid = np.zeros((1, l), dtype=bool)
        valid[0, l - n:] = True
        return feats, torch.as_tensor(valid, device=self.device)

    @torch.no_grad()
    def user_interests(self, user_id) -> torch.Tensor:
        feats, valid = self._pad_session(user_id)
        return self.model(feats, valid)  # [1, k, D]

    def get_recommendations(
        self,
        user_id,
        top_k: int = 10,
        exclude_seen: bool = True,
        mean_pool_interests: bool = False,
    ) -> List[Dict[str, float]]:
        t0 = time.perf_counter()
        interests = self.user_interests(user_id)
        if mean_pool_interests:
            interests = interests.mean(dim=1, keepdim=True)
        seen = ({it["video_id"] for it in self.sessions.get(user_id, ())}
                if exclude_seen else set())
        # over-fetch to survive the exclusion filter
        fetch = min(top_k + len(seen), self.index.num_items)
        scores, ids = self.index.search(interests, fetch)
        out = []
        for s, i in zip(scores[0], ids[0]):
            if int(i) in seen:
                continue
            out.append({"video_id": int(i), "score": float(s)})
            if len(out) >= top_k:
                break
        self._latencies.append(time.perf_counter() - t0)
        return out

    def similar_to(self, video_id: int, top_k: int = 10) -> List[Dict[str, float]]:
        """Item-to-item channel: neighbors of one item, the seed excluded."""
        t0 = time.perf_counter()
        scores, ids = self.index.similar_items([int(video_id)], top_k + 1)
        out = [{"video_id": int(i), "score": float(s)}
               for s, i in zip(scores[0], ids[0]) if int(i) != int(video_id)][:top_k]
        self._latencies.append(time.perf_counter() - t0)
        return out

    def stats(self) -> Dict[str, float]:
        lats = np.asarray(self._latencies) * 1000.0
        if len(lats) == 0:
            return {"requests": 0}
        return {
            "requests": int(len(lats)),
            "latency_ms_p50": float(np.percentile(lats, 50)),
            "latency_ms_p95": float(np.percentile(lats, 95)),
            "latency_ms_p99": float(np.percentile(lats, 99)),
            "latency_ms_mean": float(lats.mean()),
        }
