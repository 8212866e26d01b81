"""Ranking inference engine: truncate/left-pad preprocessing, single and
batch inference, latency and success stats, the cross-candidate KV cache
(``score_request`` encodes the behavior sequences once, then scores every
candidate through the NS-only path), and the cross-request session cache
(``update_session`` / ``score_session``: a user's per-layer S keys/values
kept across requests, new behavior items appended at O(Δ) cost).

Candidate counts are padded to powers of two, as in the JAX engine, so a
request scores the same rows there and here. Probabilities come back stacked
[T, B] in one device-to-host copy per request.

Loading and updating weights: ``from_checkpoint`` starts an engine from a
trainer's checkpoint directory (``config.json`` and the newest
``training/checkpoint.py`` file), ``reload`` swaps in a new state dict or
checkpoint, and ``apply_push`` applies an incremental push
(``serving/param_push.py``). Both validate the new weights against the
engine's first, then write them into the engine's own tensors (``copy_``;
a push's rows with ``index_copy_``): a malformed update leaves the engine
as it was, and the tensors' addresses never change. Live sessions are
re-encoded under the new weights.

The engine runs on CUDA unless the caller passes ``device="cpu"``; with no
device given and no CUDA available it raises.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.config import RankingConfig, load_config
from recommend_tpu_torch.convert import table_param_names
from recommend_tpu_torch.models.ranking import RankingModel
from recommend_tpu_torch.serving import param_push
from recommend_tpu_torch.training.checkpoint import CheckpointManager, wait_for_writes

Tensors = Dict[str, torch.Tensor]


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class RankingInferenceEngine:
    def __init__(
        self,
        cfg: RankingConfig,
        params: Mapping[str, torch.Tensor],
        max_seq_len: int = 64,
        slack: int = 16,
        refresh_every_compactions: int = 4,
        profile: str = "deployment",
        device=None,
    ):
        """``params``: a state dict of ``RankingModel(cfg)`` (from
        ``convert.params_from_flax`` or ``convert.init_params``).

        ``slack``: rows of a session's extension buffers. Appends fill them
        at O(Δ) cost; a full buffer is folded into the session cache's spare
        rows (``compact_s_cache``: a copy, no trunk recompute, exact), and
        every ``refresh_every_compactions`` folds the session re-anchors with
        one full S encode, which caps the cache length and the drift of its
        frozen pyramid windows and drops ids the sliding window evicted.

        ``profile`` picks when that maintenance runs:
          - ``"deployment"`` (default): due re-anchors and near-full buffers
            (fewer than ``fold_headroom`` = ``slack // 2`` free rows) are
            queued on a pending set that ``maintain()`` drains between
            requests, so their device time never sits inside a request;
          - ``"inline"``: they run right after a request's probabilities are
            fetched; no ``maintain()`` calls needed.
        An unmaintained session stays servable: when its spare rows run out
        it re-encodes inline."""
        if profile not in ("deployment", "inline"):
            raise ValueError(f"unknown profile {profile!r}")
        self.cfg = cfg
        self.device = resolve_device(device, "RankingInferenceEngine")
        with torch.device("meta"):
            model = RankingModel(cfg)
        model.load_state_dict(
            {k: torch.as_tensor(v).to(self.device) for k, v in params.items()},
            assign=True,
        )
        self.model = model.eval().requires_grad_(False)
        self.max_seq_len = max_seq_len
        self.stats_state = {
            "total": 0, "success": 0, "failure": 0, "ema_latency_ms": None,
        }
        self._latencies: deque = deque(maxlen=1000)
        self.slack = slack
        self.refresh_every_compactions = refresh_every_compactions
        self.auto_maintain = profile == "inline"
        self.fold_headroom = slack // 2 if profile == "deployment" else 0
        # sessions with deferred work; maintain() drains only these
        self._pending: set = set()
        self._sessions: Dict[Any, Dict] = {}
        # spare rows of every session cache, filled by the folds between
        # two re-anchors
        self._pad_rows = refresh_every_compactions * slack

    # -- loading ------------------------------------------------------------
    @staticmethod
    def _restore_params(checkpoint_dir: str, device) -> Tensors:
        restored = CheckpointManager(checkpoint_dir).restore(map_location=device)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint in {checkpoint_dir}")
        return restored.params

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, max_seq_len: int = 64, device=None,
                        **kwargs) -> "RankingInferenceEngine":
        """An engine on the newest checkpoint of a trainer's
        ``checkpoint_dir``, with the config of its ``config.json``."""
        device = resolve_device(device, "RankingInferenceEngine.from_checkpoint")
        wait_for_writes(checkpoint_dir)
        cfg = load_config(f"{checkpoint_dir}/config.json")
        return cls(cfg, cls._restore_params(checkpoint_dir, device),
                   max_seq_len=max_seq_len, device=device, **kwargs)

    def state_dict(self) -> Tensors:
        """The engine's weights: its own tensors, not copies."""
        return self.model.state_dict()

    @torch.no_grad()
    def reload(
        self,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        checkpoint_dir: Optional[str] = None,
        refresh_sessions: bool = True,
    ) -> None:
        """Hot swap of the weights, from a state dict or the newest
        checkpoint of ``checkpoint_dir`` (exactly one). The new weights must
        have the engine's names, shapes and dtypes, or it raises before
        writing anything; they are then copied into the engine's tensors.
        Live sessions keep their id windows and, with ``refresh_sessions``,
        are re-encoded under the new weights."""
        if (params is None) == (checkpoint_dir is None):
            raise ValueError("pass exactly one of params / checkpoint_dir")
        if checkpoint_dir is not None:
            params = self._restore_params(checkpoint_dir, self.device)
        own = self.state_dict()
        if set(params) != set(own):
            raise ValueError(f"reload: names differ: missing {sorted(set(own) - set(params))}, "
                             f"unknown {sorted(set(params) - set(own))}")
        for k, t in own.items():
            v = params[k]
            if tuple(v.shape) != tuple(t.shape) or v.dtype != t.dtype:
                raise ValueError(f"reload {k}: {tuple(v.shape)} {v.dtype}, engine "
                                 f"{tuple(t.shape)} {t.dtype}")
        for k, t in own.items():
            t.copy_(params[k])
        if refresh_sessions:
            self._refresh_sessions()

    def _refresh_sessions(self) -> None:
        for sid in list(self._sessions):
            self.refresh_session(sid)

    @torch.no_grad()
    def apply_push(self, push: Dict, refresh_sessions: bool = True) -> None:
        """Apply an incremental push (``param_push.build_push``): exact when
        the engine holds the checkpoint the delta was accumulated from. The
        whole push is validated before anything is written; then the dense
        tensors are copied and the pushed rows written into the engine's own
        tables, which are not copied."""
        own = self.state_dict()
        param_push.validate(own, push, table_param_names(self.cfg))
        # the rows reach the device before any tensor is written
        rows = {k: (d["ids"].to(self.device, torch.long), d["rows"].to(self.device, own[k].dtype))
                for k, d in push["tables"].items()}
        for k, v in push["dense"].items():
            own[k].copy_(v)
        for k, (ids, r) in rows.items():
            own[k].index_copy_(0, ids, r)
        if refresh_sessions:
            self._refresh_sessions()

    # -- preprocessing ------------------------------------------------------
    def _to_device(self, arr: np.ndarray, names: Sequence[str]) -> Tensors:
        """One host-to-device copy of a stacked [F, ...] array, split by
        feature."""
        t = torch.from_numpy(arr).to(self.device)
        return {name: t[i] for i, name in enumerate(names)}

    def _check_ids(self, feature: str, ids, table: str) -> None:
        """Raise unless every id of ``feature`` lies in ``table``'s rows,
        before anything reaches the device (JAX's ``jnp.take`` reads NaN
        there; a CUDA lookup would fault on the device)."""
        ids = np.asarray(ids)
        vocab = self.cfg.vocab_size(table)
        if ids.size and (ids.min() < 0 or ids.max() >= vocab):
            raise IndexError(f"{feature} id outside [0, {vocab}): {ids.min()}..{ids.max()}")

    def _sequence_arrays(
        self, rows: Sequence[Mapping[str, Sequence[int]]]
    ) -> Tuple[Tensors, Tensors]:
        """Truncate (keep the most recent) and left-pad each behavior
        sequence of each row -> ([B, max_seq_len] ids, validity) per
        feature."""
        l, names = self.max_seq_len, self.cfg.sequence_features
        ids = np.zeros((len(names), len(rows), l), dtype=np.int64)
        valid = np.zeros((len(names), len(rows), l), dtype=bool)
        for i, sf in enumerate(names):
            for r, seqs in enumerate(rows):
                items = list(seqs.get(sf, ()))[-l:]
                if items:
                    ids[i, r, l - len(items):] = items
                    valid[i, r, l - len(items):] = True
            self._check_ids(sf, ids[i], "item_id")
        return self._to_device(ids, names), self._to_device(valid, names)

    def preprocess_sequences(
        self, sequences: Mapping[str, Sequence[int]]
    ) -> Tuple[Tensors, Tensors]:
        """Truncate (keep the most recent) and left-pad each behavior
        sequence -> [1, max_seq_len] ids and validity on the device."""
        return self._sequence_arrays([sequences])

    def _non_seq_arrays(self, rows: List[Mapping[str, int]]) -> Tensors:
        names = self.cfg.non_seq_features
        arr = np.array([[r.get(f, 0) for r in rows] for f in names], dtype=np.int64)
        for f, ids in zip(names, arr):
            self._check_ids(f, ids, f)
        return self._to_device(arr, names)

    # -- device paths -------------------------------------------------------
    def _stack(self, logits: Tensors) -> torch.Tensor:
        return torch.stack([torch.sigmoid(logits[t]) for t in self.cfg.tasks])

    def _probs_fwd(self, ns: Tensors, seqs: Tensors, sv: Tensors) -> torch.Tensor:
        return self._stack(self.model(ns, seqs, sv))

    def _candidate_rows(self, user_context, candidates) -> Tensors:
        """Candidates padded to their bucket, merged with the user context."""
        b = _bucket(len(candidates))
        cand = list(candidates) + [candidates[-1]] * (b - len(candidates))
        return self._non_seq_arrays([dict(user_context, **c) for c in cand])

    def _probs_tiled(self, ns: Tensors, sequences) -> torch.Tensor:
        """The full forward per candidate, one history tiled over them (the
        path with ``use_kv_cache`` off)."""
        seqs, sv = self.preprocess_sequences(sequences)
        b = next(iter(ns.values())).shape[0]
        tiled = {sf: v.expand(b, -1) for sf, v in seqs.items()}
        tiled_v = {sf: v.expand(b, -1) for sf, v in sv.items()}
        return self._probs_fwd(ns, tiled, tiled_v)

    def _probs_request(self, user_context, sequences, candidates) -> torch.Tensor:
        """[T, bucket] probabilities of one request, left on the device."""
        ns = self._candidate_rows(user_context, candidates)
        if self.cfg.use_kv_cache:
            seqs, sv = self.preprocess_sequences(sequences)
            cache = self.model.encode_s(seqs, sv)
            return self._stack(self.model.score_with_cache(cache, ns))
        return self._probs_tiled(ns, sequences)

    def _rows(self, probs: torch.Tensor, n: int) -> List[Dict[str, float]]:
        p = probs.cpu().numpy()  # the request's one device-to-host copy
        return [{t: float(p[j][i]) for j, t in enumerate(self.cfg.tasks)}
                for i in range(n)]

    # -- inference ----------------------------------------------------------
    @torch.inference_mode()
    def single_inference(
        self,
        features: Mapping[str, int],
        sequences: Mapping[str, Sequence[int]],
    ) -> Dict[str, float]:
        """features: merged user/item/context dict -> per-task probabilities."""
        t0 = time.perf_counter()
        try:
            seqs, sv = self.preprocess_sequences(sequences)
            ns = self._non_seq_arrays([features])
            out = self._rows(self._probs_fwd(ns, seqs, sv), 1)[0]
            self._record(t0, ok=True)
            return out
        except Exception:
            self._record(t0, ok=False)
            raise

    @torch.inference_mode()
    def batch_inference(
        self,
        rows: List[Tuple[Mapping[str, int], Mapping[str, Sequence[int]]]],
    ) -> List[Dict[str, float]]:
        """Independent (features, sequences) rows, padded to one bucket."""
        t0 = time.perf_counter()
        n = len(rows)
        rows = list(rows) + [rows[-1]] * (_bucket(n) - n)
        ns = self._non_seq_arrays([r[0] for r in rows])
        seqs, sv = self._sequence_arrays([r[1] for r in rows])
        out = self._rows(self._probs_fwd(ns, seqs, sv), n)
        self._record(t0, ok=True)
        return out

    @torch.inference_mode()
    def score_request(
        self,
        user_context: Mapping[str, int],
        sequences: Mapping[str, Sequence[int]],
        candidates: List[Mapping[str, int]],
    ) -> List[Dict[str, float]]:
        """KV-cached request scoring: S side once, NS side per candidate.

        ``user_context``: user and context feature values shared by the
        candidates; ``candidates``: per-candidate item feature dicts.
        ``cfg.use_kv_cache`` off runs the full forward per candidate."""
        t0 = time.perf_counter()
        out = self._rows(
            self._probs_request(user_context, sequences, candidates),
            len(candidates),
        )
        self._record(t0, ok=True)
        return out

    @torch.inference_mode()
    def score_request_device(
        self,
        user_context: Mapping[str, int],
        sequences: Mapping[str, Sequence[int]],
        candidates: List[Mapping[str, int]],
    ) -> torch.Tensor:
        """``score_request`` without the host copy: the [T, bucket]
        probabilities on the device. Stats are not recorded."""
        return self._probs_request(user_context, sequences, candidates)

    def warmup(self, n_candidates: int = 1,
               deltas: Sequence[int] = (1, 2, 4, 8)) -> None:
        """Run every serving path once before live traffic: the batch
        forward, the KV-cached request and the session ladder (an append per
        Δ in ``deltas``, then appends until one fold and the re-anchor after
        it have run) on a throwaway session. Nothing is compiled, but each
        path's first call loads the kernel library, initializes the CUDA
        libraries and grows the allocator's pools outside live traffic."""
        cfg = self.cfg
        user = {f: 0 for f in cfg.user_features + cfg.context_features}
        cands = [{f: 0 for f in cfg.item_features}] * max(n_candidates, 1)
        if not cfg.sequence_features:
            self.score_request(user, {}, cands)
            self.batch_inference([(dict(user, **cands[0]), {})])
            return
        sf0 = cfg.sequence_features[0]
        seqs = {sf: [1, 2] for sf in cfg.sequence_features}
        self.batch_inference([(dict(user, **cands[0]), seqs)])
        self.score_request(user, seqs, cands)
        sid = "__warmup__"
        auto = self.auto_maintain
        self.auto_maintain = True  # the ladder below runs its maintenance inline
        try:
            self.update_session(sid, seqs)
            if not cfg.use_kv_cache:
                # the session path is the tiled full forward; no ladder
                self.score_session(sid, user, cands)
                return
            for d in deltas:
                self.score_session(sid, user, cands, new_items={sf0: [1] * d})
            # the largest power of two <= slack fits the buffer exactly, so
            # the appends fold; loop until a fold and its re-anchor have run
            step = 1 << (max(self.slack, 1).bit_length() - 1)
            folded = False
            for _ in range(4 * self.refresh_every_compactions + 8):
                self.score_session(sid, user, cands, new_items={sf0: [1] * step})
                c = self._sessions[sid]["compactions"]
                folded = folded or c > 0
                if folded and c == 0:
                    break
        finally:
            self.auto_maintain = auto
            self._sessions.pop(sid, None)
            self._pending.discard(sid)

    # -- cross-request session cache -------------------------------------------
    #
    # Session state: the id windows of each behavior sequence (host), a
    # padded refresh cache (per-layer k/v/valid from ``encode_s`` at the last
    # re-anchor, plus spare rows), extension buffers ext_k/ext_v
    # [n_layers, 1, slack, H, Dh] and the host counts ``count`` (filled
    # extension rows) and ``compactions`` (folds since the re-anchor).
    # At a re-anchor ``score_session`` equals ``score_request`` on the same
    # history; between re-anchors the appended entries are exact under the
    # pyramid windows frozen at the re-anchor. Appends are chronological
    # whatever sequence they belong to; the re-anchor restores the
    # segmented [S1 ; SEP ; S2 ; ...] layout.

    def _empty_ext(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zeroed extension buffers. Two allocations: appends write each in
        place, so they must not share storage."""
        cfg = self.cfg
        h = cfg.num_heads
        shape = (cfg.num_layers, 1, self.slack, h, cfg.embed_dim // h)
        dt = getattr(torch, cfg.active_compute_dtype)
        return (torch.zeros(shape, dtype=dt, device=self.device),
                torch.zeros(shape, dtype=dt, device=self.device))

    @torch.inference_mode()
    def refresh_session(self, session_id) -> None:
        """Re-encode the session's S trunk from its id windows (the periodic
        re-anchor): restores exact ``score_request`` semantics."""
        sess = self._sessions[session_id]
        seqs, sv = self.preprocess_sequences(sess["ids"])
        sess["cache"] = self.model.pad_s_cache(self.model.encode_s(seqs, sv),
                                               self._pad_rows)
        sess["ext_k"], sess["ext_v"] = self._empty_ext()
        sess["count"] = 0
        sess["compactions"] = 0
        sess.pop("needs_refresh", None)

    @torch.inference_mode()
    def _compact_session(self, sess) -> None:
        """Fold the extension into the cache's spare rows (in place, exact
        on scoring) and start an empty extension."""
        assert sess["compactions"] < self.refresh_every_compactions
        sess["cache"] = self.model.compact_s_cache(
            sess["cache"], sess["ext_k"], sess["ext_v"], sess["count"],
            sess["compactions"], self._pad_rows)
        sess["ext_k"], sess["ext_v"] = self._empty_ext()
        sess["count"] = 0
        sess["compactions"] += 1

    @torch.inference_mode()
    def update_session(
        self,
        session_id,
        new_items: Mapping[str, Sequence[int]],
        _defer_refresh: bool = False,
    ) -> bool:
        """Append new behavior items to a session: only the Δ new items are
        embedded and pushed through one per-layer K/V append step.

        Maintenance, cheapest first: (1) append into the extension buffer;
        (2) when the buffer cannot hold the Δ, fold it into the cache (exact
        on scoring); (3) every ``refresh_every_compactions`` folds, re-anchor
        with one ``encode_s``. With ``_defer_refresh`` (the ``score_session``
        path) step 3 is returned to the caller instead of run, so it runs
        after the request's fetch. Returns True iff a re-anchor was deferred.

        Under the deployment profile a session whose buffer is near full
        after the append is queued for ``maintain()`` here too, not only on
        the scoring path, so a session fed by direct calls is folded in idle
        time as well. A fold is an exact identity on scores, so this moves
        no probability."""
        # validate and convert before touching the store: a bad request
        # leaves every session as it was
        unknown = [sf for sf in new_items if sf not in self.cfg.sequence_features]
        if unknown:
            raise KeyError(f"unknown sequence feature(s) {unknown!r}")
        converted = {sf: [int(i) for i in ids] for sf, ids in new_items.items()}
        for sf, ids in converted.items():
            self._check_ids(sf, ids, "item_id")
        sess = self._sessions.get(session_id)
        fresh = sess is None
        if fresh:
            sess = self._sessions[session_id] = {
                "ids": {sf: [] for sf in self.cfg.sequence_features},
                "cache": None, "ext_k": None, "ext_v": None,
                "count": 0, "compactions": 0,
            }
        delta: List[int] = []
        for sf, ids in converted.items():
            if not ids:
                continue
            window = sess["ids"][sf]
            window.extend(ids)
            # keep the most recent max_seq_len; the cache ages evicted items
            # out at the next re-anchor
            del window[:-self.max_seq_len]
            delta.extend(ids)
        if fresh or sess["cache"] is None:
            self.refresh_session(session_id)
            return False
        # the append writes a whole padded bucket of rows
        db = _bucket(len(delta)) if delta else 0
        if db > self.slack:
            # larger than the whole buffer: only a re-encode can take it
            self.refresh_session(session_id)
            return False
        if sess["count"] + db > self.slack:
            if sess["compactions"] >= self.refresh_every_compactions:
                # spare rows used up (deferred re-anchors were skipped): the
                # re-encode reads ids that already hold this delta, so it is
                # not appended again
                self.refresh_session(session_id)
                return False
            self._compact_session(sess)
        if delta:
            self._append_delta(sess, delta)
            if not self.auto_maintain and self._fold_due(sess):
                self._pending.add(session_id)
        want_refresh = sess["compactions"] >= self.refresh_every_compactions
        if want_refresh and not _defer_refresh:
            self.refresh_session(session_id)
            return False
        return want_refresh

    def _append_delta(self, sess, ids: List[int]) -> None:
        n = len(ids)
        db = _bucket(n)
        padded = np.zeros((1, db), dtype=np.int64)
        padded[0, :n] = ids
        valid = torch.zeros((1, db), dtype=torch.bool)  # host: counted there
        valid[0, :n] = True
        x_new = self.model.embed_sequence_items(
            self.cfg.sequence_features[0], torch.from_numpy(padded).to(self.device))
        sess["ext_k"], sess["ext_v"], sess["count"] = self.model.extend_s_cache(
            sess["cache"], sess["ext_k"], sess["ext_v"], sess["count"], x_new, valid)

    def _probs_session(self, session_id, user_context, candidates, new_items):
        """Append (if any), then score: ([T, bucket] probabilities on the
        device, whether a re-anchor was deferred)."""
        deferred = False
        if new_items:
            deferred = self.update_session(session_id, new_items, _defer_refresh=True)
        if self._sessions.get(session_id) is None:
            self.update_session(session_id, {})
        sess = self._sessions[session_id]
        ns = self._candidate_rows(user_context, candidates)
        if not self.cfg.use_kv_cache:
            return self._probs_tiled(ns, sess["ids"]), deferred
        return self._stack(self.model.score_with_cache_ext(
            sess["cache"], sess["ext_k"], sess["ext_v"], sess["count"], ns)), deferred

    def _after_session_request(self, session_id, deferred: bool) -> None:
        """Maintenance after a session request: a deferred re-anchor, or a
        fold of a near-full buffer, runs now (inline profile) or is queued
        for ``maintain()`` (deployment profile)."""
        sess = self._sessions[session_id]
        if deferred:
            if self.auto_maintain:
                self.refresh_session(session_id)
            else:
                sess["needs_refresh"] = True
                self._pending.add(session_id)
        elif self.cfg.use_kv_cache:
            if self.auto_maintain:
                self._proactive_fold(sess)
            elif self._fold_due(sess):
                self._pending.add(session_id)

    @torch.inference_mode()
    def score_session(
        self,
        session_id,
        user_context: Mapping[str, int],
        candidates: List[Mapping[str, int]],
        new_items: Optional[Mapping[str, Sequence[int]]] = None,
    ) -> List[Dict[str, float]]:
        """Score candidates against the session's cached per-layer S K/V: the
        NS-only pass, no S re-encoding. ``new_items`` are appended first, in
        the same request, which still makes one device-to-host copy. A
        deferred re-anchor runs after that copy (inline profile) or is
        queued (deployment profile). With ``cfg.use_kv_cache`` off the
        session is scored by the full forward over its id windows."""
        t0 = time.perf_counter()
        probs, deferred = self._probs_session(session_id, user_context, candidates,
                                              new_items)
        out = self._rows(probs, len(candidates))
        self._record(t0, ok=True)
        self._after_session_request(session_id, deferred)
        return out

    @torch.inference_mode()
    def score_session_device(
        self,
        session_id,
        user_context: Mapping[str, int],
        candidates: List[Mapping[str, int]],
        new_items: Optional[Mapping[str, Sequence[int]]] = None,
    ) -> torch.Tensor:
        """``score_session`` without the host copy: the [T, bucket]
        probabilities on the device, the same session bookkeeping. Stats are
        not recorded."""
        probs, deferred = self._probs_session(session_id, user_context, candidates,
                                              new_items)
        self._after_session_request(session_id, deferred)
        return probs

    def _fold_due(self, sess) -> bool:
        """True when the extension has fewer than ``fold_headroom`` free rows
        and a fold (not a re-anchor) would absorb it."""
        return (
            self.fold_headroom > 0
            and sess.get("cache") is not None
            and sess["count"] > 0
            and sess["count"] + self.fold_headroom > self.slack
            and sess["compactions"] < self.refresh_every_compactions
        )

    def _proactive_fold(self, sess) -> bool:
        """Fold a near-full extension off the request path, so the next
        append does not fold inside its own request."""
        if self._fold_due(sess):
            self._compact_session(sess)
            return True
        return False

    @torch.inference_mode()
    def maintain(self, max_refreshes: Optional[int] = None) -> int:
        """Run queued session maintenance (re-anchors and folds) and return
        how many sessions it maintained: the hook a serving loop calls
        between requests. It drains the pending set only, so an idle tick
        costs O(pending), not O(live sessions); with ``max_refreshes`` the
        rest stays queued."""
        done = 0
        while self._pending:
            sid = self._pending.pop()
            sess = self._sessions.get(sid)
            if sess is None:
                continue  # evicted after it was queued
            did = False
            if sess.pop("needs_refresh", False):
                self.refresh_session(sid)
                did = True
            elif self.cfg.use_kv_cache:
                # appends or folds since it was queued may have cleared it
                did = self._proactive_fold(sess)
            if did:
                done += 1
                if max_refreshes is not None and done >= max_refreshes:
                    break
        return done

    def session_memory_mb(self) -> float:
        """Device bytes held by all session caches and extension buffers."""
        total = 0
        for sess in self._sessions.values():
            tensors = [t for entry in (sess.get("cache") or []) if entry is not None
                       for t in entry]
            tensors += [t for t in (sess.get("ext_k"), sess.get("ext_v")) if t is not None]
            total += sum(t.numel() * t.element_size() for t in tensors)
        return total / (1024.0 * 1024.0)

    # -- stats ----------------------------------------------------------------
    def _record(self, t0: float, ok: bool) -> None:
        dt_ms = (time.perf_counter() - t0) * 1000.0
        s = self.stats_state
        s["total"] += 1
        s["success" if ok else "failure"] += 1
        ema = s["ema_latency_ms"]
        s["ema_latency_ms"] = dt_ms if ema is None else 0.9 * ema + 0.1 * dt_ms
        self._latencies.append(dt_ms)

    def stats(self) -> Dict[str, float]:
        s = dict(self.stats_state)
        lats = np.asarray(self._latencies)
        if len(lats):
            s.update(
                latency_ms_p50=float(np.percentile(lats, 50)),
                latency_ms_p95=float(np.percentile(lats, 95)),
                latency_ms_p99=float(np.percentile(lats, 99)),
                success_rate=s["success"] / max(s["total"], 1),
                est_qps=1000.0 / max(float(np.mean(lats)), 1e-9),
            )
        return s
