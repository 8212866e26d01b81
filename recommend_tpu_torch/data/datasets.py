"""Open-dataset loaders — MovieLens-1M (retrieval), Taobao UserBehavior
(ranking), and Criteo Kaggle (NS-only CTR ranking): a copy of the JAX
package's ``data/datasets.py`` (stdlib and numpy only).

These realize the benchmark configs named in BASELINE.json ("BERT4Rec
masked-item model on MovieLens-1M", "OneTrans-small ... Taobao/Criteo-seq
sample"): they parse the standard public file formats from local disk (the
loaders download nothing — point them at a local copy) and
emit the exact same containers the synthetic factories produce
(`SyntheticRetrievalData` / `SyntheticRankingData`), so every downstream
pipeline — `retrieval_batches`, `ranking_batches`, trainers, evaluators,
serving — works unchanged on real data.

Reference parity: the reference repo has no dataset loaders at all (its data
layer is synthetic-only — kuaiformer data_loader.py:304-350, oneTrans
data_loader.py:126-154); its published paper numbers come from proprietary
production logs. These loaders close the open-dataset evaluation loop the
reference only describes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from recommend_tpu_torch.config import RankingConfig, RetrievalConfig
from recommend_tpu_torch.data.synthetic import SyntheticRankingData, SyntheticRetrievalData

# MovieLens-1M's fixed genre vocabulary (README of the dataset).
ML_GENRES = (
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
)
_GENRE_ID = {g: i + 1 for i, g in enumerate(ML_GENRES)}  # 0 = unknown


def load_movielens_1m(
    root: str,
    cfg: RetrievalConfig,
    min_interactions: int = 5,
    max_users: Optional[int] = None,
    ratings_file: str = "ratings.dat",
    movies_file: str = "movies.dat",
) -> SyntheticRetrievalData:
    """Parse MovieLens-1M into the retrieval data container.

    Format: ``ratings.dat`` lines are ``UserID::MovieID::Rating::Timestamp``;
    ``movies.dat`` lines are ``MovieID::Title::Genres`` (pipe-separated
    genres; latin-1 encoded). Feature mapping:
      - ``video_id``: movies re-indexed by descending popularity (so id 0 is
        the most-watched item — matches the synthetic factory's convention
        and keeps ids within ``cfg.video_vocab_size``).
      - ``category``: first genre (fixed 18-genre vocab, 0 = unknown).
      - ``tag``: hash of the full genre combination mod ``tag_vocab_size``.
      - ``duration``: rating × 60 s — a watch-time proxy so the duration
        bucketizer sees a 5-level engagement signal (MovieLens has no
        durations; the kuaiformer feature slot expects seconds).
      - ``timestamp``: raw unix seconds.
    Users are time-sorted sequences; users with fewer than
    ``min_interactions`` events are dropped (BERT4Rec protocol).
    """
    ratings_path = os.path.join(root, ratings_file)
    if not os.path.exists(ratings_path):
        raise FileNotFoundError(
            f"{ratings_path} not found — download MovieLens-1M and point "
            "`root` at the extracted directory (the loader downloads nothing)."
        )

    movie_genres: Dict[int, Tuple[str, ...]] = {}
    movies_path = os.path.join(root, movies_file)
    if os.path.exists(movies_path):
        with open(movies_path, encoding="latin-1") as f:
            for line in f:
                parts = line.rstrip("\n").split("::")
                if len(parts) >= 3:
                    movie_genres[int(parts[0])] = tuple(parts[2].split("|"))

    by_user: Dict[int, List[Tuple[int, int, int]]] = {}
    counts: Dict[int, int] = {}
    with open(ratings_path, encoding="latin-1") as f:
        for line in f:
            parts = line.rstrip("\n").split("::")
            if len(parts) != 4:
                continue
            u, m, r, ts = int(parts[0]), int(parts[1]), int(float(parts[2])), int(parts[3])
            by_user.setdefault(u, []).append((ts, m, r))
            counts[m] = counts.get(m, 0) + 1

    # popularity-ranked contiguous item ids
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    if len(ranked) > cfg.video_vocab_size:
        raise ValueError(
            f"{len(ranked)} items exceed cfg.video_vocab_size="
            f"{cfg.video_vocab_size}; raise the vocab."
        )
    remap = {m: i for i, (m, _) in enumerate(ranked)}
    num_videos = len(ranked)

    category = np.zeros(num_videos, dtype=np.int32)
    tag = np.zeros(num_videos, dtype=np.int32)
    duration = np.zeros(num_videos, dtype=np.float32)
    popularity = np.zeros(num_videos, dtype=np.int64)
    for m, c in counts.items():
        i = remap[m]
        popularity[i] = c
        genres = movie_genres.get(m, ())
        if genres:
            category[i] = _GENRE_ID.get(genres[0], 0) % cfg.category_vocab_size
            tag[i] = hash("|".join(sorted(genres))) % cfg.tag_vocab_size

    user_sequences: List[Dict[str, np.ndarray]] = []
    for u in sorted(by_user):
        events = sorted(by_user[u])
        if len(events) < min_interactions:
            continue
        vids = np.array([remap[m] for _, m, _ in events], dtype=np.int32)
        ratings = np.array([r for _, _, r in events], dtype=np.float32)
        ts = np.array([t for t, _, _ in events], dtype=np.int64)
        user_sequences.append(
            {
                "video_id": vids,
                "category": category[vids],
                "tag": tag[vids],
                "duration": ratings * 60.0,
                "timestamp": ts,
            }
        )
        if max_users is not None and len(user_sequences) >= max_users:
            break

    video_features = {"category": category, "tag": tag, "duration": duration}
    return SyntheticRetrievalData(video_features, popularity, user_sequences)


def leave_one_out_split(
    data: SyntheticRetrievalData, min_train: int = 2
) -> Tuple[SyntheticRetrievalData, SyntheticRetrievalData]:
    """BERT4Rec evaluation protocol: per user, hold out the LAST interaction.

    Returns (train, test) where train drops each user's final event and test
    keeps the full sequence (so `retrieval_batches(test, ...,
    min_history=len-1)`-style consumers — and `RetrievalEvaluator` over the
    final prefix — score exactly the held-out item). Users shorter than
    ``min_train``+1 are excluded from test but kept whole in train."""
    train_seqs, test_seqs = [], []
    for seq in data.user_sequences:
        n = len(seq["video_id"])
        if n >= min_train + 1:
            train_seqs.append({k: v[: n - 1] for k, v in seq.items()})
            test_seqs.append(seq)
        else:
            train_seqs.append(seq)
    train = SyntheticRetrievalData(data.video_features, data.popularity, train_seqs)
    test = SyntheticRetrievalData(data.video_features, data.popularity, test_seqs)
    return train, test


# Taobao UserBehavior.csv behavior types → the ranking model's sequence slots
# (oneTrans feature groups: click_seq / cart_seq / purchase_seq).
_TAOBAO_SLOT = {"pv": "click_seq", "cart": "cart_seq", "fav": "cart_seq", "buy": "purchase_seq"}


def load_taobao_userbehavior(
    path: str,
    cfg: RankingConfig,
    max_seq_per_feature: int = 64,
    negatives_per_positive: int = 1,
    max_users: Optional[int] = None,
    max_samples_per_user: int = 8,
    seed: int = 0,
) -> SyntheticRankingData:
    """Parse Alibaba's UserBehavior.csv into ranking training samples.

    Format: ``user_id,item_id,category_id,behavior_type,timestamp`` with
    behavior ∈ {pv, buy, cart, fav}. Sample construction (standard CTR/CVR
    protocol):
      - each ``pv`` event with non-empty history becomes a POSITIVE sample:
        label ctr=1, cvr=1 iff the user later buys the same item;
      - ``negatives_per_positive`` random corpus items with the same user
        state become negatives (ctr=cvr=0);
      - behavior sequences are what the user did strictly BEFORE the event:
        pv → click_seq, cart+fav → cart_seq, buy → purchase_seq, truncated to
        the most recent ``max_seq_per_feature`` and left-padded.
    Feature mapping onto ``cfg``'s schema: user_id/item_id/category are
    re-indexed by frequency into their vocab sizes (mod-hashed if the file
    has more distinct values than the vocab); hour/weekday derive from the
    event timestamp; features the file lacks (gender, city, brand,
    price_bucket, device) stay 0.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — download UserBehavior.csv (Taobao) and pass "
            "its path (the loader downloads nothing)."
        )
    rng = np.random.default_rng(seed)

    by_user: Dict[int, List[Tuple[int, int, int, str]]] = {}
    item_counts: Dict[int, int] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(",")
            if len(parts) != 5:
                continue
            u, it, cat, beh, ts = parts
            if beh not in _TAOBAO_SLOT and beh != "pv":
                continue
            u, it, cat, ts = int(u), int(it), int(cat), int(ts)
            by_user.setdefault(u, []).append((ts, it, cat, beh))
            item_counts[it] = item_counts.get(it, 0) + 1
            if max_users is not None and len(by_user) > max_users:
                by_user.pop(u)
                break

    item_vocab = cfg.vocab_size("item_id")
    ranked = sorted(item_counts.items(), key=lambda kv: (-kv[1], kv[0]))
    item_remap = {it: i % item_vocab for i, (it, _) in enumerate(ranked)}
    num_items = min(len(ranked), item_vocab)
    cat_vocab = cfg.vocab_size("category")
    user_vocab = cfg.vocab_size("user_id")
    item_category = np.zeros(num_items, dtype=np.int64)

    samples_ns: Dict[str, List[int]] = {f: [] for f in cfg.non_seq_features}
    samples_seq: Dict[str, List[np.ndarray]] = {sf: [] for sf in cfg.sequence_features}
    samples_len: Dict[str, List[int]] = {sf: [] for sf in cfg.sequence_features}
    labels: Dict[str, List[float]] = {"ctr": [], "cvr": []}

    def left_pad(ids: List[int]) -> Tuple[np.ndarray, int]:
        ids = ids[-max_seq_per_feature:]
        out = np.zeros(max_seq_per_feature, dtype=np.int32)
        if ids:
            out[max_seq_per_feature - len(ids):] = ids
        return out, len(ids)

    def emit(uid, iid, icat, ts, hist, ctr, cvr):
        tm = int(ts)
        values = {
            "user_id": uid % user_vocab,
            "item_id": iid,
            "category": icat % cat_vocab,
            "hour": (tm // 3600) % 24,
            "weekday": (tm // 86400 + 4) % 7,  # epoch day 0 = Thursday
        }
        for fname in cfg.non_seq_features:
            samples_ns[fname].append(values.get(fname, 0))
        for sf in cfg.sequence_features:
            arr, n = left_pad(hist.get(sf, []))
            samples_seq[sf].append(arr)
            samples_len[sf].append(n)
        labels["ctr"].append(float(ctr))
        labels["cvr"].append(float(cvr))

    for u in sorted(by_user):
        events = sorted(by_user[u])
        bought = {item_remap[it] for _, it, _, b in events if b == "buy"}
        hist: Dict[str, List[int]] = {sf: [] for sf in cfg.sequence_features}
        emitted = 0
        for ts, it, cat, beh in events:
            iid = item_remap[it]
            if iid < num_items:
                item_category[iid] = cat % cat_vocab
            if beh == "pv" and any(hist.values()) and emitted < max_samples_per_user:
                emit(u, iid, cat, ts, hist, 1.0, 1.0 if iid in bought else 0.0)
                for _ in range(negatives_per_positive):
                    neg = int(rng.integers(0, num_items))
                    emit(u, neg, int(item_category[neg]), ts, hist, 0.0, 0.0)
                emitted += 1
            hist[_TAOBAO_SLOT[beh]].append(iid)

    n = len(labels["ctr"])
    if n == 0:
        raise ValueError("no training samples parsed — is the file empty?")
    non_seq = {f: np.asarray(v, dtype=np.int32) for f, v in samples_ns.items()}
    sequences = {sf: np.stack(v) for sf, v in samples_seq.items()}
    seq_lengths = {sf: np.asarray(v, dtype=np.int32) for sf, v in samples_len.items()}
    out_labels = {t: np.asarray(labels.get(t, [0.0] * n), dtype=np.float32)
                  for t in cfg.tasks}
    return SyntheticRankingData(non_seq, sequences, seq_lengths, out_labels)


# ---------------------------------------------------------------------------
# Criteo (Kaggle Display Advertising Challenge) — the "Criteo-seq sample"
# ranking config of BASELINE.json. Criteo has no behavior sequences, so it
# exercises the NS-only degenerate stream: the unified tokenizer emits just
# the num_ns_tokens tokens (S length 0), which is exactly the paper's
# non-sequential DCNv2-class setting (oneTrans translation:199 baselines).
# ---------------------------------------------------------------------------

CRITEO_NUM_INT = 13
CRITEO_NUM_CAT = 26


def criteo_ranking_config(
    cat_vocab: int = 65_536,
    num_buckets: int = 64,
    **overrides,
) -> RankingConfig:
    """RankingConfig over Criteo's schema: 13 log-bucketized integer features
    + 26 hashed categorical features, single `ctr` task, no sequences."""
    int_feats = tuple(f"i{k}" for k in range(1, CRITEO_NUM_INT + 1))
    cat_feats = tuple(f"c{k}" for k in range(1, CRITEO_NUM_CAT + 1))
    vocab = tuple((f, num_buckets) for f in int_feats) + tuple(
        (f, cat_vocab) for f in cat_feats
    )
    defaults = dict(
        user_features=(),
        item_features=int_feats,
        context_features=cat_feats,
        sequence_features=(),
        feature_vocab_sizes=vocab,
        tasks=("ctr",),
        feature_embed_dim=32,
    )
    defaults.update(overrides)
    return RankingConfig(**defaults)


def load_criteo_kaggle(
    path: str,
    cat_vocab: int = 65_536,
    num_buckets: int = 64,
    max_samples: Optional[int] = None,
) -> SyntheticRankingData:
    """Parse the Criteo Kaggle TSV (``label \\t I1..I13 \\t C1..C26``; empty
    fields allowed) into NS-only ranking samples.

    Feature mapping (the standard recipe): integers x → bucket
    ``int(log2(x+1)) + 2`` (0 = missing, 1 = negative values), clipped to
    ``num_buckets``; categorical hex tokens → ``1 + int(tok, 16) % (vocab-1)``
    (0 = missing). Labels: ``ctr`` ∈ {0, 1}. Pair with
    ``criteo_ranking_config(cat_vocab, num_buckets)``.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — download the Criteo Kaggle train.txt and "
            "pass its path (the loader downloads nothing)."
        )
    labels: List[float] = []
    ints: List[List[int]] = []
    cats: List[List[int]] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 1 + CRITEO_NUM_INT + CRITEO_NUM_CAT:
                continue
            labels.append(float(parts[0]))
            row_i = []
            for tok in parts[1 : 1 + CRITEO_NUM_INT]:
                if not tok:
                    row_i.append(0)
                else:
                    x = int(tok)
                    b = 1 if x < 0 else min(
                        int(np.log2(x + 1)) + 2, num_buckets - 1
                    )
                    row_i.append(b)
            ints.append(row_i)
            cats.append(
                [
                    0 if not tok else 1 + int(tok, 16) % (cat_vocab - 1)
                    for tok in parts[1 + CRITEO_NUM_INT :]
                ]
            )
            if max_samples is not None and len(labels) >= max_samples:
                break
    ia = np.asarray(ints, np.int32)
    ca = np.asarray(cats, np.int32)
    non_seq = {f"i{k}": ia[:, k - 1] for k in range(1, CRITEO_NUM_INT + 1)}
    non_seq.update(
        {f"c{k}": ca[:, k - 1] for k in range(1, CRITEO_NUM_CAT + 1)}
    )
    return SyntheticRankingData(
        non_seq=non_seq,
        sequences={},
        seq_lengths={},
        labels={"ctr": np.asarray(labels, np.float32)},
    )
