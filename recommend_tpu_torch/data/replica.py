"""Statistical-replica dataset generators — the quality-parity fixtures: a
copy of the JAX package's ``data/replica.py`` (numpy only; the same seed
gives the same arrays bit for bit, the draws being the same, in the same
order).

BASELINE.json's parity bar is "rank AUC + recall@k parity" on open/industrial
dataset configs (MovieLens-1M retrieval; the OneTrans industrial ranking
setting, translation/complete_translation.md:168-207). No dataset file is
shipped with the repository, so these generators reproduce
the *published statistics* of those datasets at full scale — honest replicas,
not the datasets themselves; every quality number measured on them is labeled
as replica-measured and the synthetic-vs-real gap is stated in BASELINE.md.

Design goals:
  - marginals match the published dataset statistics (user/item counts,
    interaction totals, heavy-tailed popularity and activity);
  - the label/interaction process carries CONTROLLABLE, LEARNABLE signal with
    an explicitly sequence-dependent component (drifting user interests), so
    sequence models measurably beat sequence-agnostic baselines — the same
    axis the OneTrans paper's Table 2 measures (translation:199-207);
  - pure numpy + explicit seeds: one reproducible script regenerates
    everything bit-for-bit.

ML-1M replica statistics targeted (dataset README / standard BERT4Rec
protocol): 6,040 users, 3,706 items, ~1.0M ratings, per-user length in
[20, 2314] with mean ≈165, heavy-tailed item popularity, 18 genres,
leave-one-out evaluation.

OneTrans industrial replica (translation:168-175: 29.1B impressions, 27.9M
users, 10.2M items — scaled down ~1000× by default, stated in the report):
Zipf item popularity, lognormal user activity, 3 behavior sequences
(click ⊃ cart ⊃ purchase), CTR ≈ 18% label base rate (alpha = −3.6 in
``signal_weights`` plus the positive affinity/match terms; measured 17.7%
at the full-scale defaults — pinned by tests/test_replica.py) with CVR
conditional on click, labels driven by user×item latent affinity + a
recency-weighted history-match term + feature effects + irreducible noise.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from recommend_tpu_torch.config import RankingConfig, RetrievalConfig
from recommend_tpu_torch.data.synthetic import SyntheticRankingData, SyntheticRetrievalData

# ---------------------------------------------------------------------------
# MovieLens-1M replica (retrieval)
# ---------------------------------------------------------------------------

ML1M_USERS = 6040
ML1M_ITEMS = 3706
ML1M_GENRES = 18


def make_ml1m_replica(
    cfg: RetrievalConfig,
    num_users: int = ML1M_USERS,
    num_items: int = ML1M_ITEMS,
    seed: int = 0,
    stay_prob: float = 0.55,
    explore_prob: float = 0.10,
    prefs_per_user: int = 3,
) -> SyntheticRetrievalData:
    """Full-scale ML-1M statistical replica.

    Marginals: per-user sequence lengths ~ lognormal(4.56, 1.04) clipped to
    the dataset's [20, 2314] (mean ≈165 ⇒ ≈1.0M events total); item base
    attractiveness ~ Zipf(0.85) inside 18 Zipf-sized genres; items re-indexed
    by emergent popularity (id 0 = most watched — the datasets.py loader
    convention).

    Learnable structure: each user holds a sparse Dirichlet preference over
    ``prefs_per_user`` genres and walks a genre-level Markov chain
    (``stay_prob`` self-transition, ``explore_prob`` uniform exploration),
    drawing items within the genre by attractiveness. Sequential models gain
    over popularity via (a) the preference mixture readable from history and
    (b) the genre autocorrelation readable from the most recent items.
    """
    rng = np.random.default_rng(seed)
    num_items = min(num_items, cfg.video_vocab_size)

    # genres: Zipf-distributed sizes over the fixed 18-genre vocabulary
    n_genres = min(ML1M_GENRES, cfg.category_vocab_size - 1)
    genre_w = 1.0 / np.arange(1, n_genres + 1) ** 0.8
    genre_w /= genre_w.sum()
    category = rng.choice(n_genres, size=num_items, p=genre_w).astype(np.int32) + 1

    # base attractiveness: Zipf over a random within-genre order
    attract = 1.0 / np.arange(1, num_items + 1) ** 0.85
    attract = attract[rng.permutation(num_items)]

    # per-genre pools + normalized within-genre attractiveness. At small
    # num_items the Zipf assignment can leave a genre with zero items —
    # fall back to the global pool (0/0 probabilities would NaN-crash the
    # Markov walk's exploration draws)
    global_pool = (np.arange(num_items), attract / attract.sum())
    pools = []
    for g in range(1, n_genres + 1):
        idx = np.nonzero(category == g)[0]
        if idx.size == 0:
            pools.append(global_pool)
            continue
        a = attract[idx]
        pools.append((idx, a / a.sum()))

    # per-user lengths: lognormal calibrated to ML-1M (median≈96, mean≈165)
    lengths = np.exp(rng.normal(4.56, 1.04, num_users))
    lengths = np.clip(lengths, 20, 2314).astype(np.int64)

    # per-user preferred genres + Dirichlet weights
    user_sequences = []
    base_ts = 957_000_000  # ML-1M spans 2000-04 .. 2003-02
    ts_span = 90_000_000
    counts = np.zeros(num_items, dtype=np.int64)
    raw_ids = []
    for u in range(num_users):
        n = int(lengths[u])
        prefs = rng.choice(n_genres, size=prefs_per_user, replace=False)
        pw = rng.dirichlet(np.full(prefs_per_user, 0.8))
        # genre-level Markov walk (vectorized: pre-draw the branch per step)
        branch = rng.random(n)
        pref_draws = rng.choice(prefs, size=n, p=pw)
        expl_draws = rng.integers(0, n_genres, size=n)
        genres = np.empty(n, dtype=np.int64)
        g = int(pref_draws[0])
        for i in range(n):
            if branch[i] >= stay_prob or i == 0:
                if branch[i] >= 1.0 - explore_prob:
                    g = int(expl_draws[i])
                else:
                    g = int(pref_draws[i])
            genres[i] = g
        # items within each genre, drawn by attractiveness (vectorized per genre)
        vids = np.empty(n, dtype=np.int64)
        for g in np.unique(genres):
            at = np.nonzero(genres == g)[0]
            idx, pa = pools[g]
            vids[at] = rng.choice(idx, size=len(at), p=pa)
        np.add.at(counts, vids, 1)
        raw_ids.append(vids)

    # re-index by emergent popularity (id 0 = most watched)
    order = np.argsort(-counts, kind="stable")
    remap = np.empty(num_items, dtype=np.int64)
    remap[order] = np.arange(num_items)

    category_r = np.empty_like(category)
    category_r[remap] = category
    attract_r = np.empty_like(attract)
    attract_r[remap] = attract
    tag = (
        category_r.astype(np.int64) * 7919 + np.arange(num_items) % 97
    ) % cfg.tag_vocab_size
    # duration slot: mean "rating" proxy per item (loader maps rating×60 s)
    item_rating = np.clip(rng.normal(3.6, 0.5, num_items), 1.0, 5.0)
    duration = (item_rating * 60.0).astype(np.float32)
    video_features = {
        "category": category_r.astype(np.int32),
        "tag": tag.astype(np.int32),
        "duration": duration,
    }
    popularity = np.maximum(counts[order], 1).astype(np.float32)

    for u in range(num_users):
        vids = remap[raw_ids[u]].astype(np.int32)
        n = len(vids)
        ts = base_ts + np.sort(rng.integers(0, ts_span, n)).astype(np.int64)
        per_event_rating = np.clip(
            item_rating[vids] + rng.normal(0, 0.7, n), 1.0, 5.0
        )
        user_sequences.append(
            {
                "video_id": vids,
                "category": video_features["category"][vids],
                "tag": video_features["tag"][vids],
                "duration": (per_event_rating * 60.0).astype(np.float32),
                "timestamp": ts,
            }
        )
    return SyntheticRetrievalData(video_features, popularity, user_sequences)


def leave_one_out_batches(
    test_data: SyntheticRetrievalData,
    cfg: RetrievalConfig,
    batch_size: int,
) -> Iterator[Dict[str, np.ndarray]]:
    """Exactly ONE evaluation sample per user: history = all events but the
    last, target = the last event (BERT4Rec leave-one-out protocol; pairs
    with `datasets.leave_one_out_split`). The final partial batch is padded
    by repeating the last user and must be truncated by the caller — or use
    a batch_size dividing the user count."""
    from recommend_tpu_torch.data.pipeline import FEATURE_KEYS, _pad_history

    users = [u for u, s in enumerate(test_data.user_sequences)
             if len(s["video_id"]) >= 2]
    for i in range(0, len(users), batch_size):
        chunk = users[i : i + batch_size]
        pad = batch_size - len(chunk)
        chunk = chunk + [chunk[-1]] * pad
        hist = {
            k: np.zeros((batch_size, cfg.max_seq_len),
                        dtype=np.float32 if k == "duration" else np.int64)
            for k in FEATURE_KEYS
        }
        valid = np.zeros((batch_size, cfg.max_seq_len), dtype=bool)
        tgt = {
            k: np.zeros(batch_size,
                        dtype=np.float32 if k == "duration" else np.int64)
            for k in FEATURE_KEYS
        }
        for b, u in enumerate(chunk):
            seq = test_data.user_sequences[u]
            n = len(seq["video_id"])
            h, v = _pad_history(seq, n - 1, cfg.max_seq_len)
            for k in FEATURE_KEYS:
                hist[k][b] = h[k]
                tgt[k][b] = seq[k][n - 1]
            valid[b] = v
        yield {
            "history": hist,
            "history_valid": valid,
            "target": tgt,
            "num_real": batch_size - pad,
        }


# ---------------------------------------------------------------------------
# OneTrans industrial replica (ranking)
# ---------------------------------------------------------------------------


def make_onetrans_replica(
    cfg: RankingConfig,
    num_users: int = 25_000,
    num_items: int = 100_000,
    num_impressions: int = 1_000_000,
    click_len: int = 48,
    cart_len: int = 16,
    purchase_len: int = 8,
    latent_dim: int = 16,
    noise_sigma: float = 0.6,
    eval_frac: float = 0.1,
    val_frac: float = 0.0,
    seed: int = 0,
    signal_weights: Tuple[float, float, float, float, float] = (
        4.5, 5.5, -0.8, 0.5, -3.6
    ),
    signal_weights_v2: Tuple[float, float] = (0.0, 0.0),
    order_k_recent: int = 8,
    order_k_early: int = 16,
    cross_decay: float = 0.75,
    affinity_sharpness: float = 8.0,
    stream_len_loc: float = 4.0,
    stream_len_scale: float = 0.7,
    debug_out: Optional[dict] = None,
) -> Tuple[SyntheticRankingData, ...]:
    """Scaled-down replica of the OneTrans industrial setting
    (translation:168-175: 29.1B impressions / 27.9M users / 10.2M items —
    defaults here are ≈1000× smaller; state the scale in any report).

    Generative process:
      - items: latent = category centroid + noise (categories are clusters);
        popularity ~ Zipf(0.9); brand/price derived from latent+category.
      - users: TWO interest vectors (a, b); the active interest drifts
        a→b across the user's click stream — so the RECENT history predicts
        the current interest strictly better than any static user embedding.
        This is the sequence-specific signal (OneTrans Table 2's axis).
      - click stream per user: items drawn ∝ softmax-ish mixture of current
        interest affinity and popularity; cart/purchase are thinned subsets
        (≈12% / ≈30% of cart).
      - impressions: at a random stream position t (≥5 clicks of history);
        candidate is user-affine (50%) or popularity-exposed (50%);
        history sequences = stream before t (no leakage of the candidate).
      - labels: ctr_logit = α + w_a·affinity(u(t), v) + w_m·match(recent
        clicks, v) + price/hour effects + N(0, noise_sigma) — the affinity/
        match terms are net-positive, so the realized CTR base rate is ≈18%
        (not sigmoid(α)); cvr given click uses the same structure with
        different weights (realized CVR|click ≈ 36%, ≈6% of impressions).

    Split: the LAST ``eval_frac`` of every user's impressions (stream order)
    form the eval set — train on the past, evaluate on the future. With
    ``val_frac`` > 0 the slice just BEFORE the eval tail becomes a held-out
    validation split (time-ordered: train < val < eval) — the
    checkpoint-selection split of the quality protocol, disjoint
    from the reported test set.

    Replica v2 (``signal_weights_v2`` = (w_order, w_cross) ≠ 0) plants the
    two signal axes the OneTrans paper's Table 3 attributes to the
    transformer (translation:218-227) — signal a per-sequence
    attention-pooled baseline (DIN-class: no positional information, each
    sequence pooled independently) cannot fully extract:
      - ORDER: w_order · (candidate · drift), drift = normalized
        (mean latent of the last ``order_k_recent`` clicks − mean latent of
        the ``order_k_early`` clicks before them) — the *direction* the
        user's interest is moving. Reading it requires distinguishing
        recent from early positions inside the click window; an
        order-blind pooling sees only the undifferentiated mixture.
      - CROSS-BEHAVIOR recency gate: w_cross · Σ_j decay^age_j ·
        (cart_item_j · candidate) / Σ_j decay^age_j over the cart window
        (age = cart-sequence steps from the most recent event). Candidate
        affinity to *recently* carted items — extracting it requires
        position-aware weighting WITHIN the cart sequence joined against
        the candidate; a positionless candidate-keyed pool weights all
        cart events alike.
    Both terms are functions of the OBSERVED history, so they flow into
    the observable oracle ceiling as well.

    Returns (train, eval) — or (train, val, eval) when ``val_frac`` > 0.
    """
    rng = np.random.default_rng(seed)
    n_cat = cfg.vocab_size("category")
    n_brand = cfg.vocab_size("brand")
    n_price = cfg.vocab_size("price_bucket")
    # item ids are stored +1 (0 = padding id) so the table needs
    # num_items + 1 rows — equality would make the last item's lookups read
    # out of range (silent garbage/NaN on some backends)
    assert num_items < cfg.vocab_size("item_id"), "raise item_id vocab (+1 for padding)"
    assert num_users <= cfg.vocab_size("user_id"), "raise user_id vocab"

    # ---- items ----------------------------------------------------------
    cat_centroids = rng.normal(0, 1.0, (n_cat, latent_dim))
    item_cat = rng.integers(1, n_cat, num_items)  # 0 reserved for padding
    v_lat = cat_centroids[item_cat] + rng.normal(0, 0.5, (num_items, latent_dim))
    v_lat /= np.linalg.norm(v_lat, axis=1, keepdims=True)
    item_brand = (
        (item_cat * 131 + rng.integers(0, 7, num_items)) % (n_brand - 1) + 1
    )
    # price correlates with a latent direction (so it is informative)
    price_score = v_lat @ rng.normal(0, 1.0, latent_dim)
    item_price = np.clip(
        ((price_score - price_score.min())
         / (np.ptp(price_score) + 1e-9) * (n_price - 1)).astype(np.int64),
        0, n_price - 1,
    )
    item_pop = 1.0 / np.arange(1, num_items + 1) ** 0.9
    item_pop = item_pop[rng.permutation(num_items)]
    item_pop /= item_pop.sum()

    # ---- users ----------------------------------------------------------
    u_a = rng.normal(0, 1.0, (num_users, latent_dim))
    u_b = rng.normal(0, 1.0, (num_users, latent_dim))
    u_a /= np.linalg.norm(u_a, axis=1, keepdims=True)
    u_b /= np.linalg.norm(u_b, axis=1, keepdims=True)
    stream_len = np.clip(
        np.exp(rng.normal(stream_len_loc, stream_len_scale, num_users)), 12, 2000
    ).astype(np.int64)
    # impressions allocated ∝ activity
    w = stream_len / stream_len.sum()
    imps_per_user = np.maximum(
        rng.multinomial(num_impressions, w), 2
    )

    # user NS features (weakly informative demographics)
    n_age = cfg.vocab_size("age_bucket")
    user_age = np.clip(
        ((u_a[:, 0] + 2) / 4 * (n_age - 1)).astype(np.int64), 0, n_age - 1
    )
    user_gender = (u_a[:, 1] > 0).astype(np.int64) + 1
    user_city = rng.integers(0, cfg.vocab_size("city"), num_users)

    # ---- generate per-user streams + impressions ------------------------
    total = int(imps_per_user.sum())
    ns_cols = {
        f: np.zeros(total, dtype=np.int32) for f in cfg.non_seq_features
    }
    seq_cols = {
        "click_seq": np.zeros((total, click_len), np.int32),
        "cart_seq": np.zeros((total, cart_len), np.int32),
        "purchase_seq": np.zeros((total, purchase_len), np.int32),
    }
    len_cols = {
        "click_seq": np.zeros(total, np.int32),
        "cart_seq": np.zeros(total, np.int32),
        "purchase_seq": np.zeros(total, np.int32),
    }
    y_ctr = np.zeros(total, np.float32)
    y_cvr = np.zeros(total, np.float32)
    is_eval = np.zeros(total, bool)
    is_val = np.zeros(total, bool)
    dbg = debug_out is not None
    dbg_logit = np.zeros(total, np.float32) if dbg else None
    dbg_obs = np.zeros(total, np.float32) if dbg else None
    dbg_cvr = np.zeros(total, np.float32) if dbg else None
    dbg_cvr_obs = np.zeros(total, np.float32) if dbg else None
    # per-term decomposition (signal-calibration tooling): each structural
    # term alone, so its single-term AUC — the bootstrap signal a model can
    # reach through that term — is measurable per weighting
    dbg_terms = (
        {k: np.zeros(total, np.float32)
         for k in ("match", "obs_affinity", "order", "cross")} if dbg else None
    )

    # logit weights: calibrated so the Bayes ceiling (AUC of the noise-free
    # structural logit against the sampled labels) sits at ≈0.82 — just above
    # the reference's measured industrial CTR AUC band (0.796 baseline →
    # 0.808 OneTrans-L, translation:199-207), leaving models room to
    # approach-but-not-exceed the published scale
    w_aff, w_match, w_price, w_hour, alpha = signal_weights
    cvr_w_aff, cvr_w_match, cvr_alpha = 0.7 * w_aff, 0.65 * w_match, -2.8
    w_order, w_cross = signal_weights_v2
    # cart intent is strongly conversion-predictive; drift direction less so
    cvr_w_order, cvr_w_cross = 0.5 * w_order, 0.9 * w_cross
    match_k = 8  # recent clicks feeding the match term
    _sig = lambda x: 1.0 / (1.0 + np.exp(-x))

    row = 0
    for u in range(num_users):
        n = int(stream_len[u])
        t_frac = np.arange(n) / max(n - 1, 1)
        u_t = (1 - t_frac)[:, None] * u_a[u] + t_frac[:, None] * u_b[u]
        u_t /= np.linalg.norm(u_t, axis=1, keepdims=True)
        # click stream: top-pool sampling — mix popularity with affinity by
        # sampling a candidate pool from popularity then picking by affinity
        pool = rng.choice(num_items, size=(n, 12), p=item_pop)
        aff = np.einsum("nd,npd->np", u_t, v_lat[pool])
        gumbel = rng.gumbel(0, 1.0, aff.shape)
        stream = pool[np.arange(n), np.argmax(affinity_sharpness * aff + gumbel, axis=1)]
        in_cart = rng.random(n) < 0.12
        in_purch = in_cart & (rng.random(n) < 0.30)

        m = int(imps_per_user[u])
        pos = np.sort(rng.integers(5, n, m))
        n_eval = max(int(round(m * eval_frac)), 1)
        # candidate: 50% affine to current interest, 50% popularity exposure
        cand_pool = rng.choice(num_items, size=(m, 12), p=item_pop)
        cand_aff = np.einsum("md,mpd->mp", u_t[pos], v_lat[cand_pool])
        g2 = rng.gumbel(0, 1.0, cand_aff.shape)
        affine_pick = cand_pool[np.arange(m), np.argmax(affinity_sharpness * cand_aff + g2, axis=1)]
        expose_pick = cand_pool[:, 0]
        cand = np.where(rng.random(m) < 0.5, affine_pick, expose_pick)

        # history windows (sliding views over the zero-padded stream; ids are
        # stored +1 so 0 stays the padding id)
        stream1 = stream + 1
        for name, length, member in (
            ("click_seq", click_len, None),
            ("cart_seq", cart_len, in_cart),
            ("purchase_seq", purchase_len, in_purch),
        ):
            if member is None:
                sub, subpos = stream1, pos
            else:
                keep = np.nonzero(member)[0]
                sub = stream1[keep]
                # events strictly before each impression position
                subpos = np.searchsorted(keep, pos)
            padded = np.concatenate([np.zeros(length, np.int64), sub])
            windows = np.lib.stride_tricks.sliding_window_view(padded, length)
            seq_cols[name][row : row + m] = windows[subpos]
            len_cols[name][row : row + m] = np.minimum(subpos, length)

        # labels
        recent = np.concatenate(
            [np.zeros(match_k, np.int64), stream]
        )  # index pad with item 0 (contributes mean latent; masked by weight below)
        rec_windows = np.lib.stride_tricks.sliding_window_view(recent, match_k)
        rec_items = rec_windows[pos]  # [m, match_k] item ids (last k clicks)
        rec_valid = (np.arange(match_k)[None, :]
                     >= np.maximum(match_k - pos[:, None], 0))
        rec_lat = v_lat[rec_items] * rec_valid[..., None]
        denom = np.maximum(rec_valid.sum(1, keepdims=True), 1)
        match = np.einsum("md,md->m", rec_lat.sum(1) / denom, v_lat[cand])
        affinity = np.einsum("md,md->m", u_t[pos], v_lat[cand])

        # --- v2 ORDER term: interest-drift direction over the click window
        # (recent mean − early mean, normalized) · candidate. Zero until the
        # user has a full early+recent window. No rng draws: v1 streams stay
        # bit-identical when the v2 weights are 0.
        if w_order:
            kk = order_k_recent + order_k_early
            pad_lat = np.concatenate([np.zeros((kk, latent_dim)), v_lat[stream]])
            owin = np.lib.stride_tricks.sliding_window_view(
                pad_lat, kk, axis=0
            )[pos]  # [m, latent_dim, kk]; slot k = click (pos − kk + k)
            drift = (owin[..., order_k_early:].mean(-1)
                     - owin[..., :order_k_early].mean(-1))
            drift /= np.linalg.norm(drift, axis=1, keepdims=True) + 1e-9
            order_t = np.einsum("md,md->m", drift, v_lat[cand]) * (pos >= kk)
        else:
            order_t = 0.0
        # --- v2 CROSS-BEHAVIOR term: recency-decayed candidate affinity to
        # the cart window (exactly the window the model's cart_seq shows)
        if w_cross:
            keep_c = np.nonzero(in_cart)[0]
            cart_lat = v_lat[stream[keep_c]]
            pad_c = np.concatenate([np.zeros((cart_len, latent_dim)), cart_lat])
            csub = np.searchsorted(keep_c, pos)  # cart events strictly before t
            cwin = np.lib.stride_tricks.sliding_window_view(
                pad_c, cart_len, axis=0
            )[csub]  # [m, latent_dim, cart_len]; last slot = most recent
            n_c = np.minimum(csub, cart_len)
            ages = np.arange(cart_len - 1, -1, -1, dtype=np.float64)
            wv = (cross_decay ** ages)[None, :] * (
                np.arange(cart_len)[None, :] >= (cart_len - n_c[:, None])
            )
            sims = np.einsum("mdk,md->mk", cwin, v_lat[cand])
            cross_t = (sims * wv).sum(1) / np.maximum(wv.sum(1), 1e-9)
        else:
            cross_t = 0.0

        hour = rng.integers(0, cfg.vocab_size("hour"), m)
        price_n = item_price[cand] / (n_price - 1) - 0.5
        hour_n = hour / (cfg.vocab_size("hour") - 1) - 0.5
        struct = (
            alpha + w_aff * affinity + w_match * match
            + w_order * order_t + w_cross * cross_t
            + w_price * price_n + w_hour * hour_n
        )
        logit = struct + rng.normal(0, noise_sigma, m)
        ctr = (rng.random(m) < _sig(logit)).astype(np.float32)
        cvr_struct = (
            cvr_alpha + cvr_w_aff * affinity + cvr_w_match * match
            + cvr_w_order * order_t + cvr_w_cross * cross_t
        )
        cvr_logit = cvr_struct + rng.normal(0, noise_sigma, m)
        cvr = ctr * (rng.random(m) < _sig(cvr_logit))

        sl = slice(row, row + m)
        ns_cols["user_id"][sl] = u
        ns_cols["age_bucket"][sl] = user_age[u]
        ns_cols["gender"][sl] = user_gender[u]
        ns_cols["city"][sl] = user_city[u]
        ns_cols["item_id"][sl] = cand + 1  # 0 = padding id
        ns_cols["category"][sl] = item_cat[cand]
        ns_cols["brand"][sl] = item_brand[cand]
        ns_cols["price_bucket"][sl] = item_price[cand]
        ns_cols["hour"][sl] = hour
        ns_cols["weekday"][sl] = rng.integers(0, cfg.vocab_size("weekday"), m)
        ns_cols["device"][sl] = rng.integers(0, cfg.vocab_size("device"), m)
        y_ctr[sl] = ctr
        y_cvr[sl] = cvr.astype(np.float32)
        if dbg:
            # noise-free structural logit — its AUC against the sampled
            # labels is the LATENT Bayes ceiling (uses the true user latent,
            # which no model observes). The v2 order/cross terms are part of
            # the structure, so they appear here too.
            dbg_logit[sl] = struct
            # observable oracle: the same logit with u(t) replaced by the
            # mean latent of the clicks so far — the best estimate of the
            # drifting interest recoverable from the OBSERVED history. Its
            # AUC is the ceiling for any model that sees only ids/features.
            # The match/order/cross terms are history-derived and carry over
            # unchanged (they are already observable).
            cums = np.cumsum(v_lat[stream], axis=0)
            hist_mean = cums[pos - 1] / pos[:, None]
            hist_mean /= np.linalg.norm(hist_mean, axis=1, keepdims=True) + 1e-9
            obs_aff = np.einsum("md,md->m", hist_mean, v_lat[cand])
            obs_struct = (
                alpha + w_aff * obs_aff + w_match * match
                + w_order * order_t + w_cross * cross_t
                + w_price * price_n + w_hour * hour_n
            )
            dbg_obs[sl] = obs_struct
            dbg_terms["match"][sl] = match
            dbg_terms["obs_affinity"][sl] = obs_aff
            dbg_terms["order"][sl] = order_t if w_order else 0.0
            dbg_terms["cross"][sl] = cross_t if w_cross else 0.0
            # CVR oracles: the Bayes-optimal score
            # for the UNCONDITIONAL cvr label (positive only when clicked
            # AND converted) is P(click)·P(convert|click)
            dbg_cvr[sl] = _sig(struct) * _sig(cvr_struct)
            cvr_obs_struct = (
                cvr_alpha + cvr_w_aff * obs_aff + cvr_w_match * match
                + cvr_w_order * order_t + cvr_w_cross * cross_t
            )
            dbg_cvr_obs[sl] = _sig(obs_struct) * _sig(cvr_obs_struct)
        is_eval[row + m - n_eval : row + m] = True
        if val_frac > 0:
            n_val = min(int(round(m * val_frac)), m - n_eval)
            is_val[row + m - n_eval - n_val : row + m - n_eval] = True
        row += m

    labels = {}
    for t in cfg.tasks:
        labels[t] = {"ctr": y_ctr, "cvr": y_cvr}.get(
            t, (rng.random(total) < 0.5).astype(np.float32)
        )
    if debug_out is not None:
        debug_out["bayes_logit"] = dbg_logit
        debug_out["observable_logit"] = dbg_obs
        debug_out["bayes_cvr_score"] = dbg_cvr
        debug_out["observable_cvr_score"] = dbg_cvr_obs
        debug_out["is_eval"] = is_eval
        debug_out["is_val"] = is_val
        debug_out["y_ctr"] = y_ctr
        debug_out["y_cvr"] = y_cvr
        debug_out["terms"] = dbg_terms

    def subset(mask: np.ndarray) -> SyntheticRankingData:
        return SyntheticRankingData(
            non_seq={f: a[mask] for f, a in ns_cols.items()},
            sequences={k: a[mask] for k, a in seq_cols.items()},
            seq_lengths={k: a[mask] for k, a in len_cols.items()},
            labels={t: a[mask] for t, a in labels.items()},
        )

    if val_frac > 0:
        return subset(~is_eval & ~is_val), subset(is_val), subset(is_eval)
    return subset(~is_eval), subset(is_eval)
