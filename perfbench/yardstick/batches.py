"""Training batches drawn on the device from the run's seed, in the layout
``RankingTrainer._train_step`` takes (``_put_batch``'s): ``non_seq``
feature -> [B] int64 ids, ``sequences`` -> [B, L] int64 ids, ``seq_valid``
-> [B, L] bool, ``labels`` task -> [B] float32.

The traffic file sets the shapes (``batch_size``, ``seq_len``,
``placed_batches``) and the ids' skew (``id_zipf``). Every behaviour
sequence is full: ``seq_len`` items, none of them padding. Every id is a
Zipf(``id_zipf``) rank over its vocabulary, spread over the id space as a
hashed id space would (rank r -> (r - 1) * 2654435761 mod vocabulary), so
that popular ids repeat within a batch. The labels: a CTR label from a
logistic model of four features plus N(0, 0.5) noise, CVR = CTR times a
Bernoulli(0.2). Every batch of a run is drawn in one call per field, so its
rows all differ; every seed gives the same shapes and the same popularity,
and only which ids and labels are drawn changes.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch

from perfbench.yardstick.model_shapes import non_seq_features, vocab
from perfbench.yardstick.weights import derived_seed

# the CTR model's feature weights (of each id's position in its vocabulary)
CTR_WEIGHTS = {"price_bucket": -2.0, "hour": 1.5, "category": 1.0, "age_bucket": 1.0}
HASH = 2654435761  # Knuth's multiplicative hash: rank -> id


def zipf_ids(size, n_ids: int, exponent: float, gen: torch.Generator, device) -> torch.Tensor:
    """int64 ids of ``size``: ranks drawn with P(r) ∝ r^-exponent over
    1..``n_ids`` (by the inverse of the cumulative distribution), hashed."""
    ranks = torch.arange(1, n_ids + 1, device=device, dtype=torch.float64)
    cdf = torch.cumsum(ranks.pow(-exponent), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(size, generator=gen, device=device, dtype=torch.float64)
    r = torch.searchsorted(cdf, u).clamp_(max=n_ids - 1)
    return r * HASH % n_ids


@torch.no_grad()
def make_batches(cfg: Mapping, traffic: Mapping, seed: int, device
                 ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """The traffic's ``placed_batches`` batches of ``batch_size`` rows."""
    batch_size, seq_len, count = (traffic["batch_size"], traffic["seq_len"],
                                  traffic["placed_batches"])
    skew = traffic["id_zipf"]
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, 2))
    rows = batch_size * count
    non_seq = {f: zipf_ids((rows,), vocab(cfg, f), skew, gen, device)
               for f in non_seq_features(cfg)}
    sequences, seq_valid = {}, {}
    item_vocab = vocab(cfg, "item_id") if cfg["sequence_features"] else 0
    for sf in cfg["sequence_features"]:
        sequences[sf] = zipf_ids((rows, seq_len), item_vocab, skew, gen, device)
        seq_valid[sf] = torch.ones((rows, seq_len), dtype=torch.bool, device=device)
    logit = torch.full((rows,), -1.0, dtype=torch.float64, device=device)
    for f, w in CTR_WEIGHTS.items():
        if f in non_seq:
            logit += w * (non_seq[f].double() / vocab(cfg, f) - 0.5)
    logit += 0.5 * torch.randn(rows, generator=gen, device=device, dtype=torch.float64)
    u = torch.rand((2, rows), generator=gen, device=device, dtype=torch.float64)
    ctr = (u[0] < torch.sigmoid(logit)).float()
    labels = {}
    for t in cfg["tasks"]:
        labels[t] = ctr if t == "ctr" else ctr * (u[1] < 0.2).float()

    def part(x, i):
        return x[i * batch_size:(i + 1) * batch_size].contiguous()

    return [{"non_seq": {k: part(v, i) for k, v in non_seq.items()},
             "sequences": {k: part(v, i) for k, v in sequences.items()},
             "seq_valid": {k: part(v, i) for k, v in seq_valid.items()},
             "labels": {k: part(v, i) for k, v in labels.items()}}
            for i in range(count)]
