"""The KuaiFormer cell's weights and batches, drawn on the device from the
run's seed.

Weights: as ``weights.py`` draws the ranking model's, in a few large calls
(one N(0, 0.02) draw for the tables and the query and [MASK] tokens, one
truncated-normal draw for every kernel, scaled once per fan-in), float32,
under the names of ``retrieval_shapes.param_specs``; ``tables_only``
redraws the normal ones alone.

Batches: in the layout ``RetrievalTrainer._put_batch`` makes (``history``
and ``target`` feature -> [B, L] / [B]: the id features and ``timestamp``
int64, ``duration`` float32; ``history_valid`` [B, L] bool;
``history_popularity`` [B, L] and ``target_popularity`` [B] float32). Every
history is full: ``max_seq_len`` items, none of them padding, and the
target is the item after the last. Each id is a Zipf(``id_zipf``) rank
over its feature's vocabulary, hashed over the id space (``batches.py``'s
rule), drawn independently for every item and feature; a video's
popularity, the sampling probability LogQ corrects for, is its rank's
Zipf probability. Durations are uniform in [0, ``max_duration_s``) seconds
and timestamps uniform over the time buckets. Every batch of a run is drawn
in one call per field, so its rows all differ.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import torch

from perfbench.yardstick.batches import HASH
from perfbench.yardstick.retrieval_shapes import FEATURES, ID_FEATURES, param_specs, vocab
from perfbench.yardstick.weights import _TRUNC_CORRECTION, _flat, derived_seed


@torch.no_grad()
def make_weights(cfg: Mapping, seed: int, device, tables_only: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every parameter of
    ``param_specs(cfg)`` (only the ``normal`` ones with ``tables_only``)."""
    specs = param_specs(cfg)
    normal = [n for n, s in specs.items() if s.init == "normal"]
    buf, out = _flat(specs, normal, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, 0))
    buf.normal_(0.0, 0.02, generator=gen)
    if tables_only:
        return out
    lecun = sorted((n for n, s in specs.items() if s.init == "lecun"),
                   key=lambda n: specs[n].fan_in)
    kbuf, kernels = _flat(specs, lecun, device)
    gen.manual_seed(derived_seed(seed, 1))
    torch.nn.init.trunc_normal_(kbuf, 0.0, 1.0, -2.0, 2.0, generator=gen)
    off = 0
    for fan_in in sorted({specs[n].fan_in for n in lecun}):
        size = sum(math.prod(specs[n].shape) for n in lecun if specs[n].fan_in == fan_in)
        kbuf[off:off + size].mul_(math.sqrt(1.0 / fan_in) / _TRUNC_CORRECTION)
        off += size
    out.update(kernels)
    for n, s in specs.items():
        if s.init in ("ones", "zeros"):
            out[n] = torch.full(s.shape, 1.0 if s.init == "ones" else 0.0,
                                dtype=torch.float32, device=device)
    return {n: out[n] for n in specs}


def zipf(size, n_ids: int, exponent: float, gen: torch.Generator, device):
    """(int64 ids of ``size``: ranks drawn with P(r) ∝ r^-exponent over
    1..``n_ids``, hashed; float32 each rank's probability)."""
    ranks = torch.arange(1, n_ids + 1, device=device, dtype=torch.float64)
    weight = ranks.pow_(-exponent)
    cdf = torch.cumsum(weight, 0)
    total = float(cdf[-1])
    cdf /= total
    u = torch.rand(size, generator=gen, device=device, dtype=torch.float64)
    r = torch.searchsorted(cdf, u).clamp_(max=n_ids - 1)
    return r * HASH % n_ids, (weight[r] / total).float()


@torch.no_grad()
def make_batches(cfg: Mapping, traffic: Mapping, seed: int, device
                 ) -> List[Dict[str, object]]:
    """The traffic's ``placed_batches`` batches of ``batch_size`` rows."""
    batch_size, count = traffic["batch_size"], traffic["placed_batches"]
    length = cfg["max_seq_len"]
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, 2))
    rows = batch_size * count
    shape = (rows, length + 1)  # the history, then the target
    items, probability = {}, {}
    for f in ID_FEATURES:
        items[f], probability[f] = zipf(shape, vocab(cfg, f), traffic["id_zipf"], gen, device)
    popularity = probability["video_id"]
    items["duration"] = torch.rand(shape, generator=gen, device=device) * cfg["max_duration_s"]
    items["timestamp"] = torch.randint(0, cfg["time_buckets"], shape, generator=gen,
                                       device=device)
    valid = torch.ones((rows, length), dtype=torch.bool, device=device)

    def part(x, i):
        return x[i * batch_size:(i + 1) * batch_size].contiguous()

    return [{"history": {f: part(items[f][:, :length], i) for f in FEATURES},
             "target": {f: part(items[f][:, length], i) for f in FEATURES},
             "history_valid": part(valid, i),
             "history_popularity": part(popularity[:, :length], i),
             "target_popularity": part(popularity[:, length], i)}
            for i in range(count)]


def to_host(batch: Mapping) -> Dict[str, object]:
    """A batch as numpy arrays, the input ``_put_batch`` takes."""
    return {k: to_host(v) if isinstance(v, Mapping) else v.cpu().numpy()
            for k, v in batch.items()}
