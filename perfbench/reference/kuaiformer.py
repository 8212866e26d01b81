"""The KuaiFormer retrieval tower and its seq2seq training step in plain
PyTorch: the reference that decides the KuaiFormer cell's ``correct``.

Follows the published description (arXiv 2411.10057) as the configuration
states it, in float32 with TF32 off:

- items: five lookups per item (video id, category and tag by id; duration
  bucketed as value / max · buckets, truncated; timestamp modulo the time
  buckets), concatenated and fused by a two-layer MLP (tanh GELU) and an
  RMSNorm (eps 1e-6) into one token;
- adaptive compression: the history's segments, oldest first, split into
  groups; each group of more than one item runs through a bidirectional
  encoder (pre-norm blocks under its padding mask) and is mean-pooled over
  its valid items into one token; a group of one is kept raw; a token is
  valid when its group holds a valid item;
- the main stack over the interleaved sequence ``[items (T) ; query
  groups (T·k)]``, the k learnable query tokens repeated after every
  token: item t sees the items up to t, query (t, j) the items up to t and
  its own group; padded items are masked as keys (additive -1e9 masks);
  pre-norm blocks (RMSNorm, multi-head attention, SwiGLU FFN, residuals);
  the final RMSNorm gives the k interests after every prefix;
- the seq2seq in-batch loss: at each of the R raw positions, each row's
  next item (the history shifted by one, the target last) is its positive
  and the other rows' next items at that position its negatives; a logit is
  the max over the k interests of their dot product with the item's
  embedding, LogQ subtracts log(popularity + 1e-8) from each column, label
  smoothing puts 1 - α on the positive and α / (B - 1) on each negative;
  the loss is the mean over the valid (row, position) pairs;
- the update: adamw (optax's: eps 1e-8 outside the square root, weight
  decay on every dense tensor) on the warmup-cosine schedule (linear from 0
  to the peak over the warmup, then cosine to 1% of it at ``total_steps``);
  row-wise adagrad (0.1 initial accumulators, eps 1e-7) of the touched id
  table rows from each lookup's gradient, every lookup of a table adding to
  the accumulators before any row moves.

Departures from the paper, each the configuration's: RMSNorm where the
reference implementation has LayerNorm; no dropout; the id tables take
the touched-row update instead of the optimizer of the dense weights; the
sizes the paper does not state come from the configuration's ``assumed``.

It runs the batch in blocks of rows: the columns (the next items'
embeddings) are computed once for the whole batch and shared, each block's
rows score against all of them, and the columns' gradient, summed over the
blocks, is carried back through their embedding at the end. The products
go through an ``ops`` object (``onetrans.F32Ops``; ``Fp8Ops`` is the
control, one precision below the configuration's bfloat16).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import torch
import torch.nn.functional as F

from perfbench.reference.onetrans import F32Ops, gelu, rmsnorm

NEG = -1e9
ID_FEATURES = ("video_id", "category", "tag")


def _linear(P, name: str, x, ops):
    return ops.linear(x, P[name + ".weight"], P[name + ".bias"])


def attention(q, k, v, bias, heads: int, ops) -> torch.Tensor:
    """[N, L, H·Dh] self-attention under an additive ``bias``."""
    n, length, hd = q.shape
    dh = hd // heads

    def split(x):
        return x.reshape(n, length, heads, dh).transpose(1, 2)

    logits = ops.matmul(split(q), split(k).transpose(-1, -2)) / math.sqrt(dh)
    probs = torch.softmax(logits + bias, dim=-1)
    return ops.matmul(probs, split(v)).transpose(1, 2).reshape(n, length, hd)


def block(P, p: str, x, bias, heads: int, ops) -> torch.Tensor:
    """One pre-norm block: attention, then the SwiGLU FFN, each a residual."""
    h = rmsnorm(x, P[p + "attn_norm.scale"])
    q, k, v = (_linear(P, f"{p}attn.{n}_proj", h, ops) for n in "qkv")
    x = x + _linear(P, p + "attn.o_proj", attention(q, k, v, bias, heads, ops), ops)
    h = rmsnorm(x, P[p + "ffn_norm.scale"])
    f = F.silu(_linear(P, p + "ffn.gate", h, ops)) * _linear(P, p + "ffn.up", h, ops)
    return x + _linear(P, p + "ffn.down", f, ops)


def embed(P, cfg: Mapping, feats, dummies, ops) -> torch.Tensor:
    """[..., D] item tokens; ``dummies`` (zeros, one row per lookup) carry
    the id tables' gradients."""
    ids = {f: feats[f] for f in ID_FEATURES}
    nb = cfg["duration_buckets"]
    ids["duration"] = (feats["duration"].float() / cfg["max_duration_s"] * nb).long().clamp(
        0, nb - 1)
    ids["timestamp"] = feats["timestamp"].long() % cfg["time_buckets"]
    parts = []
    for f in ID_FEATURES + ("duration", "timestamp"):
        t = P[f"embed.tables.{f}.weight"]
        parts.append(t.detach()[ids[f]] + dummies[f] if f in ID_FEATURES else t[ids[f]])
    x = gelu(_linear(P, "embed.fuse_hidden", torch.cat(parts, -1), ops))
    return rmsnorm(_linear(P, "embed.fuse_out", x, ops), P["embed.fuse_norm.scale"])


def compress(P, cfg: Mapping, x, valid, ops):
    """(tokens [B, T, D], token validity [B, T]) of [B, L, D] items."""
    b, _, d = x.shape
    tokens, token_valid, off = [], [], 0
    for i, (length, g) in enumerate(cfg["compression_schedule"]):
        seg, sv = x[:, off:off + length], valid[:, off:off + length]
        off += length
        if g == 1:
            tokens.append(seg)
            token_valid.append(sv)
            continue
        n = length // g
        xs, vs = seg.reshape(b * n, g, d), sv.reshape(b * n, g)
        bias = torch.where(vs, 0.0, NEG)[:, None, None, :]
        for j in range(cfg["compression_layers"]):
            xs = block(P, f"compress.segment_{i}.layers.{j}.", xs, bias, cfg["num_heads"], ops)
        w = vs.float()[..., None]
        tokens.append(((xs * w).sum(1) / w.sum(1).clamp_min(1.0)).reshape(b, n, d))
        token_valid.append(vs.any(-1).reshape(b, n))
    return torch.cat(tokens, 1), torch.cat(token_valid, 1)


def interleaved_bias(token_valid: torch.Tensor, k: int) -> torch.Tensor:
    """[B, 1, T(1+k), T(1+k)] additive mask of ``[items ; query groups]``."""
    b, t = token_valid.shape
    dev = token_valid.device
    item = torch.arange(t, device=dev)
    group = torch.arange(t, device=dev).repeat_interleave(k)  # each query slot's t
    # time of every slot (an item's index, a query's group); queries' groups
    time = torch.cat([item, group])
    is_item = torch.cat([torch.ones(t, dtype=torch.bool, device=dev),
                         torch.zeros(t * k, dtype=torch.bool, device=dev)])
    sees_item = is_item[None, :] & (time[None, :] <= time[:, None])
    own_group = ~is_item[:, None] & ~is_item[None, :] & (time[None, :] == time[:, None])
    key_valid = torch.cat([token_valid, torch.ones((b, t * k), dtype=torch.bool, device=dev)], 1)
    return (torch.where(sees_item | own_group, 0.0, NEG)[None, None]
            + torch.where(key_valid, 0.0, NEG)[:, None, None, :])


def interests(P, cfg: Mapping, hist, hv, dummies, ops) -> torch.Tensor:
    """[B, T, k, D]: the k interests after every compressed-token prefix."""
    tokens, token_valid = compress(P, cfg, embed(P, cfg, hist, dummies, ops), hv, ops)
    b, t, d = tokens.shape
    k = cfg["num_query_tokens"]
    x = torch.cat([tokens, P["query_tokens"].repeat(t, 1)[None].expand(b, -1, -1)], 1)
    bias = interleaved_bias(token_valid, k)
    for i in range(cfg["num_layers"]):
        x = block(P, f"blocks.{i}.", x, bias, cfg["num_heads"], ops)
    return rmsnorm(x[:, t:], P["final_norm.scale"]).reshape(b, t, k, d)


def raw_tail(cfg: Mapping) -> int:
    length, g = cfg["compression_schedule"][-1]
    if g != 1:
        raise ValueError("the seq2seq mode needs a raw newest segment")
    return length


def next_items(cfg: Mapping, batch) -> Dict[str, torch.Tensor]:
    """[B, R] features of each raw position's next item."""
    r, length = raw_tail(cfg), cfg["max_seq_len"]
    return {f: torch.cat([v[:, length - r + 1:], batch["target"][f][:, None]], 1)
            for f, v in batch["history"].items()}


def next_valid(cfg: Mapping, batch) -> torch.Tensor:
    """[B, R]: a raw position holds an item and has a next one."""
    r, length = raw_tail(cfg), cfg["max_seq_len"]
    hv = batch["history_valid"]
    has_next = torch.cat([hv[:, length - r + 1:], hv.new_ones((hv.shape[0], 1))], 1)
    return hv[:, length - r:] & has_next


def block_loss(P, cfg: Mapping, sub, dummies, columns, log_q, weight, total, ops):
    """A block's rows' share of the batch's mean loss: their interests at
    the R positions against ``columns`` [B, R, D] (every row's next items)."""
    got = interests(P, cfg, sub["history"], sub["history_valid"], dummies, ops)
    got = got[:, -raw_tail(cfg):]  # the raw positions are the last R tokens
    # [R, b·k, D] x [R, D, B] -> [R, b, k, B], the max over the k interests
    b, r, k, d = got.shape
    logits = ops.matmul(got.transpose(0, 1).reshape(r, b * k, d), columns.permute(1, 2, 0))
    logits = logits.reshape(r, b, k, -1).amax(2)
    if log_q is not None:
        logits = logits - log_q[:, None, :]
    n = columns.shape[0]
    a = cfg["label_smoothing"]
    rows = torch.arange(sub["offset"], sub["offset"] + b, device=got.device)
    eye = rows[:, None] == torch.arange(n, device=got.device)[None, :]
    targets = torch.where(eye, 1.0 - a, a / max(n - 1, 1))
    per_row = -(targets * torch.log_softmax(logits, -1)).sum(-1)  # [R, b]
    return (per_row * weight.t()).sum() / total


def _lookups(cfg: Mapping, batch):
    """(table, history ids, history validity, next ids, next validity) of
    each id feature."""
    nxt, nv = next_items(cfg, batch), next_valid(cfg, batch)
    return [(f"embed.tables.{f}.weight", batch["history"][f], batch["history_valid"], nxt[f],
             nv) for f in ID_FEATURES]


def rows_per_block(cfg: Mapping, budget_bytes: float = 2**29) -> int:
    """Rows whose main-stack attention logits fit ``budget_bytes``."""
    t = sum(length // g for length, g in cfg["compression_schedule"])
    length = t * (1 + cfg["num_query_tokens"])
    return max(1, int(budget_bytes // (cfg["num_heads"] * length * length * 4)))


def gradients(P, cfg: Mapping, batch, ops, rows: int):
    """(loss, dense gradients by name, per-lookup gradients: history
    [B, L, D] and next items [B, R, D] by id feature) of one batch."""
    tables = {f"embed.tables.{f}.weight" for f in ID_FEATURES}
    dense = [n for n in P if n not in tables]
    params = [P[n].requires_grad_(True) for n in dense]
    d = cfg["embed_dim"]
    bsz = batch["history_valid"].shape[0]
    weight = next_valid(cfg, batch).float()
    total = weight.sum().clamp_min(1.0)
    nxt = next_items(cfg, batch)
    tdum = {f: torch.zeros(nxt[f].shape + (d,), device=weight.device, requires_grad=True)
            for f in ID_FEATURES}
    col_graph = embed(P, cfg, nxt, tdum, ops)  # [B, R, D]
    columns = col_graph.detach().requires_grad_(True)
    log_q = None
    if cfg["use_logq_correction"]:
        pop = torch.cat([batch["history_popularity"][:, cfg["max_seq_len"] - raw_tail(cfg) + 1:],
                         batch["target_popularity"][:, None]], 1)
        log_q = torch.log(pop.float() + 1e-8).t()  # [R, B]
    grads = {n: torch.zeros_like(P[n]) for n in dense}
    gcols = torch.zeros_like(columns)
    hist_grads: Dict[str, List[torch.Tensor]] = {f: [] for f in ID_FEATURES}
    loss_total = 0.0
    for r0 in range(0, bsz, rows):
        sub = {"history": {f: v[r0:r0 + rows] for f, v in batch["history"].items()},
               "history_valid": batch["history_valid"][r0:r0 + rows], "offset": r0}
        hdum = {f: torch.zeros(sub["history"][f].shape + (d,), device=weight.device,
                               requires_grad=True) for f in ID_FEATURES}
        loss = block_loss(P, cfg, sub, hdum, columns, log_q, weight[r0:r0 + rows], total, ops)
        got = torch.autograd.grad(loss, params + [columns] + list(hdum.values()),
                                  allow_unused=True)
        for n, g in zip(dense, got):
            if g is not None:
                grads[n] += g
        gcols += got[len(dense)]
        for f, g in zip(hdum, got[len(dense) + 1:]):
            hist_grads[f].append(g)
        loss_total += float(loss.detach())
    got = torch.autograd.grad(col_graph, params + list(tdum.values()), grad_outputs=gcols,
                              allow_unused=True)
    for n, g in zip(dense, got):
        if g is not None:
            grads[n] += g
    for p in params:
        p.requires_grad_(False)
    lookups = {f: (torch.cat(hist_grads[f], 0), g) for f, g in zip(tdum, got[len(dense):])}
    return loss_total, grads, lookups


def learning_rate(cfg: Mapping, count: int, total_steps: int) -> float:
    """The warmup-cosine schedule at adamw's ``count``."""
    peak, warmup = cfg["learning_rate"], cfg["warmup_steps"]
    if count < warmup:
        return peak * count / warmup
    decay = max(total_steps, warmup + 1) - warmup
    t = min(count - warmup, decay)
    return peak * (0.99 * 0.5 * (1 + math.cos(math.pi * t / decay)) + 0.01)


@torch.no_grad()
def apply_update(P, state, grads, lookups, cfg: Mapping, batch, total_steps: int) -> None:
    """The optimizer step, in place on ``P`` and ``state``."""
    if not (cfg["use_sparse_embedding_updates"] and cfg["sparse_update_mode"] == "rowwise"
            and cfg["sparse_scatter_budget"] == 0):
        raise ValueError("the reference follows row-wise sparse updates of every row only")
    count = state["count"]
    lr = learning_rate(cfg, count, total_steps)
    b1, b2 = cfg["adam_b1"], cfg["adam_b2"]
    c1, c2 = 1 - b1 ** (count + 1), 1 - b2 ** (count + 1)
    for n, g in grads.items():
        mu, nu = state["mu"][n], state["nu"][n]
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g.square())
        P[n].sub_(lr * ((mu / c1) / ((nu / c2).sqrt() + 1e-8) + cfg["weight_decay"] * P[n]))
    state["count"] = count + 1
    slr = cfg["sparse_embedding_lr"]
    d = cfg["embed_dim"]
    for (table, hist_ids, hv, next_ids, nv), f in zip(_lookups(cfg, batch), ID_FEATURES):
        hg, tg = lookups[f]
        keep = torch.cat([hv.reshape(-1), nv.reshape(-1)])
        ids = torch.cat([hist_ids.reshape(-1), next_ids.reshape(-1)])[keep]
        g = torch.cat([hg.reshape(-1, d), tg.reshape(-1, d)])[keep]
        acc = state["accum"][table]
        acc.index_add_(0, ids, g.square().mean(-1))
        P[table].index_add_(0, ids, -slr * g * torch.rsqrt(acc[ids] + 1e-7)[:, None])


def reference_steps(P: Dict[str, torch.Tensor], cfg: Mapping, batches, ops=None,
                    total_steps: int = 100_000, mode: str = "seq2seq") -> Dict[str, object]:
    """Train a copy of ``P`` (the initial weights) on ``batches`` in turn
    and return the readings the comparison takes: each step's loss; per
    parameter the first gradient as the optimizer takes it (dense: the norm
    of the gradient, read from adamw's second moment after one step,
    (1 - b2) g^2; tables: the norm of the first step's change times
    sqrt(0.1) / sparse lr); per table the rows the first step moved; per
    parameter the norm of the change over all the steps."""
    if mode != "seq2seq":
        raise ValueError(f"the reference follows the seq2seq mode only, not {mode!r}")
    ops = ops or F32Ops()
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        tables = [f"embed.tables.{f}.weight" for f in ID_FEATURES]
        p0, P = P, {n: t.detach().clone() for n, t in P.items()}
        state = {"count": 0, "mu": {}, "nu": {}, "accum": {}}
        for n, t in P.items():
            if n in tables:
                state["accum"][n] = torch.full(t.shape[:1], 0.1, device=t.device)
            else:
                state["mu"][n] = torch.zeros_like(t)
                state["nu"][n] = torch.zeros_like(t)
        rows = rows_per_block(cfg)
        losses, first, moved = [], {}, {}
        for k, batch in enumerate(batches):
            loss, grads, lookups = gradients(P, cfg, batch, ops, rows)
            apply_update(P, state, grads, lookups, cfg, batch, total_steps)
            losses.append(loss)
            if k == 0:
                for n in P:
                    if n in tables:
                        first[n] = (float((P[n] - p0[n]).norm()) * math.sqrt(0.1)
                                    / cfg["sparse_embedding_lr"])
                        moved[n] = int((P[n] != p0[n]).any(-1).sum())
                    else:
                        first[n] = float(torch.sqrt(state["nu"][n].sum() / (1 - cfg["adam_b2"])))
        change = {n: float((P[n] - p0[n]).norm()) for n in P}
        return {"loss": losses, "first": first, "rows": moved, "change": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
