"""The OneTrans ranking model and its training step in plain PyTorch: the
reference that decides a training cell's ``correct``.

Follows the published description (arXiv 2510.26104) as the configuration
states it, in float32 with TF32 off:

- tokenizer: every non-sequence feature's table row, concatenated and
  projected by one dense layer to the NS tokens; each behaviour sequence's
  items through the shared item table and projection, a learnt [SEP] token
  between sequences; the stream is [S ; NS];
- blocks: pre-norm RMSNorm (eps 1e-6), shared Q/K/V/FFN weights for S
  tokens and a dedicated stack for each NS token, the tail ``keep`` tokens
  as queries (pyramid) over every key under the causal band and the keys'
  validity (additive -1e9 masks), tanh-GELU FFNs, residuals; no dropout;
- final RMSNorm, per-task MLP heads on the last token, the sum over tasks
  of each task's mean sigmoid BCE;
- the update: global-norm clip of the dense gradients, optax's rmsprop
  (decay 0.9, eps 1e-8 inside the square root, then -lr, then the momentum
  trace), and row-wise adagrad (0.1 initial accumulators, eps 1e-7) of the
  touched table rows from each lookup's gradient.

It runs in blocks of rows (the gradients of a mean summed over blocks) so
that the timed batch fits beside nothing else. ``Fp8Ops`` computes every
product with its operands rounded to float8 (e4m3 forward, e5m2 gradients,
one scale per tensor): the control, one precision below the configuration's
bfloat16. ``Bf16Ops`` computes them in bfloat16, as a witness.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import torch
import torch.nn.functional as F

from perfbench.yardstick.model_shapes import keep_lengths, non_seq_features, table_names

NEG = -1e9


class F32Ops:
    """Products in float32."""

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(a, b)

    def linear(self, x, w, b=None):
        y = self.matmul(x, w.t())
        return y if b is None else y + b

    def stack(self, x, w):
        """[B, n, i] by each NS token's own [n, i, o] -> [B, n, o]."""
        return self.matmul(x.transpose(0, 1), w).transpose(0, 1)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` with one scale for the tensor, as float32."""
    if x.numel() == 0:  # a layer with no S tokens left
        return x
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).float() / scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _round(a, torch.float8_e4m3fn), _round(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round(g, torch.float8_e5m2)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        if qb.dim() == 2:
            gb = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1, qg.shape[-1])
        else:
            gb = torch.matmul(qa.transpose(-1, -2), qg)
        return ga, gb


class Fp8Ops(F32Ops):
    """Products of operands rounded to float8 (the control)."""

    def matmul(self, a, b):
        return _Fp8MatMul.apply(a, b)


class Bf16Ops(F32Ops):
    """Products of bfloat16 operands, rounded to bfloat16 (the
    configuration's own precision: a witness of what its rounding alone
    does to the readings)."""

    def matmul(self, a, b):
        return torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16)).float()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def attention(q, k, v, key_valid, q_offset: int, heads: int, ops) -> torch.Tensor:
    """[B, Lq, H·Dh] queries at positions q_offset.. over [B, Lk, H·Dh]."""
    b, lq, hd = q.shape
    lk, dh = k.shape[1], hd // heads

    def split(x):
        return x.reshape(b, x.shape[1], heads, dh).transpose(1, 2)

    logits = ops.matmul(split(q), split(k).transpose(-1, -2)) / math.sqrt(dh)
    qpos = torch.arange(lq, device=q.device) + q_offset
    kpos = torch.arange(lk, device=q.device)
    bias = torch.where(kpos[None, :] <= qpos[:, None], 0.0, NEG)[None, None]
    bias = bias + torch.where(key_valid, 0.0, NEG)[:, None, None, :]
    probs = torch.softmax(logits + bias, dim=-1)
    return ops.matmul(probs, split(v)).transpose(1, 2).reshape(b, lq, hd)


def block(P, p: str, x, s_len: int, keep: int, valid, cfg: Mapping, ops):
    n = cfg["num_ns_tokens"]
    t = x.shape[1]
    h = rmsnorm(x, P[p + "attn_norm.scale"])
    hs, hns = h[:, :s_len], h[:, s_len:]
    k = torch.cat([ops.linear(hs, P[p + "k_s.weight"], P[p + "k_s.bias"]),
                   ops.stack(hns, P[p + "k_ns"])], 1)
    v = torch.cat([ops.linear(hs, P[p + "v_s.weight"], P[p + "v_s.bias"]),
                   ops.stack(hns, P[p + "v_ns"])], 1)
    keep_s = keep - n
    q = ops.stack(hns, P[p + "q_ns"])
    if keep_s > 0:
        q = torch.cat([ops.linear(hs[:, s_len - keep_s:], P[p + "q_s.weight"],
                                  P[p + "q_s.bias"]), q], 1)
    a = attention(q, k, v, valid, t - keep, cfg["num_heads"], ops)
    x = x[:, t - keep:] + ops.linear(a, P[p + "o_proj.weight"], P[p + "o_proj.bias"])
    h = rmsnorm(x, P[p + "ffn_norm.scale"])
    f = ops.stack(gelu(ops.stack(h[:, keep_s:], P[p + "ffn_ns_in"]) + P[p + "ffn_ns_in_b"]),
                  P[p + "ffn_ns_out"]) + P[p + "ffn_ns_out_b"]
    if keep_s > 0:
        fs = ops.linear(gelu(ops.linear(h[:, :keep_s], P[p + "ffn_s_in.weight"],
                                        P[p + "ffn_s_in.bias"])),
                        P[p + "ffn_s_out.weight"], P[p + "ffn_s_out.bias"])
        f = torch.cat([fs, f], 1)
    return x + f


def logits(P, cfg: Mapping, batch, dummies, ops) -> Dict[str, torch.Tensor]:
    """Per-task logits [B]; ``dummies`` (zeros, one row per lookup) carry
    the lookups' gradients."""
    n, d = cfg["num_ns_tokens"], cfg["embed_dim"]
    parts = [P[f"tokenizer.embeds.{f}.weight"].detach()[batch["non_seq"][f]] + dummies[f"ns_{f}"]
             for f in non_seq_features(cfg)]
    ns = ops.linear(torch.cat(parts, -1), P["tokenizer.ns_proj.weight"],
                    P["tokenizer.ns_proj.bias"])
    b = ns.shape[0]
    ns = ns.reshape(b, n, d)
    toks, valids = [], []
    names = list(cfg["sequence_features"])
    ones = torch.ones((b, 1), dtype=torch.bool, device=ns.device)
    for i, sf in enumerate(names):
        e = P["tokenizer.item_embed.weight"].detach()[batch["sequences"][sf]] + dummies[f"seq_{sf}"]
        toks.append(ops.linear(e, P["tokenizer.seq_proj.weight"], P["tokenizer.seq_proj.bias"]))
        valids.append(batch["seq_valid"][sf])
        if i < len(names) - 1:
            toks.append(P["tokenizer.sep_token"][None, None].expand(b, 1, d))
            valids.append(ones)
    x = torch.cat(toks + [ns], 1)
    valid = torch.cat(valids + [ones.expand(b, n)], 1)
    total = x.shape[1]
    s_len = total - n
    for i, keep in enumerate(keep_lengths(cfg, total)):
        x = block(P, f"blocks.{i}.", x, s_len, keep, valid, cfg, ops)
        valid = valid[:, -keep:]
        s_len = keep - n
    last = rmsnorm(x, P["final_norm.scale"])[:, -1]
    return {t: ops.linear(gelu(ops.linear(last, P[f"heads.{t}.hidden.weight"],
                                          P[f"heads.{t}.hidden.bias"])),
                          P[f"heads.{t}.out.weight"], P[f"heads.{t}.out.bias"])[:, 0]
            for t in cfg["tasks"]}


def _lookups(cfg: Mapping, batch):
    """(dummy name, table name, ids, valid) of every lookup group."""
    out = [(f"ns_{f}", f"tokenizer.embeds.{f}.weight", batch["non_seq"][f], None)
           for f in non_seq_features(cfg)]
    out += [(f"seq_{sf}", "tokenizer.item_embed.weight", batch["sequences"][sf],
             batch["seq_valid"][sf]) for sf in cfg["sequence_features"]]
    return out


def rows_per_block(cfg: Mapping, s_len: int, budget_bytes: float = 2**30) -> int:
    """Rows whose widest activations (layer 0's attention logits, an FFN's
    hidden layer over every token) fit ``budget_bytes`` each."""
    total = s_len + cfg["num_ns_tokens"]
    keep0 = keep_lengths(cfg, total)[0]
    per_row = max(cfg["num_heads"] * keep0 * total,
                  total * max(cfg["ffn_dim"], 4 * cfg["embed_dim"])) * 4
    return max(1, int(budget_bytes // per_row))


def gradients(P, cfg: Mapping, batch, ops, rows: int):
    """(loss, dense gradients by name, lookup gradients by dummy name) of
    one batch, the batch's mean summed over blocks of ``rows`` rows."""
    tables = set(table_names(cfg))
    dense = [n for n in P if n not in tables]
    labels = batch["labels"]
    bsz = next(iter(labels.values())).shape[0]
    grads = {n: torch.zeros_like(P[n]) for n in dense}
    dgrads: Dict[str, List[torch.Tensor]] = {}
    loss_total = 0.0
    params = [P[n].requires_grad_(True) for n in dense]
    for r0 in range(0, bsz, rows):
        sub = {g: {k: v[r0:r0 + rows] for k, v in batch[g].items()}
               for g in ("non_seq", "sequences", "seq_valid", "labels")}
        dummies = {name: torch.zeros(ids.shape + (P[table].shape[1],), device=ids.device,
                                     requires_grad=True)
                   for name, table, ids, _ in _lookups(cfg, sub)}
        out = logits(P, cfg, sub, dummies, ops)
        loss = 0.0
        for t, lg in out.items():
            y = sub["labels"][t].float()
            loss = loss + (lg.clamp_min(0) - lg * y + torch.log1p(torch.exp(-lg.abs()))).sum() / bsz
        got = torch.autograd.grad(loss, params + list(dummies.values()), allow_unused=True)
        for n, g in zip(dense, got):
            if g is not None:  # a layer with no S queries leaves q_s and ffn_s unused
                grads[n] += g
        for name, g in zip(dummies, got[len(dense):]):
            dgrads.setdefault(name, []).append(g)
        loss_total += float(loss.detach())
    for p in params:
        p.requires_grad_(False)
    return loss_total, grads, {k: torch.cat(v, 0) for k, v in dgrads.items()}


@torch.no_grad()
def apply_update(P, state, grads, dgrads, cfg: Mapping, batch) -> None:
    """The optimizer step, in place on ``P`` and ``state``."""
    if cfg["dense_optimizer"] != "rmsprop" or cfg["dense_lr_schedule"] != "constant":
        raise ValueError("the reference follows rmsprop at a constant rate only")
    if not (cfg["use_sparse_embedding_updates"] and cfg["sparse_update_mode"] == "rowwise"
            and cfg["sparse_optimizer"] == "adagrad" and cfg["sparse_lr_warmup_steps"] <= 0
            and cfg["sparse_scatter_budget"] == 0):
        raise ValueError("the reference follows row-wise adagrad at a constant rate only")
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    clip = cfg["gradient_clip_norm"]
    factor = 1.0 if float(norm) < clip else clip / float(norm)
    lr, mom = cfg["dense_lr"], cfg["dense_momentum"]
    for n, g in grads.items():
        g = g * factor
        nu, trace = state["nu"][n], state["trace"][n]
        nu.mul_(0.9).add_(0.1 * g.square())
        trace.mul_(mom).add_(-lr * g * torch.rsqrt(nu + 1e-8))
        P[n].add_(trace)
    slr = cfg["sparse_lr"]
    rows: Dict[str, list] = {}  # table -> [(ids, gradients)] of its valid lookups
    for name, table, ids, valid in _lookups(cfg, batch):
        g = dgrads[name].reshape(-1, P[table].shape[1])
        ids = ids.reshape(-1)
        if valid is not None:
            keep = valid.reshape(-1)
            g, ids = g[keep], ids[keep]
        rows.setdefault(table, []).append((ids, g))
    # every lookup of a table adds to the accumulators before any row moves
    for table, parts in rows.items():
        ids = torch.cat([i for i, _ in parts])
        g = torch.cat([g for _, g in parts])
        acc = state["accum"][table]
        acc.index_add_(0, ids, g.square().mean(-1))
        P[table].index_add_(0, ids, -slr * g * torch.rsqrt(acc[ids] + 1e-7)[:, None])


def reference_steps(P: Dict[str, torch.Tensor], cfg: Mapping, batches, ops=None
                    ) -> Dict[str, object]:
    """Train a copy of ``P`` (the initial weights) on ``batches`` in turn
    and return the readings the comparison takes: each step's loss;
    per parameter the first gradient as the optimizer takes it (dense: the
    clipped gradient's norm; tables: the norm of the first step's change
    times sqrt(0.1) / sparse_lr, which is the norm of the row-summed
    gradient while the accumulators are near 0.1); per table the rows the
    first step moved; per parameter the norm of the change over all the
    steps."""
    ops = ops or F32Ops()
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        tables = table_names(cfg)
        p0, P = P, {n: t.detach().clone() for n, t in P.items()}
        state = {"nu": {}, "trace": {}, "accum": {}}
        for n, t in P.items():
            if n in tables:
                state["accum"][n] = torch.full(t.shape[:1], 0.1, device=t.device)
            else:
                state["nu"][n] = torch.zeros_like(t)
                state["trace"][n] = torch.zeros_like(t)
        s_len = next(iter(batches[0]["sequences"].values())).shape[1]
        s_len = s_len * len(cfg["sequence_features"]) + max(len(cfg["sequence_features"]) - 1, 0)
        rows = rows_per_block(cfg, s_len)
        losses, first, moved = [], {}, {}
        for k, batch in enumerate(batches):
            loss, grads, dgrads = gradients(P, cfg, batch, ops, rows)
            apply_update(P, state, grads, dgrads, cfg, batch)
            losses.append(loss)
            if k == 0:
                for n in P:
                    if n in tables:
                        first[n] = float((P[n] - p0[n]).norm()) * math.sqrt(0.1) / cfg["sparse_lr"]
                        moved[n] = int((P[n] != p0[n]).any(-1).sum())
                    else:
                        first[n] = float(torch.sqrt(state["nu"][n].sum() / 0.1))
        change = {n: float((P[n] - p0[n]).norm()) for n in P}
        return {"loss": losses, "first": first, "rows": moved, "change": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
