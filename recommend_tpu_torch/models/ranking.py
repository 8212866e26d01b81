"""Unified ranking transformer (OneTrans capability): training and serving
forwards.

tokenize [S; NS] -> N pre-norm blocks with mixed parameterization (shared
Q/K/V/FFN weights for S tokens, per-token dedicated stacks for the n_ns NS
tokens) and pyramid tail-query pruning -> RMSNorm -> per-task MLP heads on
the last token.

The KV-cache decomposition: under the causal band mask the S trunk does not
depend on the NS tokens, so ``encode_s`` runs it once per request and returns
per-layer S keys/values, and ``score_with_cache`` scores any number of
candidates through the NS-only path over that cache. It equals the full
forward.

The cross-request session cache builds on it: ``pad_s_cache`` gives a
refresh cache spare invalid rows, ``extend_s_cache`` appends the K/V of a
few new behavior items per layer into extension buffers (one trunk step over
the new tokens only), ``compact_s_cache`` folds full buffers into the spare
rows, and ``score_with_cache_ext`` scores over cache and extension. Unlike
the JAX package's functional updates, the extension and the fold are written
in place.

Training runs ``forward`` with ``deterministic=False`` (dropout after the
attention and the FFN of every block, as flax's ``nn.Dropout``: keep with
probability 1 - rate, scale the kept values by 1 / (1 - rate)) and with
``dummies`` for the sparse embedding update. The dropout bits come from an
explicit ``torch.Generator``: it draws one seed per block, and each block
seeds its own generator from it, so a block recomputed under
``use_remat`` (``torch.utils.checkpoint``) draws the same mask again.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from recommend_tpu_torch.config import RankingConfig
from recommend_tpu_torch.models.tokenizer import UnifiedTokenizer, compute_dtype, dense
from recommend_tpu_torch.ops.attention import (
    causal_band_mask,
    dot_product_attention,
    padding_mask_bias,
)
from recommend_tpu_torch.ops.flash_attention import (
    flash_attention_bhld,
    flash_attention_bhld_segkv,
)
from recommend_tpu_torch.ops.normalization import RMSNorm

CacheEntry = Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _dropout(x: torch.Tensor, rate: float,
             gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: the identity without a generator, else keep each
    value with probability 1 - rate and scale it by 1 / (1 - rate)."""
    if gen is None:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def _einsum_f32(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum(x, w.astype(x.dtype), preferred_element_type=f32)`` cast back
    to x.dtype: products of the rounded operands are exact in float32."""
    return torch.einsum(eq, x.float(), w.to(x.dtype).float()).to(x.dtype)


def pyramid_keep_lengths(cfg: RankingConfig, total_len: int) -> List[int]:
    """Static per-layer kept-token counts (oneTrans PyramidScheduler). Ratios
    apply to the initial length; the kept window is never smaller than the
    NS block and never grows."""
    lens = []
    cur = total_len
    for r in cfg.pyramid_ratios:
        keep = max(int(round(total_len * r)), cfg.num_ns_tokens)
        keep = min(keep, cur)
        lens.append(keep)
        cur = keep
    return lens


class MixedBlock(nn.Module):
    """Pre-norm block with mixed shared(S)/dedicated(NS) parameterization.

    Three entry points share one parameter set:
      - ``full_call``: the whole [S; NS] stream with tail-query pruning;
      - ``s_call``: the S-only trunk, returning the S K/V for caching;
      - ``ns_call``: the NS-only path over cached S K/V, per candidate.
    """

    def __init__(self, cfg: RankingConfig):
        super().__init__()
        self.config = cfg
        d, h, n, f = cfg.embed_dim, cfg.num_heads, cfg.num_ns_tokens, cfg.ffn_dim
        hd = (d // h) * h
        self.attn_norm = RMSNorm(d)
        self.ffn_norm = RMSNorm(d)
        # shared (S-token) projections
        self.q_s = nn.Linear(d, hd)
        self.k_s = nn.Linear(d, hd)
        self.v_s = nn.Linear(d, hd)
        # dedicated per-NS-token stacks [n, d, h·dh]
        self.q_ns = nn.Parameter(torch.empty(n, d, hd))
        self.k_ns = nn.Parameter(torch.empty(n, d, hd))
        self.v_ns = nn.Parameter(torch.empty(n, d, hd))
        self.o_proj = nn.Linear(hd, d)
        # shared FFN (GELU 2-layer)
        self.ffn_s_in = nn.Linear(d, f)
        self.ffn_s_out = nn.Linear(f, d)
        # dedicated NS FFN stacks
        self.ffn_ns_in = nn.Parameter(torch.empty(n, d, f))
        self.ffn_ns_in_b = nn.Parameter(torch.empty(n, f))
        self.ffn_ns_out = nn.Parameter(torch.empty(n, f, d))
        self.ffn_ns_out_b = nn.Parameter(torch.empty(n, d))

    # -- projection helpers ------------------------------------------------
    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return dense(layer, x, compute_dtype(self.config))

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        h = self.config.num_heads
        return x.reshape(*x.shape[:-1], h, x.shape[-1] // h)

    def _proj_ns(self, w: torch.Tensor, x_ns: torch.Tensor) -> torch.Tensor:
        """[n, d, h·dh] stacked weights x [B, n, d] -> [B, n, h, dh]."""
        return self._heads(_einsum_f32("bnd,ndk->bnk", x_ns, w))

    def _ffn_ns(self, x_ns: torch.Tensor) -> torch.Tensor:
        dt = x_ns.dtype
        h = _einsum_f32("bnd,ndf->bnf", x_ns, self.ffn_ns_in) + self.ffn_ns_in_b.to(dt)
        h = gelu(h)
        return _einsum_f32("bnf,nfd->bnd", h, self.ffn_ns_out) + self.ffn_ns_out_b.to(dt)

    def _ffn_s(self, x: torch.Tensor) -> torch.Tensor:
        return self._dense(self.ffn_s_out, gelu(self._dense(self.ffn_s_in, x)))

    def _attend(
        self,
        q: torch.Tensor,  # [B, Lq, H, Dh]
        k: torch.Tensor,  # [B, Lkv, H, Dh]
        v: torch.Tensor,
        key_valid: torch.Tensor,  # [B, Lkv]
        q_offset: int,
    ) -> torch.Tensor:
        """Band attention: the kernels when the flag is on and the query
        window is at least 64 rows; the plain path otherwise."""
        if self.config.use_flash_attention and q.shape[1] >= 64:
            return flash_attention_bhld(q, k, v, key_valid, q_offset, True)
        bias = (
            causal_band_mask(q.shape[1], k.shape[1], q_offset, device=q.device)[None, None]
            + padding_mask_bias(key_valid)
        )
        return dot_product_attention(q, k, v, bias)

    def _attend_mixed(
        self,
        q: torch.Tensor,       # [B, Lq, H, Dh] tail queries over [S; NS]
        k_s: torch.Tensor,     # [B, Ls, H, Dh]
        v_s: torch.Tensor,
        s_valid: torch.Tensor,  # [B, Ls]
        k_ns: torch.Tensor,    # [B, n, H, Dh]
        v_ns: torch.Tensor,
        q_offset: int,
    ) -> torch.Tensor:
        """Band attention over the segmented [S ; NS] keys; the segmented
        kernel joins the segments without a concatenated copy."""
        if self.config.use_flash_attention and q.shape[1] >= 64:
            return flash_attention_bhld_segkv(
                q, k_s, v_s, k_ns, v_ns, s_valid, q_offset, True
            )
        # the same gate as _attend's, so this takes its plain path
        key_valid = torch.cat(
            [s_valid, s_valid.new_ones((q.shape[0], k_ns.shape[1]))], dim=1
        )
        return self._attend(
            q, torch.cat([k_s, k_ns], dim=1), torch.cat([v_s, v_ns], dim=1),
            key_valid, q_offset,
        )

    def _o_proj(self, attn: torch.Tensor) -> torch.Tensor:
        return self._dense(self.o_proj, attn.reshape(*attn.shape[:-2], -1))

    # -- entry points ------------------------------------------------------
    def full_call(
        self,
        x: torch.Tensor,  # [B, L, d]; last n_ns tokens are NS
        s_len: int,
        keep_len: int,
        key_valid: torch.Tensor,  # [B, L]
        deterministic: bool = True,
        dropout_seed: Optional[int] = None,
    ) -> torch.Tensor:
        """Tail-``keep_len`` queries over the full K/V -> [B, keep_len, d].
        With ``deterministic=False`` and a dropout rate, ``dropout_seed``
        seeds the block's dropout masks."""
        n = self.config.num_ns_tokens
        rate = self.config.dropout_rate
        gen = None
        if not deterministic and rate > 0.0:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(dropout_seed)
        b, l, d = x.shape
        assert s_len + n == l and n <= keep_len <= l
        hx = self.attn_norm(x)
        h_s, h_ns = hx[:, :s_len], hx[:, s_len:]
        k_s = self._heads(self._dense(self.k_s, h_s))
        v_s = self._heads(self._dense(self.v_s, h_s))
        k_ns = self._proj_ns(self.k_ns, h_ns)
        v_ns = self._proj_ns(self.v_ns, h_ns)
        keep_s = keep_len - n
        q_ns = self._proj_ns(self.q_ns, h_ns)
        if keep_s > 0:
            q_s_tail = self._heads(self._dense(self.q_s, h_s[:, s_len - keep_s:]))
            q = torch.cat([q_s_tail, q_ns], dim=1)
        else:
            q = q_ns
        attn = self._attend_mixed(
            q, k_s, v_s, key_valid[:, :s_len], k_ns, v_ns, l - keep_len
        )
        x = x[:, l - keep_len:] + _dropout(self._o_proj(attn), rate, gen)
        hx = self.ffn_norm(x)
        f_ns = self._ffn_ns(hx[:, keep_s:])
        f = torch.cat([self._ffn_s(hx[:, :keep_s]), f_ns], dim=1) if keep_s > 0 else f_ns
        return x + _dropout(f, rate, gen)

    def s_call(
        self,
        x_s: torch.Tensor,  # [B, Ls, d]
        keep_s: int,
        key_valid: torch.Tensor,  # [B, Ls]
    ) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
        """S-only trunk step -> (pruned S output or None, k_s, v_s); k_s/v_s
        are this layer's S keys/values, exactly what the full path uses."""
        hx = self.attn_norm(x_s)
        k_s = self._heads(self._dense(self.k_s, hx))
        v_s = self._heads(self._dense(self.v_s, hx))
        if keep_s <= 0:
            return None, k_s, v_s
        ls = x_s.shape[1]
        q = self._heads(self._dense(self.q_s, hx[:, ls - keep_s:]))
        attn = self._attend(q, k_s, v_s, key_valid, ls - keep_s)
        x = x_s[:, ls - keep_s:] + self._o_proj(attn)
        return x + self._ffn_s(self.ffn_norm(x)), k_s, v_s

    def ns_call(
        self,
        x_ns: torch.Tensor,  # [B, n, d]
        k_s: Optional[torch.Tensor],  # [Bc, Ls, H, Dh] cached (Bc broadcastable)
        v_s: Optional[torch.Tensor],
        s_key_valid: Optional[torch.Tensor],  # [Bc, Ls]
    ) -> torch.Tensor:
        """NS-token path over cached S K/V, the per-candidate hot path."""
        b, n = x_ns.shape[:2]
        hx = self.attn_norm(x_ns)
        q = self._proj_ns(self.q_ns, hx)
        k_ns = self._proj_ns(self.k_ns, hx)
        v_ns = self._proj_ns(self.v_ns, hx)
        ones = torch.ones((b, n), dtype=torch.bool, device=x_ns.device)
        if k_s is not None:
            k_s = k_s.expand((b,) + k_s.shape[1:]).to(k_ns.dtype)
            v_s = v_s.expand((b,) + v_s.shape[1:]).to(v_ns.dtype)
            k = torch.cat([k_s, k_ns], dim=1)
            v = torch.cat([v_s, v_ns], dim=1)
            key_valid = torch.cat(
                [s_key_valid.expand(b, s_key_valid.shape[1]), ones], dim=1
            )
        else:
            k, v, key_valid = k_ns, v_ns, ones
        bias = (causal_band_mask(n, k.shape[1], device=x_ns.device)[None, None]
                + padding_mask_bias(key_valid))
        x = x_ns + self._o_proj(dot_product_attention(q, k, v, bias))
        return x + self._ffn_ns(self.ffn_norm(x))


class RankingModel(nn.Module):
    def __init__(self, cfg: RankingConfig):
        super().__init__()
        self.config = cfg
        self.tokenizer = UnifiedTokenizer(cfg)
        self.blocks = nn.ModuleList(MixedBlock(cfg) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.embed_dim)
        self.heads = nn.ModuleDict({
            t: nn.ModuleDict({
                "hidden": nn.Linear(cfg.embed_dim, cfg.task_head_hidden),
                "out": nn.Linear(cfg.task_head_hidden, 1),
            })
            for t in cfg.tasks
        })

    def _apply_heads(self, last_token: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-task logits [B], computed in float32."""
        x32 = last_token.float()
        return {
            t: head["out"](gelu(head["hidden"](x32)))[..., 0]
            for t, head in self.heads.items()
        }

    def forward(
        self,
        non_seq: Dict[str, torch.Tensor],
        sequences: Dict[str, torch.Tensor],
        seq_valid: Dict[str, torch.Tensor],
        deterministic: bool = True,
        dummies: Optional[Dict[str, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Full forward -> per-task logits [B]. ``dummies`` routes the
        embedding gradients to per-lookup tensors (sparse updates). With
        ``deterministic=False`` the CPU ``generator`` (the default one when
        None) draws each block's dropout seed."""
        cfg = self.config
        x, valid = self.tokenizer(non_seq, sequences, seq_valid, dummies)
        total = x.shape[1]
        s_len = total - cfg.num_ns_tokens
        seeds = [None] * cfg.num_layers
        if not deterministic and cfg.dropout_rate > 0.0:
            seeds = torch.randint(0, 2**62, (cfg.num_layers,), generator=generator).tolist()
        remat = cfg.use_remat and torch.is_grad_enabled()
        for blk, keep, seed in zip(self.blocks, pyramid_keep_lengths(cfg, total), seeds):
            if remat:
                x = checkpoint(blk.full_call, x, s_len, keep, valid, deterministic,
                               seed, use_reentrant=False)
            else:
                x = blk.full_call(x, s_len, keep, valid, deterministic, seed)
            valid = valid[:, -keep:]
            s_len = keep - cfg.num_ns_tokens
        x = self.final_norm(x)
        return self._apply_heads(x[:, -1])

    # -- KV-cache serving decomposition -----------------------------------
    def encode_s_tokens(
        self, s_tokens: torch.Tensor, s_valid: torch.Tensor
    ) -> List[CacheEntry]:
        """``encode_s`` over precomputed S token vectors."""
        return self._encode_s_trunk(s_tokens, s_valid)

    def encode_s(
        self,
        sequences: Dict[str, torch.Tensor],
        seq_valid: Dict[str, torch.Tensor],
    ) -> List[CacheEntry]:
        """Once per request: run the S trunk and return per-layer
        (k_s, v_s, s_key_valid), the cross-candidate KV cache."""
        cfg = self.config
        if not any(f in sequences for f in cfg.sequence_features):
            # NS-only configs: nothing to cache
            return [None] * cfg.num_layers
        x, valid = self.tokenizer.s_tokens(sequences, seq_valid)
        return self._encode_s_trunk(x, valid)

    def _encode_s_trunk(
        self, x: torch.Tensor, valid: torch.Tensor
    ) -> List[CacheEntry]:
        cfg = self.config
        total = x.shape[1] + cfg.num_ns_tokens
        cache: List[CacheEntry] = []
        for blk, keep in zip(self.blocks, pyramid_keep_lengths(cfg, total)):
            if x is None or x.shape[1] == 0:
                cache.append(None)
                continue
            keep_s = keep - cfg.num_ns_tokens
            y, k_s, v_s = blk.s_call(x, keep_s, valid)
            cache.append((k_s, v_s, valid))
            x = y
            if y is not None:
                valid = valid[:, -keep_s:]
        return cache

    def score_with_cache(
        self,
        cache: List[CacheEntry],
        non_seq: Dict[str, torch.Tensor],
    ) -> Dict[str, torch.Tensor]:
        """Per candidate batch: the NS-only pass over cached S K/V.
        ``non_seq`` holds C candidate rows; the cache batch dim broadcasts."""
        x = self.tokenizer.ns_tokens(non_seq)
        for blk, entry in zip(self.blocks, cache):
            if entry is None:
                x = blk.ns_call(x, None, None, None)
            else:
                x = blk.ns_call(x, *entry)
        x = self.final_norm(x)
        return self._apply_heads(x[:, -1])

    # -- cross-request Δ-append session cache ------------------------------
    #
    # Session state: a refresh cache (``pad_s_cache(encode_s(...))``: per-layer
    # k/v/valid with spare invalid rows) plus per-layer extension buffers
    # ext_k/ext_v [n_layers, 1, SLACK, H, Dh] with one shared count of filled
    # slots. Under the causal mask appended tokens cannot change earlier
    # positions' K/V, so an append is exact with respect to the forward whose
    # per-layer pyramid windows are frozen at the refresh point; without
    # pruning it equals the full forward. The serving engine re-anchors with a
    # fresh ``encode_s`` periodically.

    def embed_sequence_items(self, sf: str, ids: torch.Tensor) -> torch.Tensor:
        """Token vectors of items of one behavior sequence, ids [..., n] ->
        [..., n, d]: the shared item table and projection, per item and
        position-independent, so an append-only cache is exact. ``sf`` names
        the sequence; every sequence shares the table."""
        return self.tokenizer.seq_item_embeds(sf, ids)

    def extend_s_cache(
        self,
        cache: List[CacheEntry],
        ext_k: torch.Tensor,  # [n_layers, 1, SLACK, H, Dh]
        ext_v: torch.Tensor,
        count: int,  # filled extension slots
        x_new: torch.Tensor,  # [1, Db, d] token vectors of the appended items
        new_valid: torch.Tensor,  # [1, Db] bool on the host, valid first
    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """One Δ-append trunk step: each layer's K/V of the new tokens is
        written into ext_k/ext_v at [count : count + Db] IN PLACE, and the
        new count (count + the valid new tokens, counted on the host, so the
        append needs no device-to-host copy) is returned with the buffers.

        Per layer, the new tokens attend over [refresh K/V ; extension ;
        new] at q_offset SLACK + refresh length, and only their layer output
        feeds the next layer. The step stops at a ``None`` cache entry (the
        refresh trunk ended there) and skips q/FFN on the trunk's last layer,
        whose output nothing reads."""
        slack = ext_k.shape[2]
        dev = x_new.device
        ext_valid = (torch.arange(slack, device=dev) < count)[None]  # [1, SLACK]
        n_new = int(new_valid.sum())
        new_valid = new_valid.to(dev)
        db = x_new.shape[1]
        x = x_new
        n_layers = len(self.blocks)
        for i, (blk, entry) in enumerate(zip(self.blocks, cache)):
            if entry is None:
                break
            hx = blk.attn_norm(x)
            k_n = blk._heads(blk._dense(blk.k_s, hx))
            v_n = blk._heads(blk._dense(blk.v_s, hx))
            last = i + 1 >= n_layers or cache[i + 1] is None
            if not last:
                k0, v0, sv0 = entry
                # the concatenation reads the extension before this step
                # writes into it
                k = torch.cat([k0.to(k_n.dtype), ext_k[i].to(k_n.dtype), k_n], 1)
                v = torch.cat([v0.to(v_n.dtype), ext_v[i].to(v_n.dtype), v_n], 1)
                kv_valid = torch.cat([sv0, ext_valid, new_valid], 1)
            ext_k[i, :, count:count + db] = k_n.to(ext_k.dtype)
            ext_v[i, :, count:count + db] = v_n.to(ext_v.dtype)
            if last:
                break
            q = blk._heads(blk._dense(blk.q_s, hx))
            attn = blk._attend(q, k, v, kv_valid, slack + k0.shape[1])
            x = x + blk._o_proj(attn)
            x = x + blk._ffn_s(blk.ffn_norm(x))
        return ext_k, ext_v, count + n_new

    def pad_s_cache(self, cache: List[CacheEntry], pad_rows: int) -> List[CacheEntry]:
        """Append ``pad_rows`` invalid zero rows to every layer's cached K/V:
        the space ``compact_s_cache`` later fills, so a session cache keeps
        one shape from refresh to refresh."""
        out: List[CacheEntry] = []
        for entry in cache:
            if entry is None:
                out.append(None)
                continue
            k0, v0, sv0 = entry
            zk = k0.new_zeros((k0.shape[0], pad_rows) + k0.shape[2:])
            out.append((
                torch.cat([k0, zk], 1),
                torch.cat([v0, zk.to(v0.dtype)], 1),
                torch.cat([sv0, sv0.new_zeros((sv0.shape[0], pad_rows))], 1),
            ))
        return out

    def compact_s_cache(
        self,
        cache: List[CacheEntry],
        ext_k: torch.Tensor,
        ext_v: torch.Tensor,
        count: int,
        level: int,
        pad_rows: int,
    ) -> List[CacheEntry]:
        """Fold the extension buffers into a padded cache (``pad_s_cache``)
        without any trunk recompute: per layer the SLACK extension rows,
        valid below ``count``, are written IN PLACE into the spare rows at
        base length + ``level`` · SLACK. K/V entries are frozen, so this is an
        exact identity on scoring."""
        slack = ext_k.shape[2]
        out: List[CacheEntry] = []
        for i, entry in enumerate(cache):
            if entry is None:
                out.append(None)
                continue
            k0, v0, sv0 = entry
            off = k0.shape[1] - pad_rows + level * slack
            k0[:, off:off + slack] = ext_k[i].to(k0.dtype)
            v0[:, off:off + slack] = ext_v[i].to(v0.dtype)
            sv0[:, off:off + slack] = torch.arange(slack, device=sv0.device) < count
            out.append((k0, v0, sv0))
        return out

    def score_with_cache_ext(
        self,
        cache: List[CacheEntry],
        ext_k: torch.Tensor,
        ext_v: torch.Tensor,
        count: int,
        non_seq: Dict[str, torch.Tensor],
    ) -> Dict[str, torch.Tensor]:
        """``score_with_cache`` over refresh cache and extension: each
        layer's S keys are [refresh K/V ; extension[:count]]. A layer with no
        cache entry has no S stream, and its extension rows are never
        attended."""
        x = self.tokenizer.ns_tokens(non_seq)
        slack = ext_k.shape[2]
        ext_valid = (torch.arange(slack, device=x.device) < count)[None]
        for i, (blk, entry) in enumerate(zip(self.blocks, cache)):
            if entry is None:
                x = blk.ns_call(x, None, None, None)
                continue
            k0, v0, sv0 = entry
            k_s = torch.cat([k0, ext_k[i].to(k0.dtype)], 1)
            v_s = torch.cat([v0, ext_v[i].to(v0.dtype)], 1)
            sv = torch.cat([sv0, ext_valid.expand(sv0.shape[0], slack)], 1)
            x = blk.ns_call(x, k_s, v_s, sv)
        x = self.final_norm(x)
        return self._apply_heads(x[:, -1])

    # -- model card ---------------------------------------------------------
    @staticmethod
    def param_count(params: Dict[str, torch.Tensor]) -> int:
        return sum(int(p.numel()) for p in params.values())

    def get_model_info(self, params: Dict[str, torch.Tensor],
                       s_len: int = 350) -> Dict[str, object]:
        """Parameter counts, dense against embedding (the id tables), and
        the analytic forward FLOPs per sample at ``s_len`` S tokens."""
        from recommend_tpu_torch.evaluation.benchmark import ranking_model_flops

        tables = {f"{name}.weight" for name, m in self.named_modules()
                  if isinstance(m, nn.Embedding)}
        emb = sum(int(p.numel()) for k, p in params.items() if k in tables)
        total = self.param_count(params)
        cfg = self.config
        return {
            "total_params": total,
            "embedding_params": emb,
            "dense_params": total - emb,
            "num_layers": cfg.num_layers,
            "embed_dim": cfg.embed_dim,
            "num_ns_tokens": cfg.num_ns_tokens,
            "pyramid_ratios": list(cfg.pyramid_ratios),
            "forward_gflops_per_sample": round(ranking_model_flops(cfg, s_len) / 1e9, 3),
        }
