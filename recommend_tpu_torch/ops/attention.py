"""Plain attention: additive masks, the reference softmax attention and the
retrieval tower's multi-head attention layer.

Masks are additive and finite (-1e9), so a query whose keys are all masked
degrades to a uniform softmax rather than NaN. Logits and softmax run in
float32; the probabilities are cast to the value dtype before the PV product;
the output is in the query dtype.

The tower's masks (the interleaved causal mask, the single-prediction masks,
the group encoders' padding) come factored, as a ``FactoredBias``: a
structure over positions [Lq, Lkv] shared by every example and head, plus a
key bias over examples [B, Lkv]. ``MultiHeadAttention`` runs such a mask

- on a CPU tensor, through ``dot_product_attention`` on the parts' sum, the
  same dense bias the tower built before the parts were kept apart, bit for
  bit;
- on a CUDA tensor, through the two hand-written kernels of
  ``csrc/tower_attention.cu``: ``tower_attn_fwd`` (T1f) and, behind a
  ``torch.autograd.Function``, ``tower_attn_bwd`` (T1b). They read Q, K and
  V in the projections' [B, L, H·Dh] layout and keep the logits and
  probabilities on chip; bfloat16 on the tensor cores, float32 on the CUDA
  cores, head widths 16 and 32, at most ``TOWER_MAX_LEN`` queries and keys.
  Anything else raises: there is no fallback to the plain path on CUDA.

A dense bias (``_position_bias``, which varies by example and query, and any
caller's own tensor) takes ``dot_product_attention`` on every device; on a
card ``LAUNCHES["tower_attn_plain"]`` counts such calls. ``LAUNCHES`` is
reported in each export of the recorder (``utils/profiling``). The wrappers
and their ctypes launches live in this file, so a trace credits the kernels'
time to it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from recommend_tpu_torch.models.tokenizer import dense
from recommend_tpu_torch.ops import _build
from recommend_tpu_torch.utils import profiling

NEG_INF = -1e9  # large-negative mask value, safe in bf16/f32

LAUNCHES = {"tower_attn_fwd": 0, "tower_attn_bwd": 0, "tower_attn_plain": 0}

profiling.register("tower_attention_launches", LAUNCHES)

LIBRARY = "tower_attention"  # csrc/tower_attention.cu
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, sbias, kbias, tiles, o, stats; batch, heads, lq, lkv, dh;
    # scale, dtype code, stream
    "tower_attn_fwd": [_P] * 8 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, dout, stats, sbias, kbias, tiles, dq, dk, dv; the same
    "tower_attn_bwd": [_P] * 11 + [_I] * 5 + [_F, _I, _P],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TOWER_HEAD_DIMS = (16, 32)
TOWER_MAX_LEN = 512  # queries and keys a block keeps in shared memory
TOWER_TILE = 16  # queries and keys a tile of the kernels' tile map


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def causal_band_mask(
    q_len: int,
    kv_len: int,
    q_offset: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """[Lq, Lkv] additive causal mask for queries at the tail of the keys.

    Query i sits at absolute position ``q_offset + i`` (default
    ``kv_len - q_len``) and may attend to key positions <= its own.
    """
    if q_offset is None:
        q_offset = kv_len - q_len
    q_pos = torch.arange(q_len, device=device) + q_offset
    kv_pos = torch.arange(kv_len, device=device)
    allowed = kv_pos[None, :] <= q_pos[:, None]
    return torch.where(allowed, 0.0, NEG_INF).float()


def padding_mask_bias(kv_valid: torch.Tensor) -> torch.Tensor:
    """[B, Lkv] boolean validity -> [B, 1, 1, Lkv] additive bias."""
    return torch.where(kv_valid[:, None, None, :], 0.0, NEG_INF).float()


def tile_classes(structure: torch.Tensor) -> torch.Tensor:
    """The kernels' tile map of a [Lq, Lkv] structure bias: int8
    [ceil(Lq/16), ceil(Lkv/16)], per 16 × 16 tile 0 where every entry is at
    or below NEG_INF / 2 (the tile is skipped), 1 where every entry is 0 (the
    bias is not read), 2 otherwise. Entries past Lq or Lkv count as neither."""
    lq, lkv = structure.shape
    nq, nk = -(-lq // TOWER_TILE), -(-lkv // TOWER_TILE)
    pad = (0, nk * TOWER_TILE - lkv, 0, nq * TOWER_TILE - lq)

    def tiles(fill):
        return F.pad(structure, pad, value=fill).reshape(nq, TOWER_TILE, nk, TOWER_TILE)

    masked = (tiles(NEG_INF) <= NEG_INF / 2).all(dim=3).all(dim=1)
    zero = (tiles(0.0) == 0).all(dim=3).all(dim=1)
    return torch.where(masked, 0, torch.where(zero, 1, 2)).to(torch.int8)


class FactoredBias(NamedTuple):
    """An additive mask as ``structure[i, j] + key[b, j]``: ``structure``
    [Lq, Lkv] float32 shared by every example and head, with its tile map
    ``tiles`` (``tile_classes``), and ``key`` [B, Lkv] float32. A part that is
    None is zero. Both hold 0 and NEG_INF alone."""
    structure: Optional[torch.Tensor]
    key: Optional[torch.Tensor]
    tiles: Optional[torch.Tensor] = None

    def dense(self) -> Optional[torch.Tensor]:
        """The parts' sum, broadcastable to [B, 1, Lq, Lkv] (None if both
        are None)."""
        key = None if self.key is None else self.key[:, None, None, :]
        if self.structure is None:
            return key
        structure = self.structure[None, None]
        return structure if key is None else structure + key


def factored_bias(structure: Optional[torch.Tensor],
                  key: Optional[torch.Tensor]) -> FactoredBias:
    """``FactoredBias`` with the structure's tile map."""
    return FactoredBias(structure, key, None if structure is None else tile_classes(structure))


def dot_product_attention(
    q: torch.Tensor,  # [B, Lq, H, Dh]
    k: torch.Tensor,  # [B, Lkv, H, Dh]
    v: torch.Tensor,  # [B, Lkv, H, Dh]
    bias: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Lq, Lkv]
) -> torch.Tensor:
    """Reference attention. Softmax in float32; output in q.dtype.

    Products of bf16 values are exact in float32, so upcasting the operands
    and multiplying in float32 is the bf16 product with float32
    accumulation.
    """
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1])))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# The tower's kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(_build.load(LIBRARY), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return _P(None if t is None else t.data_ptr())


def _launch(name: str, dev: torch.device, tensors, ints, scale: float, code: int) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn(name)(*(_ptr(t) for t in tensors), *ints, _F(scale), code, _P(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


@functools.lru_cache(maxsize=None)
def _scale(dh: int) -> float:
    """1/sqrt(Dh) as ``dot_product_attention`` computes it, in float32."""
    return float(1.0 / torch.sqrt(torch.tensor(float(dh))))


def _check(name: str, q, k, v, structure, key, tiles, heads: int) -> Tuple[int, int, int, int]:
    """A call's inputs: q [B, Lq, H·Dh], k and v [B, Lkv, H·Dh], one dtype
    (float32 or bfloat16), Dh 16 or 32, 1 <= Lq, Lkv <= TOWER_MAX_LEN; the
    mask's parts float32 [Lq, Lkv] (with its int8 tile map) and [B, Lkv]; all
    on one card. Returns (B, Lq, Lkv, Dh)."""
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: {q.dtype}, {k.dtype}, {v.dtype} inputs; the kernels take "
                        "one of float32 or bfloat16")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2] or heads < 1 or q.shape[2] % heads:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"with {heads} heads")
    b, lq, width = q.shape
    lkv, dh = k.shape[1], width // heads
    if dh not in TOWER_HEAD_DIMS:
        raise ValueError(f"{name}: head width {dh}; the kernels take {TOWER_HEAD_DIMS}")
    if not (1 <= lq <= TOWER_MAX_LEN and 1 <= lkv <= TOWER_MAX_LEN):
        raise ValueError(f"{name}: {lq} queries, {lkv} keys; the kernels take 1 to "
                         f"{TOWER_MAX_LEN}")
    if (structure is None) != (tiles is None):
        raise ValueError(f"{name}: a structure bias comes with its tile map")
    if structure is not None and (structure.shape != (lq, lkv)
                                  or structure.dtype != torch.float32):
        raise ValueError(f"{name}: structure {tuple(structure.shape)} {structure.dtype}")
    if tiles is not None and (tiles.shape != (-(-lq // TOWER_TILE), -(-lkv // TOWER_TILE))
                              or tiles.dtype != torch.int8):
        raise ValueError(f"{name}: tile map {tuple(tiles.shape)} {tiles.dtype}")
    if key is not None and (key.shape != (b, lkv) or key.dtype != torch.float32):
        raise ValueError(f"{name}: key bias {tuple(key.shape)} {key.dtype}")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    for t in (k, v, structure, key, tiles):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name}: inputs on {t.device} and {q.device}")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: an input not 16-byte aligned")
    return b, lq, lkv, dh


def tower_attn_fwd(q, k, v, structure, key, tiles, heads: int,
                   with_stats: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """T1f on CUDA tensors: (o [B, Lq, H·Dh] in q's dtype, stats
    [B, H, Lq, 2] float32 when ``with_stats`` else None: each row's max
    logit and sum of exp(logit - max), what the backward rebuilds the
    probabilities from). Non-contiguous inputs are copied here first."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    structure, key, tiles = (None if t is None else t.contiguous() for t in (structure, key, tiles))
    b, lq, lkv, dh = _check("tower_attn_fwd", q, k, v, structure, key, tiles, heads)
    o = torch.empty_like(q)
    stats = (torch.empty((b, heads, lq, 2), dtype=torch.float32, device=q.device)
             if with_stats else None)
    _launch("tower_attn_fwd", q.device, (q, k, v, structure, key, tiles, o, stats),
            (b, heads, lq, lkv, dh), _scale(dh), _DTYPE_CODE[q.dtype])
    return o, stats


def tower_attn_bwd(q, k, v, dout, stats, structure, key, tiles,
                   heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """T1b on CUDA tensors: (dq, dk, dv) in the inputs' dtype and layout."""
    q, k, v, dout, stats = (t.contiguous() for t in (q, k, v, dout, stats))
    structure, key, tiles = (None if t is None else t.contiguous() for t in (structure, key, tiles))
    b, lq, lkv, dh = _check("tower_attn_bwd", q, k, v, structure, key, tiles, heads)
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"tower_attn_bwd: dout {tuple(dout.shape)} {dout.dtype} against q "
                         f"{tuple(q.shape)} {q.dtype}")
    if stats.shape != (b, heads, lq, 2) or stats.dtype != torch.float32 \
            or stats.device != q.device:
        raise ValueError(f"tower_attn_bwd: stats {tuple(stats.shape)} {stats.dtype}")
    if dout.data_ptr() % 16:
        raise ValueError("tower_attn_bwd: dout not 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch("tower_attn_bwd", q.device,
            (q, k, v, dout, stats, structure, key, tiles, dq, dk, dv),
            (b, heads, lq, lkv, dh), _scale(dh), _DTYPE_CODE[q.dtype])
    return dq, dk, dv


class _TowerAttentionFunction(torch.autograd.Function):
    """T1f forward (with its row statistics), T1b backward; saves q, k, v,
    the mask's parts and the statistics (no [L, L] tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, structure, key, tiles, heads):
        o, stats = tower_attn_fwd(q, k, v, structure, key, tiles, heads, with_stats=True)
        ctx.save_for_backward(q, k, v, structure, key, tiles, stats)
        ctx.heads = heads
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, structure, key, tiles, stats = ctx.saved_tensors
        dq, dk, dv = tower_attn_bwd(q, k, v, dout, stats, structure, key, tiles, ctx.heads)
        return dq, dk, dv, None, None, None, None


def tower_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: FactoredBias,
                    heads: int) -> torch.Tensor:
    """Attention of [B, L, H·Dh] q, k, v under a factored mask on a card:
    the kernels, through the autograd Function where a gradient is needed,
    else the forward alone with no statistics written. Returns [B, Lq, H·Dh]."""
    parts = (bias.structure, bias.key, bias.tiles)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _TowerAttentionFunction.apply(q, k, v, *parts, heads)
    return tower_attn_fwd(q, k, v, *parts, heads, with_stats=False)[0]


class MultiHeadAttention(nn.Module):
    """Shared-weight MHA with separate query/key-value inputs (the retrieval
    tower's and the compression encoder's). ``x_q`` and ``x_kv`` may differ
    in length. Flax's ``DenseGeneral((h, dh))`` kernels [D, H, Dh] and the
    output kernel [H, Dh, D] are stored flattened as ``nn.Linear`` weights;
    every projection runs in the input's dtype. A ``FactoredBias`` on a card
    runs the tower's kernels; a dense bias, or any bias on the CPU, the plain
    ``dot_product_attention``."""

    def __init__(self, num_heads: int, embed_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.o_proj = nn.Linear(embed_dim, embed_dim)

    def forward(
        self,
        x_q: torch.Tensor,  # [B, Lq, D]
        x_kv: Optional[torch.Tensor] = None,  # [B, Lkv, D]
        bias=None,  # FactoredBias, or a tensor broadcastable to [B, H, Lq, Lkv]
    ) -> torch.Tensor:
        if x_kv is None:
            x_kv = x_q
        dt = x_q.dtype
        q, k, v = (dense(layer, x, dt) for layer, x in
                   ((self.q_proj, x_q), (self.k_proj, x_kv), (self.v_proj, x_kv)))
        on_card = q.device.type != "cpu"
        if isinstance(bias, FactoredBias):
            if on_card:
                return dense(self.o_proj, tower_attention(q, k, v, bias, self.num_heads), dt)
            bias = bias.dense()
        elif on_card:
            LAUNCHES["tower_attn_plain"] += 1

        def heads(y):
            return y.reshape(*y.shape[:-1], self.num_heads, -1)

        out = dot_product_attention(heads(q), heads(k), heads(v), bias)
        return dense(self.o_proj, out.flatten(-2), dt)
