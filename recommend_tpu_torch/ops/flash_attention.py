"""Band-masked attention kernels, their autograd Functions and dispatchers.

The counterpart of the JAX package's ``ops/pallas/flash_attention.py``.
Each of its Pallas kernels, forward and backward, has here

- a wrapper named after its CUDA entry point (forward in
  ``csrc/band_attention.cu``: ``band_attn_blocked_fwd``, ``band_attn_bh_fwd``,
  ``band_attn_mh_fwd``, ``band_attn_segkv_fwd``, returning ``(out, lse)``;
  backward in ``csrc/band_attention_bwd.cu``: ``band_attn_blocked_bwd_dq``,
  ``band_attn_blocked_bwd_dkv``, ``band_attn_bh_bwd``, ``band_attn_mh_bwd``,
  ``band_attn_segkv_bwd``, returning the input gradients). Every bf16 call
  runs on the tensor cores, at every head width: the forwards the kernel of
  ``csrc/band_attention_fwd_sm90.cuh``, the backwards the passes of
  ``csrc/band_attention_bwd_sm90.cuh`` (B2dq its dq pass alone, B2dkv its
  dkv pass alone, the others both). Every float32 call runs the CUDA-core
  kernels of the two ``.cu`` files;
- a plain PyTorch version of the same function (``*_plain``), with the same
  rounding points;
- a launch count in ``LAUNCHES``, raised by one at each entry-point call
  and reported in each export of the recorder (``utils/profiling``).

The JAX package's public names (``flash_band_attention`` ...) return ``out``
and carry a gradient through a ``torch.autograd.Function``: its forward
runs the forward wrapper and saves q, k, v, bias, out and lse; its backward
forms delta = rowsum(out * dO) in float32 and runs the backward wrapper(s).

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches the kernel or raises. A forward wrapper returns no gradient on
CUDA, so there it raises when called directly with inputs that need one.

The dispatchers ``flash_attention_bhld`` and ``flash_attention_bhld_segkv``
carry the JAX package's predicates verbatim (``lkv <= FUSED_MAX_KV``,
``dh % 128 == 0``, the VMEM group rule of ``_fused_group_for``), so a shape
reaches the counterpart of the kernel it reaches there.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from recommend_tpu_torch.ops import _build
from recommend_tpu_torch.utils import profiling

NEG_INF = -1e9
FUSED_GROUP = 8  # batch·head rows per grid step of the TPU whole-tile kernels
FUSED_MAX_KV = 1024  # beyond this the TPU whole-tile kernels do not fit VMEM

LAUNCHES = {
    "band_attn_blocked_fwd": 0,
    "band_attn_bh_fwd": 0,
    "band_attn_mh_fwd": 0,
    "band_attn_segkv_fwd": 0,
    "band_attn_blocked_bwd_dq": 0,
    "band_attn_blocked_bwd_dkv": 0,
    "band_attn_bh_bwd": 0,
    "band_attn_mh_bwd": 0,
    "band_attn_segkv_bwd": 0,
}

profiling.register("band_attention_launches", LAUNCHES)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_F, _I, _P]  # sm_scale, dtype code, stream
_SIGNATURES = {
    "band_attn_blocked_fwd": [_P] * 6 + [_I] * 6 + _TAIL,
    "band_attn_bh_fwd": [_P] * 6 + [_I] * 6 + _TAIL,
    "band_attn_mh_fwd": [_P] * 6 + [_I] * 7 + _TAIL,
    "band_attn_segkv_fwd": [_P] * 8 + [_I] * 8 + _TAIL,
    "band_attn_blocked_bwd_dq": [_P] * 8 + [_I] * 6 + _TAIL,
    "band_attn_blocked_bwd_dkv": [_P] * 9 + [_I] * 6 + _TAIL,
    "band_attn_bh_bwd": [_P] * 10 + [_I] * 6 + _TAIL,
    "band_attn_mh_bwd": [_P] * 10 + [_I] * 7 + _TAIL,
    "band_attn_segkv_bwd": [_P] * 14 + [_I] * 8 + _TAIL,
}
# the csrc/<stem>.cu that holds each entry point
LIBRARY = {name: "band_attention_bwd" if "_bwd" in name else "band_attention"
           for name in LAUNCHES}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# head widths the kernels are instantiated for: every multiple of 16 up to
# 128 (BAND_ATTN_FOR_EACH_DH in csrc/band_attention_common.cuh)
_KERNEL_DH = tuple(range(16, 129, 16))


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _logits(q, k, bias, sm_scale, q_offset, causal):
    """[G, H, Lq, Lkv] float32 logits in the kernels' order: the product
    (bf16 products are exact in float32), x sm_scale, + bias, + the band."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s + bias[:, :, None, :]
    if causal:
        lq, lkv = q.shape[2], k.shape[2]
        q_pos = q_offset + torch.arange(lq, device=q.device)
        kv_pos = torch.arange(lkv, device=q.device)
        s = s + torch.where(kv_pos[None, :] <= q_pos[:, None], 0.0, NEG_INF)
    return s


def _band_attention_plain(
    q: torch.Tensor,  # [G, H, Lq, Dh]
    k: torch.Tensor,  # [G, H, Lkv, Dh]
    v: torch.Tensor,
    bias: torch.Tensor,  # [G, 1 or H, Lkv] float32, additive
    sm_scale: float,
    q_offset: int,
    causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What every forward kernel computes, written out: softmax with ``l``
    clamped at 1e-30, p cast to the value dtype before PV."""
    s = _logits(q, k, bias, sm_scale, q_offset, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    return out, lse


def _band_attention_bwd_plain(q, k, v, bias, do, lse, delta, sm_scale, q_offset,
                              causal):
    """What every backward kernel computes, in [G, H, L, Dh] layout (lse and
    delta [G, H, Lq]): p recomputed from lse, p cast to dO's dtype before
    the dV product, dS = p (dp - delta) sm_scale cast to k's dtype before the
    dQ and dK products, float32 accumulation, outputs in the input dtype."""
    s = _logits(q, k, bias, sm_scale, q_offset, causal)
    p = torch.exp(s - lse[..., None])
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * sm_scale).to(k.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def band_attn_blocked_fwd_plain(q, k, v, kv_bias, sm_scale, q_offset, causal):
    out, lse = _band_attention_plain(
        q[:, None], k[:, None], v[:, None], kv_bias[:, None], sm_scale,
        q_offset, causal,
    )
    return out[:, 0], lse[:, 0]


def band_attn_bh_fwd_plain(q, k, v, kv_bias, sm_scale, q_offset, causal):
    return band_attn_blocked_fwd_plain(q, k, v, kv_bias, sm_scale, q_offset, causal)


def band_attn_bh_bwd_plain(q, k, v, kv_bias, do, lse, delta, sm_scale, q_offset,
                           causal):
    """[BH, L, Dh] layout -> (dq, dk, dv)."""
    grads = _band_attention_bwd_plain(
        q[:, None], k[:, None], v[:, None], kv_bias[:, None], do[:, None],
        lse[:, None], delta[:, None], sm_scale, q_offset, causal,
    )
    return tuple(g[:, 0] for g in grads)


def band_attn_blocked_bwd_dq_plain(q, k, v, kv_bias, do, lse, delta, sm_scale,
                                   q_offset, causal):
    return band_attn_bh_bwd_plain(q, k, v, kv_bias, do, lse, delta, sm_scale,
                                  q_offset, causal)[0]


def band_attn_blocked_bwd_dkv_plain(q, k, v, kv_bias, do, lse, delta, sm_scale,
                                    q_offset, causal):
    return band_attn_bh_bwd_plain(q, k, v, kv_bias, do, lse, delta, sm_scale,
                                  q_offset, causal)[1:]


def _heads_first(x: torch.Tensor, h: int) -> torch.Tensor:
    b, l, hd = x.shape
    return x.reshape(b, l, h, hd // h).transpose(1, 2)


def _heads_last(x: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def band_attn_mh_fwd_plain(q, k, v, kv_bias, sm_scale, q_offset, causal, h):
    out, lse = _band_attention_plain(
        _heads_first(q, h), _heads_first(k, h), _heads_first(v, h),
        kv_bias[:, None], sm_scale, q_offset, causal,
    )
    return _heads_last(out), lse


def band_attn_mh_bwd_plain(q, k, v, kv_bias, do, lse, delta, sm_scale, q_offset,
                           causal, h):
    """Model layout, lse and delta [B, H, Lq] -> (dq, dk, dv)."""
    return tuple(_heads_last(g) for g in _band_attention_bwd_plain(
        _heads_first(q, h), _heads_first(k, h), _heads_first(v, h),
        kv_bias[:, None], _heads_first(do, h), lse, delta, sm_scale, q_offset,
        causal,
    ))


def _joined(s_bias, k, v, kns, vns):
    """The [S ; NS] keys, values and bias of the segmented kernels: the NS
    keys sit at positions Ls..Ls+n-1 and are all valid (bias 0, an exact
    addition)."""
    bias = torch.cat([s_bias, s_bias.new_zeros(s_bias.shape[0], kns.shape[1])], 1)
    return torch.cat([k, kns], 1), torch.cat([v, vns], 1), bias


def band_attn_segkv_fwd_plain(q, k, v, kns, vns, s_bias, sm_scale, q_offset,
                              causal, h):
    """One softmax over the joined [S ; NS] keys.

    On a query row with no valid key (every S key at or below its position
    padded, and no NS key in its band) this gives a uniform softmax over its
    padded S keys and every NS key above the band: their -1e9 band mask
    rounds to the padding's -1e9. The kernels skip key tiles wholly above the
    band of a tile's last row, the NS tile among them, so on such rows their
    out and lse differ from this. The model never reads those rows: its
    logits and gradients do not depend on them."""
    kj, vj, bias = _joined(s_bias, k, v, kns, vns)
    return band_attn_mh_fwd_plain(q, kj, vj, bias, sm_scale, q_offset, causal, h)


def band_attn_segkv_bwd_plain(q, k, v, kns, vns, s_bias, do, lse, delta,
                              sm_scale, q_offset, causal, h):
    """Model layout, lse and delta [B, H, Lq] -> (dq, dk, dv, dkns, dvns).

    On a query row with no valid key this recomputes p = 1 for its padded
    S keys and for every NS key above the band as well (both round to lse's
    -1e9), where the kernels skip the key tiles above the band; so with a
    nonzero dO on such a row their gradients differ from this. The model's
    dO there is exactly 0."""
    kj, vj, bias = _joined(s_bias, k, v, kns, vns)
    dq, dkj, dvj = (_heads_last(g) for g in _band_attention_bwd_plain(
        _heads_first(q, h), _heads_first(kj, h), _heads_first(vj, h),
        bias[:, None], _heads_first(do, h), lse, delta, sm_scale, q_offset,
        causal,
    ))
    ls = k.shape[1]
    return dq, dkj[:, :ls], dvj[:, :ls], dkj[:, ls:], dvj[:, ls:]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, same, f32, dh: int) -> bool:
    """Validate the inputs of one wrapper: ``same`` share float32 or
    bfloat16, ``f32`` (bias, lse, delta) are float32, all on one device and
    contiguous. True when they lie on the CPU (plain version), False for
    CUDA (kernel launch)."""
    dev = same[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in (*same, *f32):
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
    if same[0].dtype not in _DTYPE_CODE or any(t.dtype != same[0].dtype for t in same):
        raise TypeError(f"{name}: q/k/v (and dO) must share float32 or bfloat16, "
                        f"got {[t.dtype for t in same]}")
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError(f"{name}: bias/lse/delta must be float32, got "
                        f"{[t.dtype for t in f32]}")
    if not all(t.is_contiguous() for t in (*same, *f32)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if dev.type == "cpu":
        return True
    if dh not in _KERNEL_DH:
        raise ValueError(f"{name}: head dim {dh} not in {_KERNEL_DH}")
    return False


def _check_tma_aligned(name: str, tensors) -> None:
    """Every bf16 call reads and writes its tiles through TMA tensor maps,
    whose base addresses must be 16-byte aligned (row strides, H·Dh·2
    bytes, are multiples of 16 for every Dh in ``_KERNEL_DH``). ``tensors``
    are the ones a map is encoded over: the bf16 inputs and outputs.
    float32 calls run the CUDA-core kernels, which need no alignment."""
    if tensors[0].dtype != torch.bfloat16:
        return
    bad = [i for i, t in enumerate(tensors) if t.data_ptr() % 16]
    if bad:
        raise ValueError(f"{name}: tensors {bad} of the call are not 16-byte aligned")


def _forward_only(name: str, public: str, tensors) -> None:
    """A forward kernel writes into fresh tensors and records no graph: on
    CUDA, inputs that need a gradient go through the public name."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} returns no gradient; call {public}, whose "
                           f"autograd Function carries one")


def _launch(name: str, tensors, ints, sm_scale: float, dtype: torch.dtype):
    lib = _build.load(LIBRARY[name])
    fn = getattr(lib, name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(_P(t.data_ptr()) for t in tensors), *ints, _F(sm_scale),
                _DTYPE_CODE[dtype], _P(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def _bh_shapes(name, q, k, v, kv_bias):
    bh, lq, dh = q.shape
    lkv = k.shape[1]
    if k.shape != (bh, lkv, dh) or v.shape != k.shape or kv_bias.shape != (bh, lkv):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} bias {tuple(kv_bias.shape)}")
    return bh, lq, lkv, dh


def _grad_shapes(name, q, do, lse, delta, stat_shape):
    if do.shape != q.shape or lse.shape != stat_shape or delta.shape != stat_shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} dO {tuple(do.shape)} "
                         f"lse {tuple(lse.shape)} delta {tuple(delta.shape)}, "
                         f"statistics must be {stat_shape}")


def _bh_fwd(name, public, plain, q, k, v, kv_bias, sm_scale, q_offset, causal):
    bh, lq, lkv, dh = _bh_shapes(name, q, k, v, kv_bias)
    if _check(name, (q, k, v), (kv_bias,), dh):
        return plain(q, k, v, kv_bias, sm_scale, q_offset, causal)
    _forward_only(name, public, (q, k, v, kv_bias))
    out = torch.empty_like(q)
    _check_tma_aligned(name, (q, k, v, out))
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    _launch(name, (q, k, v, kv_bias, out, lse),
            (bh, lq, lkv, dh, q_offset, int(causal)), sm_scale, q.dtype)
    return out, lse


def band_attn_blocked_fwd(q, k, v, kv_bias, sm_scale: float, q_offset: int,
                          causal: bool = True):
    """B2f, the blocked online-softmax kernel. q [BH, Lq, Dh], k/v
    [BH, Lkv, Dh], kv_bias [BH, Lkv] float32 -> out [BH, Lq, Dh], lse
    [BH, Lq] float32."""
    return _bh_fwd("band_attn_blocked_fwd", "flash_band_attention",
                   band_attn_blocked_fwd_plain, q, k, v, kv_bias, sm_scale,
                   q_offset, causal)


def band_attn_bh_fwd(q, k, v, kv_bias, sm_scale: float, q_offset: int,
                     causal: bool = True):
    """B4f, the whole-tile kernel in [BH, L, Dh] layout; shapes as
    ``band_attn_blocked_fwd``. On the tensor cores for bf16 (every bf16
    tensor 16-byte aligned), on the CUDA cores for float32."""
    return _bh_fwd("band_attn_bh_fwd", "fused_band_attention",
                   band_attn_bh_fwd_plain, q, k, v, kv_bias, sm_scale,
                   q_offset, causal)


def _bh_bwd(name, q, k, v, kv_bias, do, lse, delta):
    """Validate a [BH, L, Dh] backward call -> (plain?, ints for the C call)."""
    bh, lq, lkv, dh = _bh_shapes(name, q, k, v, kv_bias)
    _grad_shapes(name, q, do, lse, delta, (bh, lq))
    return _check(name, (q, k, v, do), (kv_bias, lse, delta), dh), (bh, lq, lkv, dh)


def band_attn_blocked_bwd_dq(q, k, v, kv_bias, do, lse, delta, sm_scale: float,
                             q_offset: int, causal: bool = True):
    """B2dq: dq of the blocked kernel. Forward inputs as
    ``band_attn_blocked_fwd``, do [BH, Lq, Dh] in q's dtype, lse and delta
    [BH, Lq] float32 -> dq [BH, Lq, Dh]. On the tensor cores for bf16
    (every bf16 tensor 16-byte aligned), on the CUDA cores for float32."""
    name = "band_attn_blocked_bwd_dq"
    plain, dims = _bh_bwd(name, q, k, v, kv_bias, do, lse, delta)
    if plain:
        return band_attn_blocked_bwd_dq_plain(q, k, v, kv_bias, do, lse, delta,
                                              sm_scale, q_offset, causal)
    dq = torch.empty_like(q)
    _check_tma_aligned(name, (q, k, v, do, dq))
    _launch(name, (q, k, v, kv_bias, do, lse, delta, dq),
            (*dims, q_offset, int(causal)), sm_scale, q.dtype)
    return dq


def band_attn_blocked_bwd_dkv(q, k, v, kv_bias, do, lse, delta, sm_scale: float,
                              q_offset: int, causal: bool = True):
    """B2dkv: (dk, dv) of the blocked kernel; inputs as
    ``band_attn_blocked_bwd_dq``, and as there on the tensor cores for
    bf16 and on the CUDA cores for float32."""
    name = "band_attn_blocked_bwd_dkv"
    plain, dims = _bh_bwd(name, q, k, v, kv_bias, do, lse, delta)
    if plain:
        return band_attn_blocked_bwd_dkv_plain(q, k, v, kv_bias, do, lse, delta,
                                               sm_scale, q_offset, causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _check_tma_aligned(name, (q, k, v, do, dk, dv))
    _launch(name, (q, k, v, kv_bias, do, lse, delta, dk, dv),
            (*dims, q_offset, int(causal)), sm_scale, q.dtype)
    return dk, dv


def band_attn_bh_bwd(q, k, v, kv_bias, do, lse, delta, sm_scale: float,
                     q_offset: int, causal: bool = True):
    """B4b: (dq, dk, dv) of the whole-tile [BH, L, Dh] kernel; inputs as
    ``band_attn_blocked_bwd_dq``. One call runs the dq and the dkv pass, as
    there on the tensor cores for bf16 and on the CUDA cores for float32."""
    name = "band_attn_bh_bwd"
    plain, dims = _bh_bwd(name, q, k, v, kv_bias, do, lse, delta)
    if plain:
        return band_attn_bh_bwd_plain(q, k, v, kv_bias, do, lse, delta,
                                      sm_scale, q_offset, causal)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _check_tma_aligned(name, (q, k, v, do, dq, dk, dv))
    _launch(name, (q, k, v, kv_bias, do, lse, delta, dq, dk, dv),
            (*dims, q_offset, int(causal)), sm_scale, q.dtype)
    return dq, dk, dv


def _mh_shapes(name, q, k, v, kv_bias, h):
    b, lq, hdh = q.shape
    lkv = k.shape[1]
    if (hdh % h or k.shape != (b, lkv, hdh) or v.shape != k.shape
            or kv_bias.shape != (b, lkv)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} bias {tuple(kv_bias.shape)} h {h}")
    return b, lq, lkv, hdh // h


def band_attn_mh_fwd(q, k, v, kv_bias, sm_scale: float, q_offset: int,
                     causal: bool = True, h: int = 1):
    """B3f, the whole-tile kernel in model layout. q [B, Lq, H·Dh], k/v
    [B, Lkv, H·Dh], kv_bias [B, Lkv] float32 shared by the heads ->
    out [B, Lq, H·Dh], lse [B, H, Lq] float32."""
    name = "band_attn_mh_fwd"
    b, lq, lkv, dh = _mh_shapes(name, q, k, v, kv_bias, h)
    if _check(name, (q, k, v), (kv_bias,), dh):
        return band_attn_mh_fwd_plain(q, k, v, kv_bias, sm_scale, q_offset,
                                      causal, h)
    _forward_only(name, "fused_mh_band_attention", (q, k, v))
    out = torch.empty_like(q)
    _check_tma_aligned(name, (q, k, v, out))
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _launch(name, (q, k, v, kv_bias, out, lse),
            (b, h, lq, lkv, dh, q_offset, int(causal)), sm_scale, q.dtype)
    return out, lse


def band_attn_mh_bwd(q, k, v, kv_bias, do, lse, delta, sm_scale: float,
                     q_offset: int, causal: bool = True, h: int = 1):
    """B3b: (dq, dk, dv) of the model-layout kernel. Forward inputs as
    ``band_attn_mh_fwd``, do [B, Lq, H·Dh] in q's dtype, lse and delta
    [B, H, Lq] float32. One call runs the dq and the dkv pass: on the
    tensor cores for bf16 (every bf16 tensor 16-byte aligned), on the CUDA
    cores for float32."""
    name = "band_attn_mh_bwd"
    b, lq, lkv, dh = _mh_shapes(name, q, k, v, kv_bias, h)
    _grad_shapes(name, q, do, lse, delta, (b, h, lq))
    if _check(name, (q, k, v, do), (kv_bias, lse, delta), dh):
        return band_attn_mh_bwd_plain(q, k, v, kv_bias, do, lse, delta,
                                      sm_scale, q_offset, causal, h)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _check_tma_aligned(name, (q, k, v, do, dq, dk, dv))
    _launch(name, (q, k, v, kv_bias, do, lse, delta, dq, dk, dv),
            (b, h, lq, lkv, dh, q_offset, int(causal)), sm_scale, q.dtype)
    return dq, dk, dv


def _seg_shapes(name, q, k, v, kns, vns, s_bias, h):
    b, lq, ls, dh = _mh_shapes(name, q, k, v, s_bias, h)
    n = kns.shape[1]
    if kns.shape != (b, n, h * dh) or vns.shape != kns.shape:
        raise ValueError(f"{name}: NS shapes {tuple(kns.shape)} {tuple(vns.shape)}")
    return b, lq, ls, n, dh


def band_attn_segkv_fwd(q, k, v, kns, vns, s_bias, sm_scale: float,
                        q_offset: int, causal: bool = True, h: int = 1):
    """B1f, the segmented-KV kernel. q [B, Lq, H·Dh]; S keys/values
    [B, Ls, H·Dh] with s_bias [B, Ls] at positions 0..Ls-1; NS keys/values
    [B, n, H·Dh], all valid, at positions Ls..Ls+n-1 -> out [B, Lq, H·Dh],
    lse [B, H, Lq] float32. On the tensor cores for bf16 (every bf16 tensor
    16-byte aligned), on the CUDA cores for float32."""
    name = "band_attn_segkv_fwd"
    b, lq, ls, n, dh = _seg_shapes(name, q, k, v, kns, vns, s_bias, h)
    if _check(name, (q, k, v, kns, vns), (s_bias,), dh):
        return band_attn_segkv_fwd_plain(q, k, v, kns, vns, s_bias, sm_scale,
                                         q_offset, causal, h)
    _forward_only(name, "fused_mhseg_band_attention", (q, k, v, kns, vns))
    out = torch.empty_like(q)
    _check_tma_aligned(name, (q, k, v, kns, vns, out))
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _launch(name, (q, k, v, kns, vns, s_bias, out, lse),
            (b, h, lq, ls, n, dh, q_offset, int(causal)), sm_scale, q.dtype)
    return out, lse


def band_attn_segkv_bwd(q, k, v, kns, vns, s_bias, do, lse, delta,
                        sm_scale: float, q_offset: int, causal: bool = True,
                        h: int = 1):
    """B1b: (dq, dk, dv, dkns, dvns) of the segmented-KV kernel. Forward
    inputs as ``band_attn_segkv_fwd``, do [B, Lq, H·Dh] in q's dtype, lse
    and delta [B, H, Lq] float32. The S and NS key gradients come back as
    separate tensors; one call runs the dq and the dkv pass: on the tensor
    cores for bf16 (every bf16 tensor 16-byte aligned), on the CUDA cores
    for float32."""
    name = "band_attn_segkv_bwd"
    b, lq, ls, n, dh = _seg_shapes(name, q, k, v, kns, vns, s_bias, h)
    _grad_shapes(name, q, do, lse, delta, (b, h, lq))
    if _check(name, (q, k, v, kns, vns, do), (s_bias, lse, delta), dh):
        return band_attn_segkv_bwd_plain(q, k, v, kns, vns, s_bias, do, lse,
                                         delta, sm_scale, q_offset, causal, h)
    grads = tuple(torch.empty_like(t) for t in (q, k, v, kns, vns))
    _check_tma_aligned(name, (q, k, v, kns, vns, do, *grads))
    _launch(name, (q, k, v, kns, vns, s_bias, do, lse, delta, *grads),
            (b, h, lq, ls, n, dh, q_offset, int(causal)), sm_scale, q.dtype)
    return grads


# ---------------------------------------------------------------------------
# Autograd Functions and the JAX package's public names
# ---------------------------------------------------------------------------


def _delta(out: torch.Tensor, do: torch.Tensor, h: int = 0) -> torch.Tensor:
    """rowsum(out * dO) in float32: [BH, Lq] for the [BH, L, Dh] layout, or
    [B, H, Lq] for the model layout with ``h`` heads."""
    prod = out.float() * do.float()
    if not h:
        return prod.sum(-1)
    b, lq, hd = out.shape
    return prod.reshape(b, lq, h, hd // h).sum(-1).transpose(1, 2).contiguous()


class _BlockedAttention(torch.autograd.Function):
    """flash_band_attention: B2f forward, B2dq + B2dkv backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_bias, sm_scale, q_offset, causal):
        out, lse = band_attn_blocked_fwd(q, k, v, kv_bias, sm_scale, q_offset, causal)
        ctx.save_for_backward(q, k, v, kv_bias, out, lse)
        ctx.args = (sm_scale, q_offset, causal)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_bias, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = _delta(out, do)
        dq = band_attn_blocked_bwd_dq(q, k, v, kv_bias, do, lse, delta, *ctx.args)
        dk, dv = band_attn_blocked_bwd_dkv(q, k, v, kv_bias, do, lse, delta,
                                           *ctx.args)
        return dq, dk, dv, None, None, None, None


class _WholeTileAttention(torch.autograd.Function):
    """fused_band_attention: B4f forward, B4b backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_bias, sm_scale, q_offset, causal):
        out, lse = band_attn_bh_fwd(q, k, v, kv_bias, sm_scale, q_offset, causal)
        ctx.save_for_backward(q, k, v, kv_bias, out, lse)
        ctx.args = (sm_scale, q_offset, causal)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_bias, out, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = band_attn_bh_bwd(q, k, v, kv_bias, do, lse, _delta(out, do),
                                      *ctx.args)
        return dq, dk, dv, None, None, None, None


class _ModelLayoutAttention(torch.autograd.Function):
    """fused_mh_band_attention: B3f forward, B3b backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_bias, sm_scale, q_offset, causal, h):
        out, lse = band_attn_mh_fwd(q, k, v, kv_bias, sm_scale, q_offset, causal, h)
        ctx.save_for_backward(q, k, v, kv_bias, out, lse)
        ctx.args = (sm_scale, q_offset, causal, h)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_bias, out, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = band_attn_mh_bwd(q, k, v, kv_bias, do, lse,
                                      _delta(out, do, ctx.args[-1]), *ctx.args)
        return dq, dk, dv, None, None, None, None, None


class _SegmentedAttention(torch.autograd.Function):
    """fused_mhseg_band_attention: B1f forward, B1b backward."""

    @staticmethod
    def forward(ctx, q, k, v, kns, vns, s_bias, sm_scale, q_offset, causal, h):
        out, lse = band_attn_segkv_fwd(q, k, v, kns, vns, s_bias, sm_scale,
                                       q_offset, causal, h)
        ctx.save_for_backward(q, k, v, kns, vns, s_bias, out, lse)
        ctx.args = (sm_scale, q_offset, causal, h)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kns, vns, s_bias, out, lse = ctx.saved_tensors
        do = do.contiguous()
        grads = band_attn_segkv_bwd(q, k, v, kns, vns, s_bias, do, lse,
                                    _delta(out, do, ctx.args[-1]), *ctx.args)
        return (*grads, None, None, None, None, None)


def flash_band_attention(q, k, v, kv_bias, sm_scale, q_offset, causal=True):
    return _BlockedAttention.apply(q, k, v, kv_bias, sm_scale, q_offset, causal)


def fused_band_attention(q, k, v, kv_bias, sm_scale, q_offset, causal=True):
    return _WholeTileAttention.apply(q, k, v, kv_bias, sm_scale, q_offset, causal)


def fused_mh_band_attention(q, k, v, kv_bias, sm_scale, q_offset, causal=True,
                            h=1):
    return _ModelLayoutAttention.apply(q, k, v, kv_bias, sm_scale, q_offset,
                                       causal, h)


def fused_mhseg_band_attention(q, k, v, kns, vns, s_bias, sm_scale, q_offset,
                               causal=True, h=1):
    return _SegmentedAttention.apply(q, k, v, kns, vns, s_bias, sm_scale,
                                     q_offset, causal, h)


# ---------------------------------------------------------------------------
# Dispatch (predicates of the JAX package, verbatim)
# ---------------------------------------------------------------------------


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _fused_group_for(h: int, lq: int, lkv: int) -> int:
    """The TPU rule: largest grid group whose backward fits a 13 MB VMEM
    budget, 0 when one row alone does not. Only its ``>= 1`` test is used
    here, to route a shape as the JAX package routes it."""
    lq_p = _round_up(lq, 16)
    lkv_p = _round_up(lkv, 128) + 128  # + NS segment / slack
    per_row = lq_p * lkv_p * 4 * 8
    g = max(1, FUSED_GROUP // h)
    while g > 1 and g * per_row > 13 * 2**20:
        g //= 2
    if g == 1 and per_row > 13 * 2**20:
        return 0
    return g


def _bias(valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, 0.0, NEG_INF).float()


def _model_layout(x: torch.Tensor) -> torch.Tensor:
    """[B, L, H, Dh] -> contiguous [B, L, H·Dh] (a view when it can be)."""
    b, l, h, dh = x.shape
    return x.reshape(b, l, h * dh).contiguous()


def flash_attention_bhld_segkv(
    q: torch.Tensor,    # [B, Lq, H, Dh] tail queries over the combined stream
    k_s: torch.Tensor,  # [B, Ls, H, Dh] S-segment keys
    v_s: torch.Tensor,
    k_ns: torch.Tensor,  # [B, n, H, Dh] NS-segment keys (all valid)
    v_ns: torch.Tensor,
    s_valid: torch.Tensor,  # [B, Ls] bool
    q_offset: int,
    causal: bool = True,
) -> torch.Tensor:
    """Segmented-KV model-layout attention; concatenates the segments and
    takes ``flash_attention_bhld`` when the segmented kernel does not apply."""
    b, lq, h, dh = q.shape
    ls, n = k_s.shape[1], k_ns.shape[1]
    sm_scale = 1.0 / float(dh) ** 0.5
    g = _fused_group_for(h, lq, ls + n)
    if ls + n <= FUSED_MAX_KV and dh % 128 == 0 and g >= 1:
        out = fused_mhseg_band_attention(
            _model_layout(q), _model_layout(k_s), _model_layout(v_s),
            _model_layout(k_ns), _model_layout(v_ns), _bias(s_valid),
            sm_scale, q_offset, causal, h,
        )
        return out.reshape(b, lq, h, dh).to(q.dtype)
    kv_valid = torch.cat(
        [s_valid, torch.ones((b, n), dtype=torch.bool, device=s_valid.device)], 1
    )
    return flash_attention_bhld(
        q, torch.cat([k_s, k_ns], 1), torch.cat([v_s, v_ns], 1), kv_valid,
        q_offset, causal,
    )


def flash_attention_bhld(
    q: torch.Tensor,  # [B, Lq, H, Dh]  (model layout)
    k: torch.Tensor,  # [B, Lkv, H, Dh]
    v: torch.Tensor,
    kv_valid: torch.Tensor,  # [B, Lkv] bool
    q_offset: int,
    causal: bool = True,
) -> torch.Tensor:
    """Model-layout band attention: the model-layout whole-tile kernel when
    Dh % 128 == 0 and the kv fits, the [B·H, L, Dh] whole-tile kernel for
    other head widths, and the blocked kernel for long streams."""
    b, lq, h, dh = q.shape
    lkv = k.shape[1]
    sm_scale = 1.0 / float(dh) ** 0.5
    bias1 = _bias(kv_valid)  # [B, Lkv]

    g = _fused_group_for(h, lq, lkv)
    if lkv <= FUSED_MAX_KV and dh % 128 == 0 and g >= 1:
        out = fused_mh_band_attention(
            _model_layout(q), _model_layout(k), _model_layout(v), bias1,
            sm_scale, q_offset, causal, h,
        )
        return out.reshape(b, lq, h, dh).to(q.dtype)

    bias = bias1[:, None, :].expand(b, h, lkv).reshape(b * h, lkv).contiguous()

    def to_bh(x: torch.Tensor) -> torch.Tensor:
        return x.transpose(1, 2).reshape(b * h, x.shape[1], dh).contiguous()

    def from_bh(out: torch.Tensor) -> torch.Tensor:
        return out.reshape(b, h, lq, dh).transpose(1, 2).to(q.dtype)

    # bh layout: one head per row, so the budget is taken at h=1
    if lkv <= FUSED_MAX_KV and _fused_group_for(1, lq, lkv) >= 1:
        return from_bh(fused_band_attention(
            to_bh(q), to_bh(k), to_bh(v), bias, sm_scale, q_offset, causal))
    return from_bh(flash_band_attention(
        to_bh(q), to_bh(k), to_bh(v), bias, sm_scale, q_offset, causal))
