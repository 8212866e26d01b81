"""RMSNorm with float32 statistics (oneTrans model.py:11-23).

``RMSNorm`` computes y = x * rsqrt(mean(x^2) + eps) * scale with its
statistics in float32 whatever the input dtype, and casts the result back.
It runs

- on a CPU tensor, the plain version ``rms_norm_plain``: the float32 chain
  the JAX package writes (``recommend_tpu/ops/normalization.py``), each step
  an eager PyTorch operation, differentiated by autograd;
- on a CUDA tensor, the two hand-written kernels of ``csrc/rmsnorm.cu``:
  ``rmsnorm_fwd`` (R1f: one read of x, one write of y, and the row's
  ``rstd`` when a gradient is needed) and, behind a
  ``torch.autograd.Function``, ``rmsnorm_bwd`` (R1b: one read of x and dy,
  one write of dx, and per-block partial sums for dscale) then
  ``rmsnorm_dscale`` (the partials summed in a fixed order: no atomics).
  float32 and bfloat16 inputs; any other dtype raises. There is no fallback
  to the plain chain on CUDA.

``rms_norm_backward_plain`` writes out the backward the kernels compute,
for the tests and ``chip_smoke.py``. ``LAUNCHES`` counts each kernel's
launches and is reported in each export of the recorder
(``utils/profiling``). The wrappers and their ctypes launches live in this
file, so a trace credits the kernels' time to it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch import nn

from recommend_tpu_torch.ops import _build
from recommend_tpu_torch.utils import profiling

LAUNCHES = {"rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "rmsnorm_dscale": 0}

profiling.register("rmsnorm_launches", LAUNCHES)

LIBRARY = "rmsnorm"  # csrc/rmsnorm.cu
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, w, y, rstd; rows, d, eps, dtype code, stream
    "rmsnorm_fwd": [_P] * 4 + [_I, _I, _F, _I, _P],
    # x, dy, rstd, w, dx, partials; rows, d, grid, dtype code, stream
    "rmsnorm_bwd": [_P] * 6 + [_I] * 4 + [_P],
    # partials, dscale; grid, d, stream
    "rmsnorm_dscale": [_P] * 2 + [_I] * 2 + [_P],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the widest row the backward's general path (any width but the vector
# path's 64, 128, 256, 384 and 512) keeps in shared memory
GENERAL_MAX_D = 3072
# blocks an SM of the persistent backward (__launch_bounds__(256, 2)), and
# the fewest rows a block is given
_BWD_BLOCKS_PER_SM = 2
_BWD_MIN_ROWS_PER_BLOCK = 8


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or float64 for a float64 input (the tests' exact arithmetic)."""
    return torch.promote_types(x.dtype, torch.float32)


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The float32 chain, as the JAX package writes it (float64 throughout
    for a float64 input)."""
    x32 = x.to(_stat_dtype(x))
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(x32.dtype)).to(x.dtype)


def rms_norm_rstd_plain(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Each row's rsqrt(mean(x^2) + eps), the statistic ``rmsnorm_fwd``
    writes, [...] in float32 (float64 for a float64 input)."""
    x32 = x.to(_stat_dtype(x))
    return torch.rsqrt(x32.square().mean(dim=-1) + eps)


def rms_norm_backward_plain(
    x: torch.Tensor,  # [..., d]
    dy: torch.Tensor,  # like x
    rstd: torch.Tensor,  # [...]
    scale: torch.Tensor,  # [d]
    grid: int = 1,
    groups: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``rmsnorm_bwd`` and ``rmsnorm_dscale`` compute, written out:

        xh = x * rstd,  dx = rstd * (w * dy - xh * mean(w * dy * xh))

    in float32 (float64 for a float64 input), dx rounded once to x's dtype;
    dscale = sum over rows of dy * xh, split as the kernel splits it: row r
    goes to block ((r mod grid * groups) div groups), the block of the group
    that walks it, and the ``grid`` partials are summed in block order."""
    ct = _stat_dtype(x)
    d = x.shape[-1]
    x32, g32, w = x.to(ct), dy.to(ct), scale.to(ct)
    r = rstd.to(ct)[..., None]
    xh = x32 * r
    wg = w * g32
    c = (wg * xh).mean(dim=-1, keepdim=True)
    dx = (r * (wg - xh * c)).to(x.dtype)
    terms = (g32 * xh).reshape(-1, d)
    rows = torch.arange(terms.shape[0], device=x.device)
    block = (rows % (grid * groups)) // groups
    partials = terms.new_zeros(grid, d).index_add_(0, block, terms)
    dscale = partials[0].clone()
    for b in range(1, grid):
        dscale += partials[b]
    return dx, dscale.to(scale.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(_build.load(LIBRARY), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ptr(t: Optional[torch.Tensor]):
    return _P(None if t is None else t.data_ptr())


def _launch(name: str, dev: torch.device, tensors, ints, *tail) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn(name)(*(_ptr(t) for t in tensors), *ints, *tail, _P(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def _check(name: str, x: torch.Tensor, scale: torch.Tensor) -> None:
    """A CUDA call's inputs: x float32 or bfloat16, scale float32 [d], on
    x's card."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if scale.device != x.device:
        raise ValueError(f"{name}: inputs on {scale.device} and {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: {x.dtype} input; the kernels take float32 or bfloat16")
    if scale.dtype != torch.float32:
        raise TypeError(f"{name}: {scale.dtype} scale; the kernels take float32")
    if x.dim() < 1 or x.shape[-1] < 1 or scale.shape != (x.shape[-1],):
        raise ValueError(f"{name}: x {tuple(x.shape)} against scale {tuple(scale.shape)}")


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float,
                with_rstd: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """R1f on a CUDA tensor: (y, rstd), rstd [...] float32 when
    ``with_rstd``, else None. A non-contiguous x is copied here first."""
    _check("rmsnorm_fwd", x, scale)
    x = x.contiguous()
    scale = scale.contiguous()
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device) if with_rstd else None
    _launch("rmsnorm_fwd", x.device, (x, scale, y, rstd), (rows, d), _F(eps),
            _DTYPE_CODE[x.dtype])
    return y, rstd


def _bwd_grid(rows: int, dev: torch.device) -> int:
    """The persistent backward's blocks: all the card holds at once, fewer
    where there are few rows; fixed by the card and the shape alone."""
    full = _BWD_BLOCKS_PER_SM * _sm_count(dev.index)
    return max(1, min(full, -(-rows // _BWD_MIN_ROWS_PER_BLOCK)))


def rmsnorm_bwd(x: torch.Tensor, dy: torch.Tensor, rstd: torch.Tensor, scale: torch.Tensor,
                with_dscale: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """R1b on CUDA tensors: (dx, dscale), dscale [d] float32 when
    ``with_dscale`` (one more launch, ``rmsnorm_dscale``), else None."""
    _check("rmsnorm_bwd", x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} against x "
                         f"{tuple(x.shape)} {x.dtype}")
    if rstd.shape != x.shape[:-1] or rstd.dtype != torch.float32:
        raise ValueError(f"rmsnorm_bwd: rstd {tuple(rstd.shape)} {rstd.dtype}")
    d = x.shape[-1]
    if d > GENERAL_MAX_D:
        raise ValueError(f"rmsnorm_bwd: width {d} above {GENERAL_MAX_D}")
    x, dy, rstd, scale = (t.contiguous() for t in (x, dy, rstd, scale))
    rows = x.numel() // d
    grid = _bwd_grid(rows, x.device)
    dx = torch.empty_like(x)
    partials = (torch.empty((grid, d), dtype=torch.float32, device=x.device)
                if with_dscale else None)
    _launch("rmsnorm_bwd", x.device, (x, dy, rstd, scale, dx, partials),
            (rows, d, grid, _DTYPE_CODE[x.dtype]))
    if not with_dscale:
        return dx, None
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    _launch("rmsnorm_dscale", x.device, (partials, dscale), (grid, d))
    return dx, dscale


class _RMSNormFunction(torch.autograd.Function):
    """R1f forward (with rstd), R1b backward; saves x and rstd."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        x = x.contiguous()  # saved as the kernel reads it
        y, rstd = rmsnorm_fwd(x, scale, eps, with_rstd=True)
        ctx.save_for_backward(x, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, dy, rstd, scale, with_dscale=ctx.needs_input_grad[1])
        return (dx if ctx.needs_input_grad[0] else None), dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain chain on a CPU tensor; on a CUDA tensor the kernels, through
    the autograd Function where a gradient is needed, else the forward
    alone with no rstd written."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNormFunction.apply(x, scale, eps)
    return rmsnorm_fwd(x, scale, eps, with_rstd=False)[0]


class RMSNorm(nn.Module):
    """y = x * rsqrt(mean(x^2) + eps) * scale.

    Statistics are computed in float32 whatever the input dtype, and the
    result is cast back to it.
    """

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)
