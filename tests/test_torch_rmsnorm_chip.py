"""RMSNorm's CUDA kernels (``csrc/rmsnorm.cu``) against their plain versions
on the card. Every test here needs a CUDA card and skips without one. This
file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rmsnorm_chip.py

(``--noconftest``: the suite's conftest sets up JAX's CPU mesh.)

Tolerances, each from where the two sides round differently:
- y and dx in bfloat16: both sides compute the same float32 value up to the
  order of a row's sum, then round once. They may fall on two neighbouring
  bfloat16 values, so each element is held within one bfloat16 spacing of
  the plain value, plus 1e-5 of the tensor's largest |value| for the
  float32 difference before the rounding.
- y and dx in float32: 1e-5 of the tensor's largest |value|. A row's sum of
  squares runs ~30 float32 additions on the kernel's side (lane, then
  shuffles) and a tree on PyTorch's; either errs by well under 1e-5 of the
  row's norm, and dx's cancellation keeps the error at the scale of its
  largest terms, not of each element.
- dscale (float32): 1e-4 of each column's sum of |dy * xh| over the rows.
  Each side adds up to ~400 float32 terms in sequence (the kernel: a lane's
  rows, the block's groups, the grid's blocks), which errs by at most
  400 * 2^-24 = 2.4e-5 of that sum on each side.
"""

import pytest
import torch

from recommend_tpu_torch.ops import normalization as tnorm

EPS = 1e-6
# OneTrans-L's and OneTrans-S's largest norm calls (the full [S; NS] stream
# of layer 0 at the cells' batches), then widths and layouts that take the
# general path or the copy: a non-contiguous input, widths off the vector
# path, an input that is not 16-byte aligned, no rows
CELL_SHAPES = [(512, 1202, 384), (2048, 362, 256)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(shape, dtype, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    d = shape[-1]
    x = (1.7 * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)
    dy = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    scale = 1.0 + 0.3 * torch.randn(d, generator=gen, device="cuda")
    return x, dy, scale


def _spacing(ref: torch.Tensor) -> torch.Tensor:
    """The bfloat16 spacing at each |ref| (2^(e - 8) for |ref| in [2^(e-1), 2^e))."""
    _, e = torch.frexp(ref.float())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)


def _assert_close(name, got, ref):
    got, ref32 = got.float(), ref.float()
    diff = (got - ref32).abs()
    top = ref32.abs().max()
    limit = 1e-5 * top
    if ref.dtype == torch.bfloat16:
        limit = limit + _spacing(ref32)
    bad = diff > limit
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} elements out of tolerance, max diff "
        f"{diff.max().item():.3g} (max|ref| {top.item():.3g})")


def _kernel(x, scale, dy):
    """y, dx, dscale and rstd through the module's CUDA path."""
    xg = x.detach().requires_grad_()
    sg = scale.detach().requires_grad_()
    y = tnorm.rms_norm(xg, sg, EPS)
    dx, dscale = torch.autograd.grad(y, (xg, sg), dy)
    return y.detach(), dx, dscale


def _plain(x, scale, dy):
    xg = x.detach().requires_grad_()
    sg = scale.detach().requires_grad_()
    y = tnorm.rms_norm_plain(xg, sg, EPS)
    dx, dscale = torch.autograd.grad(y, (xg, sg), dy)
    return y.detach(), dx, dscale


def _check(x, scale, dy):
    tnorm.reset_launch_counts()
    y, dx, dscale = _kernel(x, scale, dy)
    torch.cuda.synchronize()
    assert tnorm.LAUNCHES == {"rmsnorm_fwd": 1, "rmsnorm_bwd": 1, "rmsnorm_dscale": 1}
    assert y.dtype == x.dtype and dx.dtype == x.dtype and dscale.dtype == torch.float32
    assert y.shape == x.shape and dx.shape == x.shape and dscale.shape == scale.shape
    ref_y, ref_dx, ref_dscale = _plain(x, scale, dy)
    _assert_close("y", y, ref_y)
    _assert_close("dx (autograd of the plain chain)", dx, ref_dx)
    rstd = tnorm.rms_norm_rstd_plain(x, EPS)
    grid = tnorm._bwd_grid(x.numel() // x.shape[-1], x.device)
    wo_dx, wo_dscale = tnorm.rms_norm_backward_plain(x, dy, rstd, scale, grid)
    _assert_close("dx (the written-out backward)", dx, wo_dx)
    d = x.shape[-1]
    terms = (dy.float() * x.float() * rstd[..., None]).abs().reshape(-1, d).sum(0)
    for name, ref in (("autograd", ref_dscale), ("written out", wo_dscale)):
        gap = (dscale - ref).abs()
        assert bool((gap <= 1e-4 * terms + 1e-30).all()), (
            f"dscale ({name}): worst gap {(gap / terms).max().item():.3g} of sum|dy*xh|")


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", CELL_SHAPES, ids=["L", "S"])
def test_kernels_match_the_plain_version_at_the_cells_shapes(card, shape, dtype):
    x, dy, scale = _inputs(shape, dtype, seed=sum(shape))
    _check(x, scale, dy)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernels_match_the_plain_version_off_the_vector_path(card, dtype):
    # a non-contiguous input (the first half of each row of a wider buffer):
    # copied first
    wide, dy, scale = _inputs((64, 200, 2 * 384), dtype, seed=1)
    _check(wide[..., :384], scale[:384].contiguous(), dy[..., :384].contiguous())
    # widths the vector path does not take, and the widest the general
    # backward holds
    for d in (16, 48, 100, 1000, tnorm.GENERAL_MAX_D):
        x, dy, scale = _inputs((7, 33, d), dtype, seed=d)
        _check(x, scale, dy)
    # a width of the vector path at an address that is not 16-byte aligned
    x, dy, scale = _inputs((5, 41, 256), dtype, seed=2)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
    xu = buf[1:].view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    _check(xu, scale, dy)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_two_calls_are_bit_equal(card, dtype):
    x, dy, scale = _inputs(CELL_SHAPES[0], dtype, seed=3)
    first = _kernel(x, scale, dy)
    second = _kernel(x, scale, dy)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.chip
def test_no_grad_call_launches_the_forward_alone_and_other_dtypes_raise(card):
    x, _, scale = _inputs((4, 9, 384), torch.bfloat16, seed=4)
    tnorm.reset_launch_counts()
    norm = tnorm.RMSNorm(384, device="cuda")
    norm.load_state_dict({"scale": scale})
    with torch.no_grad():
        y = norm(x)
    with torch.inference_mode():
        y2 = norm(x)
    assert tnorm.LAUNCHES == {"rmsnorm_fwd": 2, "rmsnorm_bwd": 0, "rmsnorm_dscale": 0}
    assert torch.equal(y, y2)
    _assert_close("y", y, tnorm.rms_norm_plain(x, scale, EPS))
    y_rstd, rstd = tnorm.rmsnorm_fwd(x, scale, EPS, with_rstd=True)
    assert torch.equal(y_rstd, y)
    torch.testing.assert_close(rstd, tnorm.rms_norm_rstd_plain(x, EPS), rtol=1e-5, atol=0)
    with pytest.raises(TypeError, match="float16"):
        norm(x.half())
    with pytest.raises(TypeError, match="float64"):
        norm(x.double())
    # no rows: nothing to normalise, an empty result and a zero dscale
    empty = torch.empty(0, 384, dtype=torch.bfloat16, device="cuda", requires_grad=True)
    y0 = norm(empty)
    (g,) = torch.autograd.grad(y0.float().sum(), (norm.scale,))
    assert y0.shape == (0, 384) and bool((g == 0).all())
