"""The retrieval tower's attention kernels (``csrc/tower_attention.cu``, T1f
and T1b) against the plain version on the card. Every test here needs a CUDA
card and skips without one. This file imports no JAX, so it runs where the
card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tower_attention_chip.py

(``--noconftest``: the suite's conftest sets up JAX's CPU mesh.)

The plain version is ``dot_product_attention`` on the mask's dense sum and
its autograd, on the card, in the same dtype. Tolerances, each from where
the two sides round differently:
- o in bfloat16: both sides compute p = exp(x - max) / sum in float32, round
  it to bfloat16 and sum p·v in float32, then round once. Their float32 p
  differ in the last bits (the order of the row's sum, exp's rounding), so
  a p near a bfloat16 rounding boundary may round the other way: a change
  of 2^-8 of that p times its v. Each element is held within one bfloat16
  spacing of the plain value plus 2^-8 of the largest |value|.
- dq, dk, dv in bfloat16: the kernel rounds dP to bfloat16 as autograd's
  cast does, so the same flips reach dS through dP and P, and dS·scale goes
  to the tensor cores as two bfloat16 terms (16 bits of the float32 value);
  dq, dk and dv are then sums over up to 275 keys or queries. Each element
  within one bfloat16 spacing plus 2^-7 of the tensor's largest |value|.
- float32: 1e-5 (o) and 1e-4 (dq, dk, dv) of the largest |value|: float32
  on both sides, the kernel's sums in another order and its exp() within a
  few float32 ulps of PyTorch's.
Gradients are heavy-tailed (a row with no allowed key gives a dq far above
the others), so a limit scaled by the largest |value| can exceed a typical
element. Each tensor is therefore also held as a whole: ||got - ref|| within
2^-8 of ||ref|| in bfloat16 and 1e-5 in float32. The two sides round the same
float32 values, and differ only where those cross a rounding boundary; two
independent roundings of every element would read about 2^-9, half the
bfloat16 bound. A kernel that zeroed or mis-scaled a share of the rows reads
about that share. A value that is not finite on either side fails, whatever
the limits.
"""

import pytest
import torch

from recommend_tpu_torch.models.retrieval import _interleaved_causal_mask, _single_prediction_mask
from recommend_tpu_torch.ops import attention as tattn

# the KuaiFormer cell's calls: the main stack (1,024 histories of 55 tokens,
# 4 query tokens: 275 under the interleaved mask) and the two group encoders
# (2 groups of 64 and 5 of 16 a history), 8 heads of 16
HEADS, DH, TOKENS, QUERIES = 8, 16, 55, 4
MAIN_BATCH = 1024
ENCODER_SHAPES = [(2048, 64), (5120, 16)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(b, lq, lkv, heads, dh, dtype, seed):
    """q and k ~ N(0, 1.5^2) (scaled logits of std ~2.25 at Dh 16: peaked
    rows), v and dO ~ N(0, 1), in the projections' [B, L, H·Dh] layout."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def draw(length, std):
        return (std * torch.randn(b, length, heads * dh, generator=gen, device="cuda")).to(dtype)

    return draw(lq, 1.5), draw(lkv, 1.5), draw(lkv, 1.0), draw(lq, 1.0)


def _valid(b, t, pad, seed):
    """[B, T] validity: row r left-padded by (r * 7 + seed) % (pad + 1) items."""
    n = (torch.arange(b, device="cuda") * 7 + seed) % (pad + 1)
    return torch.arange(t, device="cuda")[None, :] >= n[:, None]


def _spacing(ref: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(ref.float())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)


def _assert_close(name, got, ref, rel):
    """Returns (largest difference over max|ref|, ||got - ref|| over ||ref||),
    each the difference itself where the reference is all zero."""
    got, ref32 = got.float(), ref.float()
    assert bool(torch.isfinite(ref32).all()), f"{name}: the plain path is not finite"
    nonfinite = int((~torch.isfinite(got)).sum())
    assert nonfinite == 0, f"{name}: {nonfinite} elements not finite"
    diff = (got - ref32).abs()
    top = ref32.abs().max()
    limit = rel * top
    if ref.dtype == torch.bfloat16:
        limit = limit + _spacing(ref32)
    bad = ~(diff <= limit)
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} elements out of tolerance, max diff "
        f"{diff.max().item():.3g} (max|ref| {top.item():.3g})")
    norm, err = torch.linalg.vector_norm(ref32), torch.linalg.vector_norm(got - ref32)
    rel_l2 = 2.0 ** -8 if ref.dtype == torch.bfloat16 else 1e-5
    assert bool(err <= rel_l2 * norm), (
        f"{name}: ||got - ref|| {err.item():.3g} over ||ref|| {norm.item():.3g}")
    return ((diff.max() / top).item() if top > 0 else diff.max().item(),
            (err / norm).item() if norm > 0 else err.item())


def _kernel(q, k, v, dout, bias, heads):
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    o = tattn.tower_attention(qg, kg, vg, bias, heads)
    return (o.detach(),) + torch.autograd.grad(o, (qg, kg, vg), dout)


def _plain(q, k, v, dout, bias, heads):
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def split(t):
        return t.reshape(*t.shape[:-1], heads, -1)

    o = tattn.dot_product_attention(split(qg), split(kg), split(vg), bias.dense()).flatten(-2)
    return (o.detach(),) + torch.autograd.grad(o, (qg, kg, vg), dout)


def _check(q, k, v, dout, bias, heads=HEADS):
    tattn.reset_launch_counts()
    got = _kernel(q, k, v, dout, bias, heads)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == {"tower_attn_fwd": 1, "tower_attn_bwd": 1, "tower_attn_plain": 0}
    ref = _plain(q, k, v, dout, bias, heads)
    bf16 = q.dtype == torch.bfloat16
    rels = (2.0 ** -8, 2.0 ** -7, 2.0 ** -7, 2.0 ** -7) if bf16 else (1e-5, 1e-4, 1e-4, 1e-4)
    errs = []
    for name, g, r, rel in zip(("o", "dq", "dk", "dv"), got, ref, rels):
        assert g.dtype == q.dtype and g.shape == r.shape
        errs.append(_assert_close(name, g, r, rel))
    print(f"{tuple(q.shape)} {tuple(k.shape)} {q.dtype}: max err of max|ref|, l2 err of ||ref|| "
          + ", ".join(f"{n} {e:.3g} {l2:.3g}" for n, (e, l2) in zip(("o", "dq", "dk", "dv"), errs)))
    return got


DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])


@pytest.mark.chip
@DTYPES
@pytest.mark.parametrize("pad", [0, 40], ids=["full", "left_padded"])
def test_the_main_stack_under_the_interleaved_mask(card, dtype, pad):
    # left-padded histories leave item rows with no allowed key (an item
    # sees the items up to itself, all padded): the plain path's uniform
    # softmax over every key at -1e9, which the kernel gives by walking
    # every key tile for those rows' tiles
    b = MAIN_BATCH if dtype == torch.bfloat16 else 256
    bias = _interleaved_causal_mask(_valid(b, TOKENS, pad, seed=1), QUERIES)
    length = TOKENS * (1 + QUERIES)
    q, k, v, dout = _qkv(b, length, length, HEADS, DH, dtype, seed=pad + 1)
    _check(q, k, v, dout, bias)


@pytest.mark.chip
@DTYPES
@pytest.mark.parametrize("shape", ENCODER_SHAPES, ids=["groups_of_64", "groups_of_16"])
def test_the_group_encoders_under_their_padding(card, dtype, shape):
    # some groups wholly padded: every key masked, a uniform softmax
    n, g = shape
    valid = _valid(n, g, g, seed=3)
    bias = tattn.FactoredBias(None, tattn.padding_mask_bias(valid)[:, 0, 0])
    q, k, v, dout = _qkv(n, g, g, HEADS, DH, dtype, seed=g)
    _check(q, k, v, dout, bias)


@pytest.mark.chip
@DTYPES
@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional", "causal"])
def test_the_single_prediction_masks(card, dtype, causal):
    bias = _single_prediction_mask(_valid(512, TOKENS, 30, seed=5), QUERIES, causal)
    length = TOKENS + QUERIES
    q, k, v, dout = _qkv(512, length, length, HEADS, DH, dtype, seed=7)
    _check(q, k, v, dout, bias)


@pytest.mark.chip
@DTYPES
@pytest.mark.parametrize("lq,lkv", [(37, 512), (512, 200), (1, 1)])
def test_head_width_32_and_queries_apart_from_keys(card, dtype, lq, lkv):
    # a structure of its own (a causal band over the tail) and a key bias
    structure = tattn.causal_band_mask(lq, lkv, device="cuda")
    key = tattn.padding_mask_bias(_valid(64, lkv, lkv // 3, seed=lq))[:, 0, 0]
    bias = tattn.factored_bias(structure, key)
    q, k, v, dout = _qkv(64, lq, lkv, 4, 32, dtype, seed=lkv)
    _check(q, k, v, dout, bias, heads=4)


@pytest.mark.chip
@DTYPES
def test_two_calls_are_bit_equal(card, dtype):
    bias = _interleaved_causal_mask(_valid(256, TOKENS, 20, seed=2), QUERIES)
    length = TOKENS * (1 + QUERIES)
    q, k, v, dout = _qkv(256, length, length, HEADS, DH, dtype, seed=11)
    first = _kernel(q, k, v, dout, bias, HEADS)
    second = _kernel(q, k, v, dout, bias, HEADS)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.chip
def test_the_forward_alone_writes_no_statistics_and_matches(card):
    bias = _interleaved_causal_mask(_valid(64, TOKENS, 10, seed=4), QUERIES)
    length = TOKENS * (1 + QUERIES)
    q, k, v, _ = _qkv(64, length, length, HEADS, DH, torch.bfloat16, seed=13)
    with torch.no_grad():
        o = tattn.tower_attention(q, k, v, bias, HEADS)
    o_grad = _kernel(q, k, v, torch.zeros_like(q), bias, HEADS)[0]
    assert torch.equal(o, o_grad)


@pytest.mark.chip
def test_the_wrappers_reject_what_the_kernels_do_not_take(card):
    bias = tattn.FactoredBias(None, None)
    for b, lq, lkv, heads, dh, dtype, err in (
            (2, 16, 16, 2, 64, torch.bfloat16, ValueError),  # Dh 64
            (2, 513, 16, 2, 16, torch.bfloat16, ValueError),  # 513 queries
            (2, 16, 513, 2, 16, torch.float32, ValueError),  # 513 keys
            (2, 16, 16, 2, 16, torch.float16, TypeError)):
        q, k, v, _ = _qkv(b, lq, lkv, heads, dh, torch.float32, seed=0)
        with pytest.raises(err):
            tattn.tower_attention(q.to(dtype), k.to(dtype), v.to(dtype), bias, heads)
