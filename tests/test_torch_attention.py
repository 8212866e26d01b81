"""The port's band-attention ops held against the JAX package.

Each plain version in ``recommend_tpu_torch.ops.flash_attention`` (what the
CUDA kernels compute, and what a CPU tensor takes) is compared with the
forward of its Pallas kernel, run in interpret mode as
tests/test_flash_attention.py runs it, on the same numpy-seeded inputs at
float32 (atol/rtol 2e-5, the existing kernel tests' tolerance). The
dispatchers are held to route every shape to the counterpart of the kernel
the JAX dispatchers pick.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from recommend_tpu.ops import attention as jattn
from recommend_tpu.ops.pallas import flash_attention as jfa
from recommend_tpu_torch.ops import attention as tattn
from recommend_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _bias(rng, rows, lkv, pad, full_pad_row=False):
    """[rows, lkv] additive bias: ``pad`` left-padded keys per row, and
    optionally row 0 fully padded."""
    valid = np.ones((rows, lkv), dtype=bool)
    valid[:, :pad] = False
    if full_pad_row:
        valid[0] = False
    return np.where(valid, 0.0, jfa.NEG_INF).astype(np.float32)


def _close(torch_out, jax_out):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out), **TOL)


def test_masks_and_reference_attention_match():
    rng = np.random.default_rng(0)
    b, lq, lkv, h, dh = 2, 5, 9, 2, 16
    q, k, v = (_normal(rng, b, l, h, dh) for l in (lq, lkv, lkv))
    valid = rng.random((b, lkv)) > 0.3
    for off in (None, 2):
        _close(tattn.causal_band_mask(lq, lkv, off),
               jattn.causal_band_mask(lq, lkv, off))
    _close(tattn.padding_mask_bias(torch.from_numpy(valid)),
           jattn.padding_mask_bias(jnp.asarray(valid)))
    jb = jattn.causal_band_mask(lq, lkv)[None, None] + jattn.padding_mask_bias(
        jnp.asarray(valid))
    tb = tattn.causal_band_mask(lq, lkv)[None, None] + tattn.padding_mask_bias(
        torch.from_numpy(valid))
    _close(tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)), tb),
           jattn.dot_product_attention(*map(jnp.asarray, (q, k, v)), jb))


BH_CASES = [
    # (bh, lq, lkv, dh, pad, causal, full_pad_row)
    (2, 40, 100, 64, 9, True, False),      # Lq < Lkv, left-padded keys
    (3, 24, 56, 128, 5, True, True),       # a fully padded row
    (2, 32, 32, 64, 0, False, False),      # no band, no padding
]


@pytest.mark.parametrize("case", BH_CASES)
def test_blocked_plain_matches_flash_fwd_kernel(case):
    bh, lq, lkv, dh, pad, causal, full = case
    rng = np.random.default_rng(1)
    q, k, v = _normal(rng, bh, lq, dh), _normal(rng, bh, lkv, dh), _normal(rng, bh, lkv, dh)
    bias = _bias(rng, bh, lkv, pad, full)
    scale, off = 1.0 / dh ** 0.5, lkv - lq
    with pltpu.force_tpu_interpret_mode():
        j_out, j_lse = jfa._flash_fwd_impl(
            *map(jnp.asarray, (q, k, v, bias)), sm_scale=scale, q_offset=off,
            causal=causal, bq=16, bk=32)
    t_out, t_lse = tfa.band_attn_blocked_fwd(
        *map(torch.from_numpy, (q, k, v, bias)), scale, off, causal)
    _close(t_out, j_out)
    _close(t_lse, j_lse[:, 0, :])
    assert torch.isfinite(t_out).all()


@pytest.mark.parametrize("case", BH_CASES)
def test_bh_plain_matches_fused_fwd_kernel(case):
    bh, lq, lkv, dh, pad, causal, full = case
    rng = np.random.default_rng(2)
    q, k, v = _normal(rng, bh, lq, dh), _normal(rng, bh, lkv, dh), _normal(rng, bh, lkv, dh)
    bias = _bias(rng, bh, lkv, pad, full)
    scale, off = 1.0 / dh ** 0.5, lkv - lq
    with pltpu.force_tpu_interpret_mode():
        j_out, j_lse = jfa._fused_fwd_impl(
            *map(jnp.asarray, (q, k, v, bias)), sm_scale=scale, q_offset=off,
            causal=causal, g=2)
    t_out, t_lse = tfa.band_attn_bh_fwd(
        *map(torch.from_numpy, (q, k, v, bias)), scale, off, causal)
    _close(t_out, j_out)
    _close(t_lse, j_lse[:, :lq])


MH_CASES = [
    # (b, lq, lkv, h, dh, pad, full_pad_row)
    (2, 30, 70, 2, 128, 7, False),
    (2, 20, 48, 2, 64, 3, True),
    (1, 16, 16, 1, 128, 0, False),
]


@pytest.mark.parametrize("case", MH_CASES)
def test_mh_plain_matches_fmh_fwd_kernel(case):
    b, lq, lkv, h, dh, pad, full = case
    rng = np.random.default_rng(3)
    q = _normal(rng, b, lq, h * dh)
    k, v = _normal(rng, b, lkv, h * dh), _normal(rng, b, lkv, h * dh)
    bias = _bias(rng, b, lkv, pad, full)
    scale, off = 1.0 / dh ** 0.5, lkv - lq
    with pltpu.force_tpu_interpret_mode():
        j_out, j_lse = jfa._fmh_fwd_impl(
            *map(jnp.asarray, (q, k, v, bias)), sm_scale=scale, q_offset=off,
            causal=True, h=h, g=1)
    t_out, t_lse = tfa.band_attn_mh_fwd(
        *map(torch.from_numpy, (q, k, v, bias)), scale, off, True, h)
    _close(t_out, j_out)
    _close(t_lse, j_lse[:, :, :lq])


SEG_CASES = [
    # (b, lq, ls, n, h, dh, pad)
    (2, 25, 41, 4, 2, 128, 6),
    (2, 18, 30, 12, 2, 64, 0),
    (1, 16, 20, 4, 1, 128, 19),  # every S key but one padded
]


@pytest.mark.parametrize("case", SEG_CASES)
def test_segkv_plain_matches_fmhseg_fwd_kernel(case):
    b, lq, ls, n, h, dh, pad = case
    rng = np.random.default_rng(4)
    hd = h * dh
    q = _normal(rng, b, lq, hd)
    k, v = _normal(rng, b, ls, hd), _normal(rng, b, ls, hd)
    kns, vns = _normal(rng, b, n, hd), _normal(rng, b, n, hd)
    bias = _bias(rng, b, ls, pad)
    scale, off = 1.0 / dh ** 0.5, ls + n - lq
    with pltpu.force_tpu_interpret_mode():
        j_out, j_lse = jfa._fmhseg_fwd_impl(
            *map(jnp.asarray, (q, k, v, kns, vns, bias)), sm_scale=scale,
            q_offset=off, causal=True, h=h, g=1)
    t_out, t_lse = tfa.band_attn_segkv_fwd(
        *map(torch.from_numpy, (q, k, v, kns, vns, bias)), scale, off, True, h)
    _close(t_out, j_out)
    _close(t_lse, j_lse[:, :, :lq])


@pytest.mark.parametrize("dh", [64, 128])
def test_segkv_dispatcher_matches_jax(dh):
    """The model-layout segmented dispatcher end to end (its Dh=64 form
    concatenates and takes the [B·H, L, Dh] kernel)."""
    b, lq, ls, n, h = 2, 21, 37, 4, 2
    rng = np.random.default_rng(5)
    q = _normal(rng, b, lq, h, dh)
    k_s, v_s = _normal(rng, b, ls, h, dh), _normal(rng, b, ls, h, dh)
    k_ns, v_ns = _normal(rng, b, n, h, dh), _normal(rng, b, n, h, dh)
    valid = np.ones((b, ls), dtype=bool)
    valid[:, :5] = False
    args = (q, k_s, v_s, k_ns, v_ns, valid)
    off = ls + n - lq
    with pltpu.force_tpu_interpret_mode():
        j_out = jfa.flash_attention_bhld_segkv(*map(jnp.asarray, args), off, True)
    t_out = tfa.flash_attention_bhld_segkv(*map(torch.from_numpy, args), off, True)
    _close(t_out, j_out)


def _routes(module, array, zeros_like, segmented, shape):
    """Call a dispatcher with every kernel stubbed; return the kernels it
    reached, in the JAX package's names."""
    calls = []

    def stub(name):
        def fn(q, *args, **kwargs):
            calls.append(name)
            return zeros_like(q)
        return fn

    names = ("flash_band_attention", "fused_band_attention",
             "fused_mh_band_attention", "fused_mhseg_band_attention")
    with mock.patch.multiple(module, **{n: stub(n) for n in names}):
        if segmented:
            b, lq, ls, n, h, dh = shape
            z = lambda l: array(np.zeros((b, l, h, dh), np.float32))
            module.flash_attention_bhld_segkv(
                z(lq), z(ls), z(ls), z(n), z(n),
                array(np.ones((b, ls), dtype=bool)), ls + n - lq, True)
        else:
            b, lq, lkv, h, dh = shape
            z = lambda l: array(np.zeros((b, l, h, dh), np.float32))
            module.flash_attention_bhld(
                z(lq), z(lkv), z(lkv), array(np.ones((b, lkv), dtype=bool)),
                lkv - lq, True)
    return calls


ROUTE_CASES = [
    # flash_attention_bhld: (b, lq, lkv, h, dh)
    (False, (1, 91, 194, 2, 128)),    # model layout whole tile
    (False, (1, 91, 194, 4, 64)),     # Dh % 128 != 0 -> [B·H, L, Dh] tile
    (False, (1, 595, 1202, 2, 128)),  # kv > FUSED_MAX_KV -> blocked
    (False, (2, 352, 595, 2, 128)),   # group rule at its edge
    (False, (1, 1024, 1024, 1, 128)),  # one row busts the budget -> blocked
    (False, (1, 600, 1000, 1, 64)),   # bh budget busted -> blocked
    # flash_attention_bhld_segkv: (b, lq, ls, n, h, dh)
    (True, (1, 103, 194, 12, 2, 128)),   # segmented kernel
    (True, (1, 364, 595, 12, 2, 128)),   # segmented kernel, one row group
    (True, (1, 607, 1202, 12, 2, 128)),  # concat -> blocked
    (True, (1, 103, 194, 12, 4, 64)),    # concat -> [B·H, L, Dh] tile
    (True, (1, 700, 900, 12, 2, 128)),   # budget busted -> concat -> blocked
]


@pytest.mark.parametrize("segmented,shape", ROUTE_CASES)
def test_dispatch_reaches_the_same_kernel_as_jax(segmented, shape):
    j = _routes(jfa, jnp.asarray, jnp.zeros_like, segmented, shape)
    t = _routes(tfa, torch.from_numpy, torch.zeros_like, segmented, shape)
    assert len(j) == 1 and t == j, (j, t)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(6)
    q = torch.from_numpy(_normal(rng, 1, 8, 64))
    k = torch.from_numpy(_normal(rng, 1, 16, 64))
    bias = torch.zeros(1, 16)
    tfa.reset_launch_counts()
    out, lse = tfa.band_attn_mh_fwd(q, k, k, bias, 0.125, 8, True, 1)
    ref, ref_lse = tfa.band_attn_mh_fwd_plain(q, k, k, bias, 0.125, 8, True, 1)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert all(c == 0 for c in tfa.LAUNCHES.values())


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError):
        tfa.band_attn_mh_fwd(q, torch.zeros(1, 9, 64), torch.zeros(1, 8, 64),
                             torch.zeros(1, 8), 0.1, 0)
    with pytest.raises(TypeError):
        tfa.band_attn_mh_fwd(q, q.half(), q, torch.zeros(1, 8), 0.1, 0)
    with pytest.raises(TypeError):
        tfa.band_attn_bh_fwd(q, q, q, torch.zeros(1, 8, dtype=torch.float64), 0.1, 0)


# ---------------------------------------------------------------------------
# Backward halves: the port's autograd Functions (plain backward on CPU
# tensors) against jax.vjp of the Pallas kernels in interpret mode, and the
# plain backward against torch.autograd through the plain forward. float32;
# gradients reach |g| ~ 10 here, held at atol/rtol 1e-4.
# ---------------------------------------------------------------------------

GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _vjp(fn, args, do):
    import jax

    with pltpu.force_tpu_interpret_mode():
        out, pull = jax.vjp(fn, *map(jnp.asarray, args))
        return out, pull(jnp.asarray(do))


def _torch_grads(fn, args, do):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts, torch.from_numpy(do))


def _close_grads(t_grads, j_grads, names):
    for t, j, name in zip(t_grads, j_grads, names):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name, **GRAD_TOL)


BWD_BH_CASES = [
    # (bh, lq, lkv, dh, pad, causal, full_pad_row); small blocks below, so
    # several tiles and the skip of tiles above the band occur
    (2, 40, 100, 64, 9, True, False),
    (3, 24, 56, 32, 5, True, True),
    (2, 32, 32, 16, 0, False, False),
    (2, 30, 70, 96, 4, True, False),       # Dh 96: three 32-column chunks on the card
    (3, 9, 45, 48, 6, True, True),         # Lq < 16, one query block
]


@pytest.mark.parametrize("case", BWD_BH_CASES)
def test_blocked_backward_matches_flash_kernel_vjp(case):
    """B2dq + B2dkv against _dq_kernel/_dkv_kernel (blocks 16 x 32)."""
    bh, lq, lkv, dh, pad, causal, full = case
    rng = np.random.default_rng(7)
    q, k, v = _normal(rng, bh, lq, dh), _normal(rng, bh, lkv, dh), _normal(rng, bh, lkv, dh)
    do = _normal(rng, bh, lq, dh)
    bias = _bias(rng, bh, lkv, pad, full)
    scale, off = 1.0 / dh ** 0.5, lkv - lq
    j_out, j_grads = _vjp(lambda q, k, v: jfa.flash_band_attention(
        q, k, v, jnp.asarray(bias), scale, off, causal, 16, 32), (q, k, v), do)
    bias_t = torch.from_numpy(bias)
    t_out, t_grads = _torch_grads(lambda q, k, v: tfa.flash_band_attention(
        q, k, v, bias_t, scale, off, causal), (q, k, v), do)
    _close(t_out.detach(), j_out)
    _close_grads(t_grads, j_grads, ("dq", "dk", "dv"))
    assert all(torch.isfinite(g).all() for g in t_grads)


@pytest.mark.parametrize("case", BWD_BH_CASES)
def test_bh_backward_matches_fused_kernel_vjp(case):
    """B4b against _fused_bwd_kernel (group 2)."""
    bh, lq, lkv, dh, pad, causal, full = case
    rng = np.random.default_rng(8)
    q, k, v = _normal(rng, bh, lq, dh), _normal(rng, bh, lkv, dh), _normal(rng, bh, lkv, dh)
    do = _normal(rng, bh, lq, dh)
    bias = _bias(rng, bh, lkv, pad, full)
    scale, off = 1.0 / dh ** 0.5, lkv - lq
    j_out, j_grads = _vjp(lambda q, k, v: jfa.fused_band_attention(
        q, k, v, jnp.asarray(bias), scale, off, causal, 2), (q, k, v), do)
    bias_t = torch.from_numpy(bias)
    t_out, t_grads = _torch_grads(lambda q, k, v: tfa.fused_band_attention(
        q, k, v, bias_t, scale, off, causal), (q, k, v), do)
    _close(t_out.detach(), j_out)
    _close_grads(t_grads, j_grads, ("dq", "dk", "dv"))


@pytest.mark.parametrize("case", SEG_CASES)
def test_segkv_backward_matches_fmhseg_kernel_vjp(case):
    """B1b against _fmhseg_bwd_kernel: dq, dk_s, dv_s, dk_ns, dv_ns."""
    b, lq, ls, n, h, dh, pad = case
    rng = np.random.default_rng(9)
    hd = h * dh
    args = (_normal(rng, b, lq, hd), _normal(rng, b, ls, hd), _normal(rng, b, ls, hd),
            _normal(rng, b, n, hd), _normal(rng, b, n, hd))
    do = _normal(rng, b, lq, hd)
    bias = _bias(rng, b, ls, pad)
    scale, off = 1.0 / dh ** 0.5, ls + n - lq
    j_out, j_grads = _vjp(lambda *a: jfa.fused_mhseg_band_attention(
        *a, jnp.asarray(bias), scale, off, True, h, 1), args, do)
    bias_t = torch.from_numpy(bias)
    t_out, t_grads = _torch_grads(lambda *a: tfa.fused_mhseg_band_attention(
        *a, bias_t, scale, off, True, h), args, do)
    _close(t_out.detach(), j_out)
    _close_grads(t_grads, j_grads, ("dq", "dk", "dv", "dkns", "dvns"))


BWD_MH_CASES = [
    # (b, lq, lkv, h, dh, pad, full_pad_row): Lq not a multiple of 16, a
    # positive q_offset, padded keys, one fully padded row
    (2, 27, 61, 2, 128, 7, False),
    (3, 21, 40, 1, 64, 4, True),
    (1, 16, 16, 2, 32, 0, False),
]


@pytest.mark.parametrize("case", BWD_MH_CASES)
def test_mh_backward_matches_fmh_kernel_vjp(case):
    """B3b against _fmh_bwd_kernel (group 1), float32 at 1e-5."""
    b, lq, lkv, h, dh, pad, full = case
    rng = np.random.default_rng(11)
    hd = h * dh
    args = (_normal(rng, b, lq, hd), _normal(rng, b, lkv, hd), _normal(rng, b, lkv, hd))
    do = _normal(rng, b, lq, hd)
    bias = _bias(rng, b, lkv, pad, full)
    scale, off = 1.0 / dh ** 0.5, lkv - lq
    j_out, j_grads = _vjp(lambda *a: jfa.fused_mh_band_attention(
        *a, jnp.asarray(bias), scale, off, True, h, 1), args, do)
    bias_t = torch.from_numpy(bias)
    t_out, t_grads = _torch_grads(lambda *a: tfa.fused_mh_band_attention(
        *a, bias_t, scale, off, True, h), args, do)
    _close(t_out.detach(), j_out)
    for t, j, name in zip(t_grads, j_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   atol=1e-5, rtol=1e-5)


def test_mh_autograd_on_cpu_takes_the_plain_backward_and_counts_no_launch():
    """fused_mh_band_attention on CPU tensors that need a gradient: its
    backward is band_attn_mh_bwd_plain on the forward's lse and delta, and
    no kernel launch is counted."""
    rng = np.random.default_rng(12)
    b, lq, lkv, h, dh = 2, 12, 20, 2, 16
    q, k, v, do = (torch.from_numpy(_normal(rng, b, l, h * dh))
                   for l in (lq, lkv, lkv, lq))
    bias = torch.from_numpy(_bias(rng, b, lkv, 3))
    scale, off = 1.0 / dh ** 0.5, lkv - lq
    tfa.reset_launch_counts()
    got = _autograd_of_plain_fwd(
        lambda q, k, v: tfa.fused_mh_band_attention(q, k, v, bias, scale, off, True, h),
        (q, k, v), do)
    out, lse = tfa.band_attn_mh_fwd_plain(q, k, v, bias, scale, off, True, h)
    want = tfa.band_attn_mh_bwd_plain(q, k, v, bias, do, lse, tfa._delta(out, do, h),
                                      scale, off, True, h)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(c == 0 for c in tfa.LAUNCHES.values())


def _autograd_of_plain_fwd(fwd, args, do):
    ts = [a.clone().requires_grad_(True) for a in args]
    return torch.autograd.grad(fwd(*ts), ts, do)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backwards_match_autograd_of_plain_forwards(causal):
    """Each *_bwd_plain, fed the plain forward's lse and delta, equals
    torch.autograd through the plain forward (float32, atol/rtol 1e-5). Rows
    here all have a valid key: on a fully padded row lse = -1e9 + log n
    rounds to -1e9 in float32, so the recomputed p is 1, not 1/n, in the
    Pallas kernels and in the port alike (held above against their vjp);
    in the model such a row's dO is exactly 0."""
    rng = np.random.default_rng(10)
    t = lambda *s: torch.from_numpy(_normal(rng, *s))
    bh, lq, lkv, dh = 3, 20, 45, 32
    q, k, v, do = t(bh, lq, dh), t(bh, lkv, dh), t(bh, lkv, dh), t(bh, lq, dh)
    bias = torch.from_numpy(_bias(rng, bh, lkv, 6))
    scale, off = 1.0 / dh ** 0.5, lkv - lq
    out, lse = tfa.band_attn_bh_fwd_plain(q, k, v, bias, scale, off, causal)
    delta = tfa._delta(out, do)
    ref = _autograd_of_plain_fwd(
        lambda q, k, v: tfa.band_attn_bh_fwd_plain(q, k, v, bias, scale, off, causal)[0],
        (q, k, v), do)
    got = tfa.band_attn_bh_bwd_plain(q, k, v, bias, do, lse, delta, scale, off, causal)
    split = (tfa.band_attn_blocked_bwd_dq_plain(q, k, v, bias, do, lse, delta, scale,
                                                off, causal),
             *tfa.band_attn_blocked_bwd_dkv_plain(q, k, v, bias, do, lse, delta, scale,
                                                  off, causal))
    for a, b_, c in zip(got, split, ref):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5, rtol=1e-5)
        assert torch.equal(a, b_)

    b, h, n, ls = 2, 2, 4, 30
    q, do = t(b, lq, h * dh), t(b, lq, h * dh)
    k, v, kns, vns = t(b, ls, h * dh), t(b, ls, h * dh), t(b, n, h * dh), t(b, n, h * dh)
    s_bias = torch.from_numpy(_bias(rng, b, ls, 5))
    off = ls + n - lq
    out, lse = tfa.band_attn_segkv_fwd_plain(q, k, v, kns, vns, s_bias, scale, off,
                                             causal, h)
    ref = _autograd_of_plain_fwd(
        lambda *a: tfa.band_attn_segkv_fwd_plain(*a, s_bias, scale, off, causal, h)[0],
        (q, k, v, kns, vns), do)
    got = tfa.band_attn_segkv_bwd_plain(q, k, v, kns, vns, s_bias, do, lse,
                                        tfa._delta(out, do, h), scale, off, causal, h)
    for a, c in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5, rtol=1e-5)

    k, v = t(b, ls, h * dh), t(b, ls, h * dh)
    off = ls - lq
    out, lse = tfa.band_attn_mh_fwd_plain(q, k, v, s_bias, scale, off, causal, h)
    ref = _autograd_of_plain_fwd(
        lambda *a: tfa.band_attn_mh_fwd_plain(*a, s_bias, scale, off, causal, h)[0],
        (q, k, v), do)
    got = tfa.band_attn_mh_bwd_plain(q, k, v, s_bias, do, lse, tfa._delta(out, do, h),
                                     scale, off, causal, h)
    for a, c in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5, rtol=1e-5)


def test_every_preset_head_width_has_a_kernel():
    """Dh of every preset (ranking_base 384/4 = 96 included) is instantiated,
    and a Dh-96 call dispatches as the JAX package's does."""
    from recommend_tpu_torch.config import get_config

    for name in ("ranking_base", "ranking_small", "ranking_large"):
        cfg = get_config(name)
        assert cfg.embed_dim // cfg.num_heads in tfa._KERNEL_DH, name
    assert 96 in tfa._KERNEL_DH and all(d % 16 == 0 for d in tfa._KERNEL_DH)
    for segmented, shape in [(False, (1, 91, 194, 4, 96)),
                             (True, (1, 103, 194, 12, 4, 96))]:
        j = _routes(jfa, jnp.asarray, jnp.zeros_like, segmented, shape)
        t = _routes(tfa, torch.from_numpy, torch.zeros_like, segmented, shape)
        assert t == j == ["fused_band_attention"], (j, t)


def test_every_preset_head_width_meets_the_tma_row_stride():
    """TMA needs 16-byte row strides: H·Dh·2 bytes in model layout and Dh·2
    in the [B·H, L, Dh] layout, so every width in _KERNEL_DH must be a
    multiple of 8 elements, and each preset's width must be one of them."""
    from recommend_tpu_torch.config import get_config

    assert all(d * 2 % 16 == 0 for d in tfa._KERNEL_DH)
    for name in ("ranking_base", "ranking_small", "ranking_large"):
        cfg = get_config(name)
        dh = cfg.embed_dim // cfg.num_heads
        assert dh in tfa._KERNEL_DH and cfg.num_heads * dh * 2 % 16 == 0, name


def test_tma_alignment_check_rejects_an_unaligned_tensor():
    q = torch.zeros(4, 8, 64, dtype=torch.bfloat16)
    tfa._check_tma_aligned("band_attn_mh_fwd", (q, q[1:], q, q))
    flat = torch.zeros(4 * 8 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(4, 8, 64)  # 2 bytes past an aligned address
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._check_tma_aligned("band_attn_mh_fwd", (q, shifted, q, q))


@pytest.mark.parametrize("name, dtype", [("band_attn_bh_fwd", torch.float32),
                                         ("band_attn_blocked_fwd", torch.float32),
                                         ("band_attn_mh_fwd", torch.float32)])
def test_tma_alignment_check_spares_calls_that_use_no_tma(name, dtype):
    """Every float32 call runs the CUDA-core kernel, which reads no tensor
    map, so an unaligned tensor passes there."""
    flat = torch.zeros(4 * 8 * 64 + 1, dtype=dtype)
    shifted = flat[1:].view(4, 8, 64)
    tfa._check_tma_aligned(name, (shifted, shifted, shifted, shifted))


def _assert_each_unaligned_tensor_refused(name, n_tensors, dh):
    """One unaligned bf16 tensor among the ``n_tensors`` of a call is
    refused, wherever it stands; the same tensors in float32 pass."""
    flat = torch.zeros(4 * 8 * dh + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(4, 8, dh)
    aligned = torch.zeros(4, 8, dh, dtype=torch.bfloat16)
    for i in range(n_tensors):
        tensors = [aligned] * n_tensors
        tensors[i] = shifted
        with pytest.raises(ValueError, match=rf"tensors \[{i}\] .*16-byte aligned"):
            tfa._check_tma_aligned(name, tuple(tensors))
        tfa._check_tma_aligned(name, tuple(t.float() if t is aligned else
                                             flat.float()[1:].view(4, 8, dh)
                                             for t in tensors))


@pytest.mark.parametrize("name, n_tensors", [("band_attn_mh_bwd", 7),
                                             ("band_attn_segkv_bwd", 11),
                                             ("band_attn_blocked_bwd_dkv", 6),
                                             ("band_attn_blocked_bwd_dq", 5),
                                             ("band_attn_bh_bwd", 7)])
def test_tma_alignment_check_covers_the_tensor_core_backwards(name, n_tensors):
    """The bf16 calls of every backward, at every head width (here Dh 128
    and 64), encode a tensor map over every bf16 input and output (q, k,
    v[, kns, vns], dO, and the gradients they compute), so one unaligned
    tensor among them is refused; float32 calls run the CUDA-core passes,
    which read no tensor map."""
    for dh in (128, 64):
        _assert_each_unaligned_tensor_refused(name, n_tensors, dh)


@pytest.mark.parametrize("dh", tfa._KERNEL_DH)
def test_tma_alignment_check_covers_the_segmented_forward(dh):
    """The bf16 calls of B1f encode a tensor map over q, k, v, kns, vns and
    out at every head width, so one unaligned tensor among the six is
    refused; its float32 calls run the CUDA-core kernel and are spared."""
    _assert_each_unaligned_tensor_refused("band_attn_segkv_fwd", 6, dh)


@pytest.mark.parametrize("dh", tfa._KERNEL_DH)
def test_tma_alignment_check_covers_the_bh_forward(dh):
    """The bf16 calls of B4f run the tensor-core forward at every head
    width and encode a tensor map over q, k, v and out, so one unaligned
    tensor among the four is refused; its float32 calls run the CUDA-core
    kernel and are spared."""
    _assert_each_unaligned_tensor_refused("band_attn_bh_fwd", 4, dh)


def test_backward_wrappers_reject_bad_statistics():
    q = torch.zeros(2, 8, 32)
    k = torch.zeros(2, 12, 32)
    bias = torch.zeros(2, 12)
    with pytest.raises(ValueError):
        tfa.band_attn_bh_bwd(q, k, k, bias, q, torch.zeros(2, 7), torch.zeros(2, 8),
                             0.1, 4)
    with pytest.raises(TypeError):
        tfa.band_attn_blocked_bwd_dq(q, k, k, bias, q, torch.zeros(2, 8),
                                     torch.zeros(2, 8, dtype=torch.float64), 0.1, 4)
    with pytest.raises(TypeError):
        tfa.band_attn_blocked_bwd_dkv(q, k, k, bias, q.bfloat16(), torch.zeros(2, 8),
                                      torch.zeros(2, 8), 0.1, 4)
    # model layout: statistics are [B, H, Lq]
    with pytest.raises(ValueError):
        tfa.band_attn_mh_bwd(q, k, k, bias, q, torch.zeros(2, 8), torch.zeros(2, 8),
                             0.1, 4, True, 2)


# ---------------------------------------------------------------------------
# The retrieval tower's attention: the factored mask, its tile map, the
# dispatch of ``MultiHeadAttention`` and the wrappers of T1f/T1b. The kernels
# run only on a card (tests/test_torch_tower_attention_chip.py); here the
# plain path and the checks that run before any launch.
# ---------------------------------------------------------------------------

from recommend_tpu_torch.utils import profiling  # noqa: E402


def _tile_classes_by_hand(structure):
    lq, lkv = structure.shape
    t = tattn.TOWER_TILE
    out = np.zeros((-(-lq // t), -(-lkv // t)), np.int8)
    for i in range(out.shape[0]):
        for j in range(out.shape[1]):
            tile = structure[i * t:(i + 1) * t, j * t:(j + 1) * t]
            out[i, j] = 0 if (tile <= tattn.NEG_INF / 2).all() else 1 if (tile == 0).all() else 2
    return out


@pytest.mark.parametrize("lq,lkv,offset", [(275, 275, None), (37, 512, None), (16, 16, None),
                                          (1, 1, None), (40, 33, 5)])
def test_tile_classes_mark_skipped_zero_and_mixed_tiles(lq, lkv, offset):
    structure = tattn.causal_band_mask(lq, lkv, offset)
    got = tattn.tile_classes(structure)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), _tile_classes_by_hand(structure.numpy()))
    # a tile neither masked nor zero everywhere: an entry of another value
    odd = structure.clone()
    odd[0, 0] = -3.0
    assert tattn.tile_classes(odd)[0, 0] == 2


def test_factored_bias_dense_is_the_parts_sum():
    rng = np.random.default_rng(8)
    structure = torch.from_numpy(np.where(rng.random((5, 7)) < 0.5, 0.0, -1e9).astype(np.float32))
    key = torch.from_numpy(np.where(rng.random((3, 7)) < 0.3, -1e9, 0.0).astype(np.float32))
    both = tattn.factored_bias(structure, key)
    assert torch.equal(both.dense(), structure[None, None] + key[:, None, None, :])
    assert torch.equal(both.tiles, tattn.tile_classes(structure))
    assert torch.equal(tattn.FactoredBias(None, key).dense(), key[:, None, None, :])
    assert torch.equal(tattn.factored_bias(structure, None).dense(), structure[None, None])
    assert tattn.FactoredBias(None, None).dense() is None
    # a key masked twice sits at -2e9, as in the summed dense bias
    assert both.dense().min().item() == -2e9


def _mha(heads=2, dim=32, seed=0):
    torch.manual_seed(seed)
    return tattn.MultiHeadAttention(heads, dim)


def test_a_factored_mask_on_the_cpu_is_the_dense_sum_bit_for_bit():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(_normal(rng, 3, 6, 32))
    structure = tattn.causal_band_mask(6, 6)
    key = tattn.padding_mask_bias(torch.from_numpy(rng.random((3, 6)) > 0.3))[:, 0, 0]
    mha = _mha()
    bias = tattn.factored_bias(structure, key)
    tattn.reset_launch_counts()
    assert torch.equal(mha(x, bias=bias), mha(x, bias=bias.dense()))
    assert torch.equal(mha(x, bias=tattn.FactoredBias(None, key)),
                       mha(x, bias=key[:, None, None, :].expand(3, 1, 6, 6)))
    assert all(c == 0 for c in tattn.LAUNCHES.values())


@pytest.mark.parametrize("factored", [True, False], ids=["factored", "dense"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_the_dispatch_sends_factored_masks_to_the_kernels_off_the_cpu(factored, device):
    """Off the CPU (the meta device stands in for a card here) a factored
    mask reaches the kernels' wrapper and a dense bias the plain path,
    counted as ``tower_attn_plain``; on the CPU both take the plain path."""
    mha = _mha().to(device)
    x = torch.zeros(2, 5, 32, device=device)
    key = torch.zeros(2, 5, device=device)
    bias = tattn.FactoredBias(None, key) if factored else key[:, None, None, :]
    tattn.reset_launch_counts()
    with mock.patch.object(tattn, "tower_attention", wraps=tattn.tower_attention) as kernels, \
            mock.patch.object(tattn, "dot_product_attention",
                              wraps=tattn.dot_product_attention) as plain:
        if factored and device == "meta":
            with pytest.raises(ValueError, match="unsupported device meta"):
                mha(x, bias=bias)
        else:
            assert mha(x, bias=bias).shape == (2, 5, 32)
    to_kernels = factored and device == "meta"
    assert kernels.call_count == int(to_kernels) and plain.call_count == int(not to_kernels)
    assert tattn.LAUNCHES == {"tower_attn_fwd": 0, "tower_attn_bwd": 0,
                              "tower_attn_plain": int(device == "meta" and not factored)}


def test_the_tower_launch_counter_registers_and_resets():
    assert profiling.RECORDER.registered["tower_attention_launches"] is tattn.LAUNCHES
    tattn.LAUNCHES["tower_attn_fwd"] += 3
    tattn.LAUNCHES["tower_attn_plain"] += 1
    with profiling.recording():
        assert profiling.export()["registered"]["tower_attention_launches"] == tattn.LAUNCHES
    tattn.reset_launch_counts()
    assert tattn.LAUNCHES == {"tower_attn_fwd": 0, "tower_attn_bwd": 0, "tower_attn_plain": 0}


def test_the_tower_wrappers_reject_what_the_kernels_do_not_take():
    def qkv(b=2, lq=8, lkv=8, width=32, dtype=torch.bfloat16):
        return (torch.zeros(b, lq, width, dtype=dtype), torch.zeros(b, lkv, width, dtype=dtype),
                torch.zeros(b, lkv, width, dtype=dtype))

    structure = torch.zeros(8, 8)
    tiles = tattn.tile_classes(structure)
    cases = [
        (qkv(dtype=torch.float16), None, None, None, 2, TypeError),
        ((torch.zeros(2, 8, 32), *qkv()[1:]), None, None, None, 2, TypeError),  # mixed dtypes
        (qkv(width=128), None, None, None, 2, ValueError),  # Dh 64
        (qkv(lq=513), None, None, None, 2, ValueError),
        (qkv(lkv=513), None, None, None, 2, ValueError),
        (qkv(width=30), None, None, None, 4, ValueError),  # heads do not divide the width
        (qkv(), structure, None, None, 2, ValueError),  # a structure without its map
        (qkv(), structure[:4], None, tiles, 2, ValueError),
        (qkv(), structure.double(), None, tiles, 2, ValueError),
        (qkv(), None, torch.zeros(2, 7), None, 2, ValueError),
        (qkv(), structure, torch.zeros(2, 8), tiles, 2, ValueError),  # the CPU
    ]
    for (q, k, v), s, key, t, heads, err in cases:
        with pytest.raises(err):
            tattn.tower_attn_fwd(q, k, v, s, key, t, heads, with_stats=True)
        stats = torch.zeros(q.shape[0], heads, q.shape[1], 2)
        with pytest.raises(err):
            tattn.tower_attn_bwd(q, k, v, q, stats, s, key, t, heads)
    tattn.reset_launch_counts()
