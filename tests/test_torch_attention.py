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
