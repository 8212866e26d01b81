"""RMSNorm on the CPU: the backward the CUDA kernels compute, written out,
against autograd of the plain chain; the CPU path (plain, no launch) against
the JAX package's RMSNorm; the module's state dict; the launch counter's
registration with the recorder.

The kernels themselves (``csrc/rmsnorm.cu``) run only on a card:
``tests/test_torch_rmsnorm_chip.py`` holds them against these plain versions
there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommend_tpu.ops.normalization import RMSNorm as JaxRMSNorm
from recommend_tpu_torch.ops import normalization as tnorm
from recommend_tpu_torch.ops.normalization import RMSNorm
from recommend_tpu_torch.utils import profiling

torch.set_num_threads(1)

EPS = 1e-6


def _inputs(shape, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = torch.from_numpy(rng.normal(size=shape)).to(dtype)
    dy = torch.from_numpy(rng.normal(size=shape)).to(dtype)
    scale = torch.from_numpy(rng.normal(1.0, 0.3, size=(d,))).to(dtype)
    return x, dy, scale


@pytest.mark.parametrize("d", [16, 256, 384])
def test_backward_formula_matches_autograd_of_the_plain_chain(d):
    """In float64 the written-out backward is autograd's to rounding, and
    splitting dscale's sum over fixed blocks (as the kernel's persistent
    grid does: row r to the block of the group that walks it) changes it
    by rounding alone."""
    x, dy, scale = _inputs((3, 37, d), seed=d)
    xg, sg = x.clone().requires_grad_(), scale.clone().requires_grad_()
    y = tnorm.rms_norm_plain(xg, sg, EPS)
    assert y.dtype == torch.float64
    ref_dx, ref_dscale = torch.autograd.grad(y, (xg, sg), dy)
    rstd = tnorm.rms_norm_rstd_plain(x, EPS)
    for grid, groups in ((1, 1), (5, 3), (8, 16), (200, 2)):  # more blocks than rows too
        dx, dscale = tnorm.rms_norm_backward_plain(x, dy, rstd, scale, grid, groups)
        assert dx.dtype == torch.float64 and dscale.dtype == torch.float64
        torch.testing.assert_close(dx, ref_dx, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(dscale, ref_dscale, rtol=1e-12, atol=1e-12)
    # float32 inputs: the same arithmetic in float32, within its rounding
    x32, dy32, s32 = x.float(), dy.float(), scale.float()
    dx32, ds32 = tnorm.rms_norm_backward_plain(
        x32, dy32, tnorm.rms_norm_rstd_plain(x32, EPS), s32, 4, 8)
    assert dx32.dtype == torch.float32 and ds32.dtype == torch.float32
    torch.testing.assert_close(dx32.double(), ref_dx, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ds32.double(), ref_dscale, rtol=1e-4, atol=1e-4)


def test_cpu_tensor_takes_the_plain_path_and_counts_no_launch():
    tnorm.reset_launch_counts()
    x, dy, scale = _inputs((3, 5, 16), seed=0, dtype=torch.float32)
    norm = RMSNorm(16)
    norm.load_state_dict({"scale": scale})
    xg = x.clone().requires_grad_()
    y = norm(xg)
    y.backward(dy)
    assert set(tnorm.LAUNCHES) == {"rmsnorm_fwd", "rmsnorm_bwd", "rmsnorm_dscale"}
    assert all(n == 0 for n in tnorm.LAUNCHES.values()), tnorm.LAUNCHES
    j = JaxRMSNorm().apply({"params": {"scale": jnp.asarray(scale.numpy())}},
                           jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(j), atol=1e-5, rtol=1e-6)
    assert xg.grad is not None and norm.scale.grad is not None
    # bf16 and no-grad calls take the very same chain on the CPU
    xb = x.bfloat16()
    assert torch.equal(norm(xb), tnorm.rms_norm_plain(xb, norm.scale, norm.eps))
    with torch.no_grad():
        assert torch.equal(norm(x), tnorm.rms_norm_plain(x, norm.scale, norm.eps))
    assert all(n == 0 for n in tnorm.LAUNCHES.values()), tnorm.LAUNCHES


def test_state_dict_is_unchanged():
    """Checkpoints, ``convert.py`` and the engines' reloads read one float32
    ``scale`` of the norm's width, initialised to ones."""
    for d in (16, 384):
        sd = RMSNorm(d).state_dict()
        assert list(sd) == ["scale"]
        assert sd["scale"].shape == (d,) and sd["scale"].dtype == torch.float32
        assert torch.equal(sd["scale"], torch.ones(d))
        norm = RMSNorm(d)
        norm.load_state_dict({"scale": torch.full((d,), 2.0)})
        assert norm.eps == EPS and [n for n, _ in norm.named_parameters()] == ["scale"]


def test_launches_are_registered_with_the_recorder():
    assert profiling.RECORDER.registered["rmsnorm_launches"] is tnorm.LAUNCHES
    with profiling.recording():
        pass
    assert profiling.export()["registered"]["rmsnorm_launches"] == tnorm.LAUNCHES
