"""``graft_entry_torch`` beside ``__graft_entry__`` on the CPU:

- ``entry()``: the same tiny config field for field, the same batch, and on
  the JAX entry's own params (carried across by ``convert.params_from_flax``)
  the same per-task logits within ``ENTRY_TOL`` of their largest magnitude
  (float32, the plain attention path: 8 items a sequence);
- ``dryrun_multichip(4)`` on four gloo ranks
  (``tests/torch_parallel_ranks.run_ranks``): a (2, 2) mesh, both steps
  finite and alike on every rank, the item table split over ``model``.
"""

import jax
import numpy as np
import torch

import __graft_entry__ as jax_graft
import graft_entry_torch
from recommend_tpu_torch.config import RankingConfig
from recommend_tpu_torch.convert import params_from_flax
from tests import torch_parallel_cases as cases
from tests.torch_parallel_ranks import run_ranks

torch.set_num_threads(1)

ENTRY_TOL = 1e-5  # float32, of max |logit|


def test_entry_runs_the_jax_entry_forward():
    jfn, (jparams, *jargs) = jax_graft.entry()
    want = jax.device_get(jax.jit(jfn)(jparams, *jargs))
    fn, (params, *args) = graft_entry_torch.entry(device="cpu")
    for got_group, want_group in zip(args, jargs):
        assert set(got_group) == set(want_group)
        for k, v in got_group.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want_group[k]))
    cfg = RankingConfig.from_dict(jax_graft._tiny_cfg().to_dict())
    converted = params_from_flax(jparams, cfg)
    assert set(converted) == set(params)
    got = fn(converted, *args)
    assert set(got) == set(want)
    for task, logits in got.items():
        ref = np.asarray(want[task])
        assert logits.shape == ref.shape
        err = float(np.abs(logits.numpy() - ref).max() / np.abs(ref).max())
        assert err <= ENTRY_TOL, (task, err)
    own = fn(params, *args)  # the port's own draw runs as well
    assert all(torch.isfinite(v).all() for v in own.values())


def test_dryrun_multichip_runs_on_four_gloo_ranks():
    results = run_ranks(4, cases.graft_dryrun, {"n": 4})
    assert all(r == results[0] for r in results)
    r = results[0]
    assert r["mesh"] == {"data": 2, "model": 2}
    assert np.isfinite(r["loss"]) and np.isfinite(r["sparse_loss"])
    assert r["item_table_rows_a_rank"] == 16_384 // 2
