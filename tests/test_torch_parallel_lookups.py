"""The port's ``parallel/`` held against the JAX package's, on gloo ranks.

- the mesh: ``make_mesh``'s shapes and rank coordinates (4 ranks, data
  major, as JAX reshapes its devices), ``multihost_init``'s explicit-argument
  raise and zero-argument no-op (``tests/test_parallel.py``'s);
- the partition rules: the port's ``param_spec`` on its state-dict names
  agrees with JAX's ``param_spec`` leaf for leaf, on the ranking tree (with
  the 16,384-row item table and the NS stacks) and the retrieval tree (with
  the 32,768-row video table), at ``model`` 1 and 2;
- the lookups: ``sharded_lookup``, ``sharded_lookup_a2a`` (duplicates,
  capacity overflow, negative ids, ids == V) and ``sharded_lookup_column``
  on 4 ranks against the JAX functions on ``make_mesh(data=1, model=4)`` of
  4 virtual devices: the forward exactly, the table gradient at 1e-6;
- the corpus scan: ``sharded_topk_retrieval`` on 4 ranks against JAX's,
  with rows tied across shards: ids equal, scores at 1e-6.

The ranks run once for the whole module (one spawn) and each test reads its
case.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from recommend_tpu.ops.topk import sharded_topk_retrieval as j_sharded_topk
from recommend_tpu.parallel import embedding_sharding as jes
from recommend_tpu.parallel.mesh import make_mesh as j_make_mesh
from recommend_tpu.parallel.sharding import param_spec as j_param_spec
from recommend_tpu_torch.parallel import multihost_init
from recommend_tpu_torch.parallel.sharding import param_spec
from tests import torch_parallel_cases as cases
from tests.torch_parallel_ranks import run_ranks

torch.set_num_threads(1)

V, D, B = 64, 8, 16


def _lookup_cases():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(V, D)).astype(np.float32)
    w = rng.normal(size=(B, D)).astype(np.float32)
    dup = rng.integers(0, V, B)
    dup[:6] = 7  # one popular id, duplicated
    dup[6], dup[7], dup[8] = 0, V - 1, V  # first row, last row, the padding sentinel
    edge = np.array([5, -1, 60, -7, 0, 63, 12, 12, V, 3, 3, 3, 17, 30, -2, V])
    overflow = np.array([0, 1, 2, 3] * 4)  # every rank asks rank 0 for 4 distinct ids
    psum_ids = rng.integers(0, V, (3, 5))
    psum_ids[0, :2] = (V, -3)
    return {
        "psum": dict(kind="psum", table=table, ids=psum_ids,
                     w=rng.normal(size=(3, 5, D)).astype(np.float32)),
        "a2a_duplicates": dict(kind="a2a", table=table, ids=dup, w=w, capacity=0),
        "a2a_edges": dict(kind="a2a", table=table, ids=edge, w=w, capacity=0),
        "a2a_capacity_2": dict(kind="a2a", table=table, ids=overflow, w=w, capacity=2),
        "a2a_capacity_4": dict(kind="a2a", table=table, ids=overflow, w=w, capacity=4),
        "column": dict(kind="column", table=table, ids=dup, w=w),
    }


def _scan_cases():
    rng = np.random.default_rng(1)
    # small integers: every product and sum exact, so equal rows tie exactly
    corpus = rng.integers(-3, 4, (64, 4)).astype(np.float32)
    corpus[[3, 19, 35, 51]] = 5.0  # the same row on every shard: a four-way tie
    corpus[[8, 40]] = -5.0
    interests = rng.integers(-2, 3, (3, 2, 4)).astype(np.float32)
    interests[0] = 1.0  # row 0 scores the tied rows 20, first
    return {
        "tied": dict(corpus=corpus, interests=interests, k=6),
        "tied_chunked": dict(corpus=corpus, interests=interests, k=6, chunk_rows=5),
        "k_a_whole_shard": dict(corpus=corpus, interests=interests[:, 0], k=16),
    }


@pytest.fixture(scope="module")
def ranks():
    out = run_ranks(4, cases.lookups_and_scan,
                    {"lookups": _lookup_cases(), "scans": _scan_cases()})
    return out


@pytest.fixture(scope="module")
def jax_mesh():
    return j_make_mesh(data=1, model=4, devices=jax.devices()[:4])


# ---------------------------------------------------------------------------
# the mesh and multihost_init
# ---------------------------------------------------------------------------


def test_make_mesh_shapes_and_rank_coordinates(ranks):
    for r, got in enumerate(ranks):
        assert got["meshes"] == {"default": {"data": 4, "model": 1},
                                 "model2": {"data": 2, "model": 2}}
        # data major, as JAX's np.asarray(devices).reshape(data, model)
        assert got["coords"] == {"1x4": (0, r), "2x2": (r // 2, r % 2)}


def test_multihost_init_explicit_args_raise(tmp_path):
    with pytest.raises(RuntimeError, match="refusing to silently fall back"):
        multihost_init(init_method=f"file://{tmp_path}/store", world_size=-2, rank=7,
                       backend="gloo")
    assert not torch.distributed.is_initialized()


def test_multihost_init_zero_arg_is_noop(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost_init()  # a single process: nothing to join
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the partition rules
# ---------------------------------------------------------------------------


def _spec_codes(tree, m):
    """Each flax leaf replaced by a constant array: 0 replicated, 1 rows
    over model, 2 the stack axis over model (JAX's param_spec)."""
    code = {(): 0, ("model", None): 1, ("model",): 2}

    def leaf(path, x):
        return np.full(x.shape, code[tuple(j_param_spec(path, x, m))], np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _check_specs(port_params, m):
    expect = {0: (), 1: ("model", None), 2: ("model",)}
    seen = set()
    for name, t in port_params.items():
        if torch.isnan(t).any():  # no flax leaf (the port's DIN-only names)
            continue
        codes = torch.unique(t)
        assert codes.numel() == 1, name
        spec = param_spec(name, t, m)
        assert spec == expect[int(codes)], (name, spec)
        seen.add(spec)
    return seen


@pytest.mark.parametrize("m", [1, 2])
def test_param_spec_matches_jax_on_the_ranking_tree(m):
    from recommend_tpu.models.ranking import RankingModel as JaxModel
    from recommend_tpu_torch.convert import params_from_flax
    from tests.test_parallel import _sparse_flagship_cfg
    from tests.test_torch_ranking import make_batch, port_config

    cfg = _sparse_flagship_cfg("rowwise")
    batch = make_batch(cfg, 8)
    args = tuple({k: jnp.asarray(v) for k, v in batch[g].items()}
                 for g in ("non_seq", "sequences", "seq_valid"))
    shapes = jax.eval_shape(JaxModel(cfg).init, jax.random.key(0), *args)["params"]
    port = params_from_flax(_spec_codes(shapes, m), port_config(cfg))
    seen = _check_specs(port, m)
    assert seen == ({()} if m == 1 else {(), ("model", None), ("model",)})


@pytest.mark.parametrize("m", [1, 2])
def test_param_spec_matches_jax_on_the_retrieval_tree(m):
    from recommend_tpu.models.retrieval import RetrievalTower as JaxTower
    from recommend_tpu_torch import config as tconfig
    from recommend_tpu_torch.convert import retrieval_params_from_flax
    from tests.test_parallel import small_retrieval_cfg

    cfg = small_retrieval_cfg(video_vocab_size=32768)
    hist = {k: jnp.zeros((2, cfg.max_seq_len), jnp.float32 if k == "duration" else jnp.int32)
            for k in ("video_id", "category", "tag", "duration", "timestamp")}
    shapes = jax.eval_shape(JaxTower(cfg).init, jax.random.key(0), hist,
                            jnp.ones((2, cfg.max_seq_len), bool))["params"]
    port = retrieval_params_from_flax(
        {"params": _spec_codes(shapes, m)},
        tconfig.RetrievalConfig.from_dict(cfg.to_dict()))
    seen = _check_specs(port, m)
    assert seen == ({()} if m == 1 else {(), ("model", None)})


# ---------------------------------------------------------------------------
# the lookups
# ---------------------------------------------------------------------------


def _jax_lookup(mesh, case):
    table, ids, w = (jnp.asarray(case[k]) for k in ("table", "ids", "w"))
    if case["kind"] == "psum":
        t = jes.shard_table(mesh, table)
        fn = partial(jes.sharded_lookup, mesh, ids=ids)
    elif case["kind"] == "a2a":
        t = jes.shard_table(mesh, table)
        ids = jax.device_put(ids, NamedSharding(mesh, P("model")))
        fn = lambda t: jes.sharded_lookup_a2a(mesh, t, ids, capacity=case["capacity"])  # noqa: E731
    else:
        t = jes.shard_table_column(mesh, table)
        ids = jax.device_put(ids, NamedSharding(mesh, P("model")))
        fn = partial(jes.sharded_lookup_column, mesh, ids=ids)
    out = fn(t)
    grad = jax.grad(lambda t: jnp.sum(fn(t) * w))(t)
    return np.asarray(out), np.asarray(grad)


def _dense_reference(case, n=4):
    """The lookup the JAX docstrings specify, on the host: ids outside
    [0, V) give zero rows; for the all-to-all, each rank's unique ids of its
    block of the batch are served per owner in ascending order up to
    ``capacity``, the rest are zero rows. The gradient is the scatter-add of
    the weights of the served lookups."""
    table, ids, w = case["table"], case["ids"], case["w"]
    flat = ids.reshape(-1)
    served = (flat >= 0) & (flat < V)
    if case["kind"] == "a2a":
        b = len(flat) // n
        cap = case["capacity"] or b
        for r in range(n):
            blk = flat[r * b:(r + 1) * b]
            uniq = np.unique(blk[(blk >= 0) & (blk < V)])
            owner = uniq // (V // n)
            kept = {u for o in range(n) for u in uniq[owner == o][:cap]}
            served[r * b:(r + 1) * b] &= np.isin(blk, list(kept))
    out = np.where(served[:, None], table[np.clip(flat, 0, V - 1)], 0.0).astype(np.float32)
    grad = np.zeros_like(table)
    np.add.at(grad, flat[served], w.reshape(-1, D)[served])
    return out.reshape(ids.shape + (D,)), grad


def _check_lookup(ranks, name, out, grad):
    case = _lookup_cases()[name]
    for r, got in enumerate(ranks):
        res = got["lookups"][name]
        np.testing.assert_array_equal(res["out"], out, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["grad"], grad, rtol=1e-6, atol=1e-6,
                                   err_msg=f"rank {r}")
        assert res["block"] == ((V, D // 4) if case["kind"] == "column" else (V // 4, D))


@pytest.mark.parametrize("name", ["psum", "column"])
def test_lookup_and_its_gradient_match_jax(ranks, jax_mesh, name):
    out, grad = _jax_lookup(jax_mesh, _lookup_cases()[name])
    _check_lookup(ranks, name, out, grad)
    np.testing.assert_allclose(grad, _dense_reference(_lookup_cases()[name])[1], atol=1e-6)


@pytest.mark.parametrize("name", [n for n in _lookup_cases() if n.startswith("a2a")])
def test_a2a_lookup_and_its_gradient_match_the_dense_gather(ranks, name):
    """Against the host reference the JAX docstring specifies (the JAX
    function's shard_map compiles for ~20 s a case on the CPU: that
    comparison is the slow test below)."""
    out, grad = _dense_reference(_lookup_cases()[name])
    if name == "a2a_capacity_2":
        assert (out == 0).all(axis=1).sum() == 8  # each rank's ids 2 and 3 dropped
    _check_lookup(ranks, name, out, grad)


@pytest.mark.slow
@pytest.mark.parametrize("name", [n for n in _lookup_cases() if n.startswith("a2a")])
def test_a2a_lookup_and_its_gradient_match_jax(ranks, jax_mesh, name):
    out, grad = _jax_lookup(jax_mesh, _lookup_cases()[name])
    _check_lookup(ranks, name, out, grad)


# ---------------------------------------------------------------------------
# the corpus scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(_scan_cases()))
def test_sharded_scan_matches_jax_with_ties_across_shards(ranks, name):
    case = _scan_cases()[name]
    mesh = j_make_mesh(data=4, model=1, devices=jax.devices()[:4])
    s, i = j_sharded_topk(mesh, jnp.asarray(case["interests"]), jnp.asarray(case["corpus"]),
                          case["k"])
    if name == "tied":
        assert list(np.asarray(i)[0, :4]) == [3, 19, 35, 51]  # the tie, lowest id first
    for r, got in enumerate(ranks):
        res = got["scans"][name]
        np.testing.assert_array_equal(res["ids"], np.asarray(i), err_msg=f"rank {r}")
        np.testing.assert_allclose(res["scores"], np.asarray(s), rtol=1e-6, atol=1e-6)
        assert res["block"] == (16, 4)
