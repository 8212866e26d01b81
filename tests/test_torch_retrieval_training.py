"""The retrieval trainer's parts held against the JAX package on the CPU,
and its behaviour of its own:

- ``in_batch_softmax_loss`` and ``seq2seq_in_batch_loss`` against JAX's on
  the same seeded inputs (LogQ on and off, label smoothing, ``valid``, a
  batch of one, the per-position weighting): loss rtol 1e-5, accuracy
  exact;
- ``make_retrieval_optimizer`` against optax's ``adamw`` (through the JAX
  package's ``make_retrieval_optimizer``) over three updates, non-default
  b1/b2, decay seen on a 1-D tensor with a zero gradient, the id tables
  frozen with sparse updates: rtol 1e-6 (the same elementwise float32
  sequence; the schedule's rate may round one ulp apart);
- one step at four interests, and a JAX run continued in the port, against
  the JAX trainer (``tests/test_torch_retrieval_training_steps.py`` holds
  the three-step comparisons and states the tolerances);
- the masked positions drawn from the trainer's generator, a resumed run
  with dropout 0.1 bit-equal to an unbroken one, and an index built from a
  trainer's state that keeps its weights until ``refresh``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommend_tpu.models import losses as jlosses
from recommend_tpu.training.optimizer import make_retrieval_optimizer as j_make_optimizer
from recommend_tpu.training.trainer import RetrievalTrainer as JaxTrainer
from recommend_tpu_torch.data.pipeline import retrieval_batches
from recommend_tpu_torch.data.synthetic import make_retrieval_data
from recommend_tpu_torch.models import losses as tlosses
from recommend_tpu_torch.serving.retrieval_service import RetrievalIndex
from recommend_tpu_torch.training.optimizer import make_retrieval_optimizer
from recommend_tpu_torch.training.trainer import RetrievalTrainer
from tests.test_torch_retrieval_training_steps import (
    BATCH,
    STATE_ATOL,
    STATE_RTOL,
    assert_metrics_close,
    assert_state_close,
    batches_for,
    both_step,
    converted,
    port_cfg,
    start,
    tiny_cfg,
)

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
OPT_RTOL = 1e-6


# -- losses ----------------------------------------------------------------


def _loss_inputs(b, r=None, k=3, d=8, seed=0):
    rng = np.random.default_rng(seed)
    lead = (b,) if r is None else (b, r)
    return (rng.normal(size=lead + (k, d)).astype(np.float32),
            rng.normal(size=lead + (d,)).astype(np.float32),
            rng.uniform(1e-6, 1e-2, size=lead).astype(np.float32),
            rng.random(lead) < 0.7)


def _close_losses(got, ref):
    (gl, gm), (rl, rm) = got, ref
    np.testing.assert_allclose(float(gl), float(rl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(gm["loss"]), float(rm["loss"]), rtol=LOSS_RTOL)
    assert float(gm["in_batch_accuracy"]) == pytest.approx(float(rm["in_batch_accuracy"]),
                                                           rel=1e-6)


@pytest.mark.parametrize("b", [1, 6])
@pytest.mark.parametrize("logq", [False, True], ids=["no_logq", "logq"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("with_valid", [False, True], ids=["all_rows", "valid"])
def test_in_batch_softmax_loss_matches(b, logq, smoothing, with_valid):
    i, e, pop, valid = _loss_inputs(b)
    if with_valid and b > 1:
        valid[0] = False  # a row left out
    jp, tp = (jnp.asarray(pop), torch.as_tensor(pop)) if logq else (None, None)
    jv, tv = (jnp.asarray(valid), torch.as_tensor(valid)) if with_valid else (None, None)
    _close_losses(tlosses.in_batch_softmax_loss(torch.as_tensor(i), torch.as_tensor(e), tp,
                                                smoothing, tv),
                  jlosses.in_batch_softmax_loss(jnp.asarray(i), jnp.asarray(e), jp,
                                                smoothing, jv))


def test_in_batch_accuracy_takes_the_first_argmax():
    """Two items with one embedding tie in every row: row 1's argmax is
    column 0 (the first), so row 1 is wrong and row 0 right, as in JAX."""
    i = np.ones((2, 1, 4), np.float32)
    e = np.ones((2, 4), np.float32)
    got = tlosses.in_batch_softmax_loss(torch.as_tensor(i), torch.as_tensor(e))
    ref = jlosses.in_batch_softmax_loss(jnp.asarray(i), jnp.asarray(e))
    _close_losses(got, ref)
    assert float(got[1]["in_batch_accuracy"]) == 0.5


@pytest.mark.parametrize("logq", [False, True], ids=["no_logq", "logq"])
def test_seq2seq_in_batch_loss_matches(logq):
    """Per-position losses weighted by each position's valid rows, one
    position with no valid row at all."""
    i, e, pop, valid = _loss_inputs(5, r=4, seed=1)
    valid[:, 2] = False
    jp, tp = (jnp.asarray(pop), torch.as_tensor(pop)) if logq else (None, None)
    _close_losses(
        tlosses.seq2seq_in_batch_loss(torch.as_tensor(i), torch.as_tensor(e), tp,
                                      torch.as_tensor(valid), 0.1),
        jlosses.seq2seq_in_batch_loss(jnp.asarray(i), jnp.asarray(e), jp, jnp.asarray(valid),
                                      0.1))
    none = np.zeros_like(valid)
    loss, m = tlosses.seq2seq_in_batch_loss(torch.as_tensor(i), torch.as_tensor(e), None,
                                            torch.as_tensor(none))
    assert float(loss) == 0.0 == float(m["in_batch_accuracy"])


# -- the optimizer -----------------------------------------------------------


@pytest.mark.parametrize("sparse", [False, True], ids=["dense_tables", "sparse_tables"])
def test_retrieval_optimizer_matches_optax_adamw(sparse):
    cfg = tiny_cfg("rowwise" if sparse else "off", learning_rate=1e-2, warmup_steps=2,
                   adam_b1=0.8, adam_b2=0.95, weight_decay=0.1)
    rng = np.random.default_rng(0)
    arrays = {  # port name -> (flax path, array)
        "embed.tables.video_id.weight": (("embed", "video_id", "embedding"), (6, 4)),
        "embed.fuse_norm.scale": (("embed", "fuse_norm", "scale"), (4,)),
        "query_tokens": (("query_tokens",), (2, 4)),
        "blocks.0.attn.k_proj.bias": (("block_0", "attn", "k_proj", "bias"), (4,)),
    }
    values = {n: rng.normal(size=shape).astype(np.float32) for n, (_, shape) in arrays.items()}

    def tree(vals):
        out = {}
        for n, (path, _) in arrays.items():
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = jnp.asarray(vals[n])
        return {"params": out}

    def leaf(t, n):
        node = t["params"]
        for key in arrays[n][0]:
            node = node[key]
        return np.asarray(node)

    jopt = j_make_optimizer(cfg, total_steps=10)
    jparams = tree(values)
    jstate = jopt.init(jparams)
    topt = make_retrieval_optimizer(port_cfg(cfg), 10, ["embed.tables.video_id.weight"])
    tparams = {n: torch.as_tensor(v.copy()) for n, v in values.items()}
    tstate = topt.init(tparams)
    assert ("embed.tables.video_id.weight" in tstate["mu"]) is not sparse
    for step in range(3):
        grads = {n: rng.normal(size=v.shape).astype(np.float32) for n, v in values.items()}
        grads["embed.fuse_norm.scale"][:] = 0.0  # moved by the decay alone
        updates, jstate = jopt.update(tree(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.step(tparams, {n: torch.as_tensor(g) for n, g in grads.items()}, tstate)
        for n in arrays:
            np.testing.assert_allclose(tparams[n].numpy(), leaf(jparams, n), rtol=OPT_RTOL,
                                       atol=1e-7, err_msg=f"step {step} {n}")
    assert tstate["count"] == 3
    scale = tparams["embed.fuse_norm.scale"].numpy()
    assert not np.allclose(scale, values["embed.fuse_norm.scale"])  # the decay moved it
    table = tparams["embed.tables.video_id.weight"].numpy()
    assert np.array_equal(table, values["embed.tables.video_id.weight"]) is sparse


def test_step_zero_learns_nothing_dense_under_warmup():
    """The warmup starts at rate 0 (optax's warmup_cosine_decay_schedule)."""
    topt = make_retrieval_optimizer(port_cfg(tiny_cfg(warmup_steps=4)), 10)
    assert topt.lr(0) == 0.0 and topt.lr(2) == pytest.approx(0.5 * topt.cfg.learning_rate)


# -- steps against the JAX trainer --------------------------------------------


@pytest.mark.parametrize("mode,sparse,budget", [("single", "rowwise", 40),
                                                ("seq2seq", "off", 0),
                                                ("masked", "exact", 0)])
def test_one_step_at_four_interests_matches(mode, sparse, budget):
    """One step at the default four interests from the JAX trainer's
    state (the max over interests taken per score)."""
    cfg = tiny_cfg(sparse, budget)
    assert cfg.num_query_tokens == 4
    jt, js, tt, ts, batches = start(cfg, mode)
    lr = tt.optimizer.lr(0)
    js, jm, ts, tm = both_step(jt, js, tt, ts, batches[0], cfg, mode)
    assert_metrics_close(tm, jm)
    assert_state_close(ts, js, tt.cfg, lr)
@pytest.mark.parametrize("sparse", ["off", "rowwise"])
def test_a_jax_run_continues_in_the_port(sparse):
    """Two JAX steps, then the whole state (parameters, adamw moments and
    count, accumulators) carried across: one more step on each side
    agrees, and the port's step counter and schedule pick up at step 2."""
    cfg = tiny_cfg(sparse, 0, num_query_tokens=1)
    tcfg = port_cfg(cfg)
    batches = batches_for(cfg, 3, seed=1)
    jt = JaxTrainer(cfg, total_steps=10, mode="seq2seq")
    js = jt.init_state(jax.random.key(0), batches[0])
    for b in batches[:2]:
        js, _ = jt._train_step(js, jt._put_batch(b), jax.random.key(0))
    params, opt, accums = converted(js, tcfg)
    assert opt["count"] == 2 and any(float(v.abs().max()) > 0 for v in opt["nu"].values())
    tt = RetrievalTrainer(tcfg, total_steps=10, mode="seq2seq", device="cpu")
    ts = tt.init_state(params, opt_state=opt, accums=accums)
    assert ts.step == 2
    js, jm, ts, tm = both_step(jt, js, tt, ts, batches[2], cfg, "seq2seq")
    assert_metrics_close(tm, jm)
    # the carried key-bias moments are noise too: bound by three steps' lr
    assert_state_close(ts, js, tcfg, sum(tt.optimizer.lr(c) for c in range(3)))
    dense = ts.opt_state[0] if accums is not None else ts.opt_state
    _, jopt, _ = converted(js, tcfg)
    assert dense["count"] == jopt["count"] == 3
    for k, v in jopt["mu"].items():
        if not k.endswith("attn.k_proj.bias"):
            np.testing.assert_allclose(dense["mu"][k].numpy(), v.numpy(), atol=STATE_ATOL,
                                       rtol=STATE_RTOL, err_msg=k)


def test_mask_positions_come_from_the_trainer_generator():
    """Without ``mask_positions`` a masked step draws them from the
    generator it is given: the same seed, the same step, bit for bit."""
    tcfg = port_cfg(tiny_cfg("rowwise", 40))
    batch = batches_for(tiny_cfg("rowwise", 40), 1)[0]
    results = []
    for _ in range(2):
        tt = RetrievalTrainer(tcfg, mode="masked", device="cpu")
        ts = tt.init_state(seed=3)
        ts, m = tt._train_step(ts, tt._put_batch(batch), torch.Generator().manual_seed(5))
        results.append((float(m["loss"]), ts.params))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(results[0][1][k], results[1][1][k]) for k in results[0][1])
    pos = tt.draw_mask_positions(BATCH, torch.Generator().manual_seed(5))
    assert pos.shape == (BATCH, tt.num_mask) == (BATCH, 7)
    assert int(pos.min()) >= tcfg.max_seq_len - tt.tail_r and int(pos.max()) < tcfg.max_seq_len


# -- checkpoints and the hand-off to the index ---------------------------------


def _port_batches(tcfg, n, seed=0):
    data = make_retrieval_data(tcfg, num_users=20, num_videos=200, seed=seed)
    return list(retrieval_batches(data, tcfg, batch_size=BATCH, seed=seed, num_epochs=1))[:n]


def _state_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_resumed_run_is_bit_equal_to_an_unbroken_one(tmp_path):
    """Masked mode with dropout 0.1 (the generator draws the positions and
    the dropout seeds): steps 0-2 saved, a new trainer resumes to step 4
    (parameters, adamw state, accumulators, step, generator), and equals a
    run of steps 0-4 bit for bit."""
    tcfg = port_cfg(tiny_cfg("rowwise", 40, dropout_rate=0.1))
    batches = _port_batches(tcfg, 4)
    ck = str(tmp_path / "ck")
    first = RetrievalTrainer(tcfg, total_steps=10, mode="masked", checkpoint_dir=ck,
                             device="cpu", max_to_keep=2)
    first.train(iter(batches[:2]), 2, log_every=1, seed=7)
    resumed = RetrievalTrainer(tcfg, total_steps=10, mode="masked", checkpoint_dir=ck,
                               device="cpu", max_to_keep=2)
    s1 = resumed.train(iter(batches[2:]), 4, log_every=1, seed=7)
    assert [h["step"] for h in resumed.history["train"]] == [3, 4]
    assert resumed.ckpt.steps() == [2, 4]
    whole = RetrievalTrainer(tcfg, total_steps=10, mode="masked", device="cpu")
    s2 = whole.train(iter(batches), 4, log_every=1, seed=7)
    assert s1.step == s2.step == 4
    assert resumed.history["train"][-1]["loss"] == whole.history["train"][-1]["loss"]
    assert _state_equal(s1.params, s2.params) and _state_equal(s1.opt_state, s2.opt_state)
    with pytest.raises(RuntimeError, match="checkpoint restore failed"):
        RetrievalTrainer(port_cfg(tiny_cfg("exact", 40, dropout_rate=0.1)), mode="masked",
                         checkpoint_dir=ck, device="cpu").init_state()


def test_evaluate_and_train_loop_report_in_batch_metrics(tmp_path):
    tcfg = port_cfg(tiny_cfg("rowwise", 0))
    batches = _port_batches(tcfg, 4, seed=2)
    tr = RetrievalTrainer(tcfg, total_steps=4, device="cpu", log_dir=str(tmp_path / "log"))
    state = tr.train(iter(batches), 4, val_fn=lambda: iter(batches[:2]), eval_every=2,
                     log_every=2, profile_dir=str(tmp_path / "prof"), profile_start=1,
                     profile_num_steps=2)
    assert [h["step"] for h in tr.history["train"]] == [2, 4]
    assert tr.history["train"][0]["examples_per_s"] > 0
    val = tr.history["val"][-1]
    assert {"recall@1", "recall@5", "ndcg@5", "mrr"} <= set(val) and "recall@10" not in val
    assert 0.0 <= val["recall@1"] <= val["recall@5"] <= 1.0
    assert list((tmp_path / "prof").glob("trace_*.json"))
    assert dict(tr.evaluate(state, iter(batches[:2])), step=4) == val


def test_an_index_keeps_its_weights_until_refresh():
    """An index built from a trainer's state copies it: the trainer's
    in-place step leaves the index's results as they were, and ``refresh``
    brings the new weights in."""
    tcfg = port_cfg(tiny_cfg("rowwise", 0, warmup_steps=0))
    batches = _port_batches(tcfg, 1)
    tr = RetrievalTrainer(tcfg, total_steps=10, device="cpu")
    state = tr.init_state(seed=1)
    index = RetrievalIndex(tcfg, state.params, embed_batch=64, device="cpu")
    index.build(make_retrieval_data(tcfg, num_users=2, num_videos=200, seed=0).corpus_features())
    q = torch.as_tensor(np.random.default_rng(0).normal(size=(2, 4, 32)).astype(np.float32))
    before = index.search(q, top_k=20)
    state, _ = tr._train_step(state, tr._put_batch(batches[0]))
    after = index.search(q, top_k=20)
    assert all(np.array_equal(a, b) for a, b in zip(before, after))
    index.refresh(state.params)
    refreshed = index.search(q, top_k=20)
    assert not np.array_equal(refreshed[0], before[0])
    fresh = RetrievalIndex(tcfg, state.params, embed_batch=64, device="cpu")
    fresh.build(index._last_corpus)
    assert all(np.array_equal(a, b) for a, b in zip(refreshed, fresh.search(q, top_k=20)))
