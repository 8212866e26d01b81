"""``RetrievalTrainer._train_step`` in seq2seq mode held against the plain
float32 reference of the KuaiFormer cell (``perfbench/reference/kuaiformer.py``)
on the CPU, at ``retrieval_small``'s widths (d 64, 2 layers, 4 heads, 64
items: 2 groups of 16, 2 of 8, 16 raw), batch 8, sparse row-wise updates
and every field of the cell's configuration otherwise, from the cell's
seeded weights and batches (full histories, Zipf ids).

The program runs in float32 here (``compute_dtype``), so the two sides
differ by the order of their float32 sums alone. Tolerances:

- the loss, rtol 1e-5: a mean of ~400 float32 terms;
- each dense gradient, read from adamw's first moment after one step
  (mu = (1 - b1) g), within 1e-4 of the largest element of the reference's
  gradient of that tensor: the reference computes the rows in blocks and
  the columns' gradient separately, so every sum is ordered differently;
  a key's bias, whose true gradient is zero (it adds one constant to a
  softmax row), is compared at the same absolute bound;
- the id tables: the same rows touched, and each row's update and
  accumulator within rtol 1e-4 and 1e-6 of the step's largest update
  (the per-lookup gradients carry the same ordering);
- adamw's step, two steps on with a one-step warmup (the first at a rate
  of 0, the second at the peak, 1e-3): every dense element within 2e-6
  absolute, 0.2% of what the step moves it; an element whose gradient is
  under 1e-6 of the largest in both steps holds rounding noise (the key
  biases' whole gradient is such), adam's normalised update takes its
  sign from the noise, and it is held to 2·lr.

The last test holds the reference to its rule: it imports nothing of the
port and no JAX, whatever it imports in turn.
"""

import ast
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench.reference import kuaiformer as ref  # noqa: E402
from perfbench.reference.onetrans import F32Ops  # noqa: E402
from perfbench.yardstick.retrieval_inputs import make_batches, make_weights, to_host  # noqa: E402
from recommend_tpu_torch.config import RetrievalConfig  # noqa: E402
from recommend_tpu_torch.training.trainer import RetrievalTrainer  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 22
TRAFFIC = {"kind": "retrieval_train", "mode": "seq2seq", "batch_size": 8, "placed_batches": 2,
           "warm_steps": 1, "profiled_steps": 1, "id_zipf": 1.1}
TOTAL_STEPS = 100


def small_cfg(**overrides):
    """The cell's configuration at ``retrieval_small``'s widths."""
    cfg = json.load(open(os.path.join(ROOT, "perfbench/configs/kuaiformer_flagship.json")))
    cfg = dict(cfg["config"])
    cfg.update(embed_dim=64, num_layers=2, num_heads=4, ffn_dim=128, max_seq_len=64,
               compression_schedule=[[32, 16], [16, 8], [16, 1]], video_vocab_size=10_000,
               category_vocab_size=100, tag_vocab_size=500, compute_dtype="float32")
    cfg.update(overrides)
    return cfg


def _program(cfg, steps):
    """(trainer, state after ``steps`` steps, the batches as placed)."""
    torch.manual_seed(0)
    trainer = RetrievalTrainer(RetrievalConfig.from_dict({**cfg, "batch_size": 8}),
                               total_steps=TOTAL_STEPS, mode="seq2seq", device=CPU)
    weights = make_weights(cfg, SEED, CPU)
    state = trainer.init_state(params={n: weights[n] for n, _ in
                                       trainer.model.named_parameters()})
    drawn = make_batches(cfg, TRAFFIC, SEED, CPU)
    batches = [trainer._put_batch(to_host(b)) for b in drawn]
    losses = []
    for b in batches[:steps]:
        state, m = trainer._train_step(state, b)
        losses.append(float(m["loss"]))
    return trainer, state, drawn, losses


def _reference_state(P):
    tables = {f"embed.tables.{f}.weight" for f in ref.ID_FEATURES}
    return {"count": 0,
            "mu": {n: torch.zeros_like(t) for n, t in P.items() if n not in tables},
            "nu": {n: torch.zeros_like(t) for n, t in P.items() if n not in tables},
            "accum": {n: torch.full(P[n].shape[:1], 0.1) for n in tables}}


@pytest.fixture(scope="module")
def one_step():
    """The program one step on, and the reference's loss, gradients and
    update of the same step (its rows in blocks of 3)."""
    cfg = small_cfg()
    trainer, state, drawn, losses = _program(cfg, 1)
    P = {n: t.clone() for n, t in make_weights(cfg, SEED, CPU).items()}
    loss, grads, lookups = ref.gradients(P, cfg, drawn[0], F32Ops(), rows=3)
    rstate = _reference_state(P)
    ref.apply_update(P, rstate, grads, lookups, cfg, drawn[0], TOTAL_STEPS)
    return cfg, state, losses[0], loss, grads, P, rstate


def test_the_loss(one_step):
    _, _, got, want, _, _, _ = one_step
    assert got == pytest.approx(want, rel=1e-5)


def test_every_dense_gradient(one_step):
    cfg, state, _, _, grads, _, _ = one_step
    mu = state.opt_state[0]["mu"]
    assert set(mu) == set(grads)
    for n, g in grads.items():
        got = mu[n] / (1 - cfg["adam_b1"])
        scale = float(g.abs().max())
        if n.endswith("attn.k_proj.bias"):
            scale = max(scale, max(float(x.abs().max()) for x in grads.values()) * 1e-3)
        assert scale > 0 or n == "mask_token", n  # the [MASK] token is not used here
        torch.testing.assert_close(got, g, rtol=0, atol=1e-4 * scale + 1e-12, msg=n)


def test_each_tables_touched_rows_and_their_update(one_step):
    _, state, _, _, _, P, rstate = one_step
    p0 = make_weights(small_cfg(), SEED, CPU)
    for f in ref.ID_FEATURES:
        n = f"embed.tables.{f}.weight"
        got, want = state.params[n] - p0[n], P[n] - p0[n]
        rows = (want != 0).any(-1)
        assert torch.equal((got != 0).any(-1), rows), n
        assert int(rows.sum()) > 0
        top = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * top, msg=n)
        torch.testing.assert_close(state.opt_state[1][n], rstate["accum"][n], rtol=1e-5,
                                   atol=0, msg=n)


def test_adamw_step():
    cfg = small_cfg(warmup_steps=1)
    _, state, drawn, _ = _program(cfg, 2)
    P = {n: t.clone() for n, t in make_weights(cfg, SEED, CPU).items()}
    rstate = _reference_state(P)
    steps = []
    for b in drawn[:2]:
        loss, grads, lookups = ref.gradients(P, cfg, b, F32Ops(), rows=5)
        ref.apply_update(P, rstate, grads, lookups, cfg, b, TOTAL_STEPS)
        steps.append(grads)
    # a one-step warmup: the first step at 0, the second at the peak
    lr = ref.learning_rate(cfg, 1, TOTAL_STEPS)
    assert ref.learning_rate(cfg, 0, TOTAL_STEPS) == 0 and lr == cfg["learning_rate"]
    assert rstate["count"] == state.opt_state[0]["count"] == 2
    # an element whose gradient is under 1e-6 of the largest in both steps
    # holds rounding noise, and adam moves it by up to lr whatever its size
    noise = [1e-6 * max(float(g.abs().max()) for g in grads.values()) for grads in steps]
    p0 = make_weights(cfg, SEED, CPU)
    for n in rstate["mu"]:
        free = (steps[0][n].abs() < noise[0]) & (steps[1][n].abs() < noise[1])
        err = (state.params[n] - P[n]).detach().abs()
        assert float(torch.where(free, 0.0, err).max()) <= 2e-6, n
        assert float(torch.where(free, err, 0.0).max()) <= 2 * lr, n
        assert float((P[n] - p0[n]).abs().max()) > 0, n
    assert all(bool(((s[n].abs() < z).all())) for n in rstate["mu"]
               if n.endswith("attn.k_proj.bias") for s, z in zip(steps, noise))


def test_bfloat16_program_reads_the_reference_loss():
    """The cell's own precision: the loss within 1% of the float32
    reference's (bfloat16 keeps 8 bits of mantissa; the tower's residual
    stream and products round to it)."""
    cfg = small_cfg(compute_dtype="bfloat16")
    _, _, drawn, losses = _program(cfg, 1)
    P = make_weights(cfg, SEED, CPU)
    want, _, _ = ref.gradients(P, cfg, drawn[0], F32Ops(), rows=8)
    assert losses[0] == pytest.approx(want, rel=1e-2)
    assert losses[0] != pytest.approx(want, rel=1e-6)  # the two precisions differ


def _perfbench_imports(path, seen):
    """Top-level names imported by ``path`` and, in turn, by every module of
    ``perfbench`` it imports."""
    tops = set()
    for node in ast.walk(ast.parse(open(path).read())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for name in names:
            tops.add(name.split(".")[0])
            if name.startswith("perfbench.") and name not in seen:
                seen.add(name)
                tops |= _perfbench_imports(os.path.join(ROOT, *name.split(".")) + ".py", seen)
    return tops


def test_the_reference_imports_neither_the_port_nor_jax():
    tops = _perfbench_imports(os.path.join(ROOT, "perfbench/reference/kuaiformer.py"), set())
    assert "torch" in tops
    assert not tops & {"recommend_tpu_torch", "recommend_tpu", "jax", "jaxlib", "flax", "optax"}
