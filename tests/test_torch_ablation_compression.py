"""The compression ablation (``examples_torch/ablation_compression.py``)
beside ``examples/ablation_compression.py`` on the CPU:

- both arms' configs, field for field, against the ones the JAX script
  builds (``examples/ablation_compression.py:72-86``) at its default L = 64
  and at L = 16;
- the retrieval tower under both schedules (compressed: groups, then a raw
  tail; raw: one group of group size 1, which the port had not run before)
  at narrow widths, from converted JAX params: the forward at f32 1e-5 of
  max|ref|, and two float32 steps at dropout 0 against JAX's
  ``RetrievalTrainer``, each step from JAX's state (one interest, as in
  ``test_torch_retrieval_training_steps.py``, whose tolerances these are);
- both scripts' ``main`` at ``--steps 3 --seq 16 --num_users 100``: the
  same JSON keys and token counts on every printed line. (At ``--num_users
  60`` both scripts loop for ever: 6 held-out users make 159 examples, fewer
  than one batch of 256, and the held-out batches never end an epoch.)
"""

import dataclasses
import json

import pytest
import torch

from examples_torch import ablation_compression
from recommend_tpu import config as jconfig
from tests.test_torch_examples_jax import _jax_main
from tests.test_torch_retrieval import close, first_batch, jax_in, jax_tower, torch_in
from tests.test_torch_retrieval_training_steps import (assert_metrics_close,
                                                       assert_state_close, both_step, converted,
                                                       start)

torch.set_num_threads(1)

SMALL = ["--steps", "3", "--seq", "16", "--num_users", "100"]
NARROW = dict(embed_dim=32, num_layers=1, num_heads=2, ffn_dim=64, video_vocab_size=500,
              batch_size=8, dropout_rate=0.0, compute_dtype="float32")


def jax_configs(L):
    """The JAX script's two configs, built as its ``main`` builds them."""
    common = dict(
        max_seq_len=L, num_layers=4, warmup_steps=200, batch_size=256,
        video_vocab_size=10000, use_sparse_embedding_updates=True,
        dropout_rate=0.1,
    )
    cfg_comp = jconfig.get_config(
        "retrieval_base",
        compression_schedule=((L // 2, L // 8), (L // 4, L // 8), (L // 4, 1)),
        **common,
    )
    cfg_raw = jconfig.get_config(
        "retrieval_base", compression_schedule=((L, 1),), **common
    )
    return cfg_comp, cfg_raw


@pytest.mark.parametrize("L,tokens", [(64, (22, 64)), (16, (10, 16))])
def test_both_arms_configs_match_the_jax_scripts_field_for_field(L, tokens):
    for port, ref in zip(ablation_compression.configs(L), jax_configs(L)):
        assert port.to_dict() == ref.to_dict()
    assert tuple(c.num_compressed_tokens for c in ablation_compression.configs(L)) == tokens


ARMS = {"compressed": 0, "raw": 1}


def narrow(arm, **overrides):
    """The arm's JAX config at L = 16, cut to narrow widths at float32."""
    return dataclasses.replace(jax_configs(16)[ARMS[arm]], **NARROW, **overrides)


@pytest.mark.parametrize("arm", ARMS)
def test_the_tower_forward_matches_jax_under_each_schedule(arm):
    cfg = narrow(arm)
    batch = first_batch(cfg)
    model, params, tower = jax_tower(cfg, batch)
    with torch.no_grad():
        got = tower(*torch_in(batch))
    close(got, model.apply(params, *jax_in(batch)), 1e-5)


@pytest.mark.parametrize("arm", ARMS)
def test_two_steps_match_the_jax_trainer_under_each_schedule(arm):
    """Each step starts both sides from JAX's state: after one step the
    tables differ by ~1e-6 (rounding), and the second step, steep at these
    widths (grad norm ~760), carries that to 1.4e-5 on one element of the
    category table; from one state the second step agrees as the first."""
    cfg = narrow(arm, num_query_tokens=1)
    jt, js, tt, ts, batches = start(cfg, "single")
    for batch in batches[:2]:
        lr = tt.optimizer.lr(ts.step)
        js, jm, ts, tm = both_step(jt, js, tt, ts, batch, cfg, "single")
        assert_metrics_close(tm, jm)
        assert_state_close(ts, js, tt.cfg, lr)
        params, opt, accums = converted(js, tt.cfg)
        ts = tt.init_state(params, opt_state=opt, accums=accums)
    assert ts.step == 2 == int(js.step)


def _printed(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_main_prints_the_jax_scripts_lines(monkeypatch, capsys, tmp_path):
    _jax_main(monkeypatch, "ablation_compression", SMALL)
    jax_lines = _printed(capsys)
    out = tmp_path / "ablation.json"
    assert ablation_compression.main(["--device", "cpu", "--output", str(out), *SMALL]) == 0
    port_lines = _printed(capsys)
    assert len(port_lines) == len(jax_lines) == 3
    for got, ref in zip(port_lines, jax_lines):
        assert list(got) == list(ref)
        assert got.get("tokens") == ref.get("tokens")
        assert got.get("label") == ref.get("label")
    assert port_lines[2]["compression_token_reduction"] == "16→10"
    assert all(0.0 <= line[k] <= 1.0 for line in port_lines[:2]
               for k in ("recall@10", "recall@50"))
    saved = json.loads(out.read_text())
    assert [saved["compressed"], saved["raw"], saved["summary"]] == port_lines
