"""``quality_torch.py --track onetrans``, the port of the OneTrans replica
track of ``examples/quality_parity.py`` (``run_onetrans``), on the CPU:

- (a) the track's ``RankingConfig`` for geometries S and L, on the card and
  on the CPU, equals field for field the JAX package's
  ``get_config("ranking_base", **base)`` built from a copy of the JAX
  recipe's arguments (``quality_parity.py:223-265``);
- (b) its small-scale replica, v1, v2 and v2 with overrides, with and
  without a validation split, equals ``make_onetrans_replica`` of the JAX
  package on the same seed bit for bit, and its four oracle anchors equal
  JAX's ``exact_auc`` of the same debug terms to 1e-12;
- (c) a run of all three models for one epoch writes the JAX track's JSON
  (``quality_parity.py:462-509``): every key, ``selected`` equal to the
  final metrics when the last epoch is selected, the lifts as
  ``lift_block`` computes them. The geometry is cut to 2 layers at d 32,
  the replica to 12,000 impressions at batch 64 and the embedding widths to
  16, so that the three models train in about 25 s here;
- (d) ``quality_torch_from_init.py`` starts OneTrans from a given initial
  state dict (on the card: JAX's own draw).
"""

import dataclasses
import json

import pytest
import torch

import quality_torch as q
from recommend_tpu.config import get_config as jget_config
from recommend_tpu.data.replica import make_onetrans_replica as jmake_replica
from recommend_tpu.training.metrics import exact_auc as jexact_auc
from recommend_tpu_torch.config import get_config as tget_config
from tests.test_torch_replica import _same_data

torch.set_num_threads(1)


def jax_base(scale, geometry, on_tpu, dense_lr=1e-3, clip_norm=90.0, sparse_lr=0.02,
             sparse_lr_init=0.0, weight_decay=0.0):
    """A copy of ``run_onetrans``'s sizes, geometries and ``base`` dict
    (``examples/quality_parity.py:207-265``)."""
    full_scale = scale == "full"
    num_users = 5_000 if full_scale else 150
    num_items = 2_000 if full_scale else 400
    batch = 512 if full_scale else 128
    geo = {
        "S": dict(embed_dim=256, num_layers=6, num_heads=2, ffn_dim=1024,
                  pyramid_ratios=(0.5, 0.3, 0.2, 0.1, 0.05, 0.03)),
        "L": dict(embed_dim=384, num_layers=8, num_heads=3, ffn_dim=1536,
                  pyramid_ratios=(0.5, 0.3, 0.2, 0.1, 0.05, 0.03, 0.02, 0.01)),
    }[geometry]
    return dict(
        **geo,
        num_ns_tokens=12,
        batch_size=batch, use_mixed_precision=on_tpu, dropout_rate=0.0,
        feature_embed_dim=128, seq_item_feature_dim=128,
        use_sparse_embedding_updates=True, sparse_update_mode="rowwise",
        use_flash_attention=on_tpu,
        feature_vocab_sizes=(
            ("user_id", num_users + 1), ("age_bucket", 16), ("gender", 4),
            ("city", 32), ("item_id", num_items + 1), ("category", 200),
            ("brand", 500), ("price_bucket", 16), ("hour", 24),
            ("weekday", 7), ("device", 8),
        ),
        dense_optimizer="adamw" if weight_decay > 0 else "adam",
        dense_weight_decay=weight_decay,
        dense_lr=dense_lr, dense_momentum=0.9,
        gradient_clip_norm=clip_norm,
        sparse_lr=sparse_lr,
        sparse_lr_init=sparse_lr_init,
    )


# the recipes of the quality_r05 board: S at its defaults, L at lr 5e-4 and
# sparse lr 0.05, and an adamw variant
RECIPES = {
    "S": ("S", {}),
    "L": ("L", dict(dense_lr=5e-4, sparse_lr=0.05)),
    "S_adamw": ("S", dict(weight_decay=1e-3, clip_norm=1.0, sparse_lr_init=0.01)),
}


@pytest.mark.parametrize("on_card", [True, False], ids=["card", "cpu"])
@pytest.mark.parametrize("scale", ["full", "small"])
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_the_track_config_equals_jax_field_for_field(recipe, scale, on_card):
    geometry, kw = RECIPES[recipe]
    want = jget_config("ranking_base", **jax_base(scale, geometry, on_card, **kw))
    got = tget_config("ranking_base", **q.onetrans_base(scale, geometry, on_card, **kw))
    assert [(f.name, getattr(got, f.name)) for f in dataclasses.fields(got)] == [
        (f.name, getattr(want, f.name)) for f in dataclasses.fields(want)]
    assert got.use_mixed_precision == got.use_flash_attention == on_card
    assert q.onetrans_sizes(scale)["batch"] == want.batch_size


REPLICAS = {
    "v1": ("v1", 0.05, None),
    "v1_no_val": ("v1", 0.0, None),
    "v2": ("v2", 0.05, None),
    "v2_overrides": ("v2", 0.05, dict(match=4.0, alpha=-3.0)),
}


@pytest.mark.parametrize("case", sorted(REPLICAS))
def test_the_small_replica_and_its_anchors_equal_jax(case):
    version, val_frac, overrides = REPLICAS[case]
    jcfg = jget_config("ranking_base", **jax_base("small", "S", False))
    tcfg = tget_config("ranking_base", **q.onetrans_base("small", "S", False))
    tr, val, ev, anchors = q.make_replica(tcfg, "small", 0, version, val_frac, overrides)

    # the JAX recipe's generator arguments (quality_parity.py:267-292)
    gen_kw = dict(q.REPLICA_V2) if version == "v2" else {}
    if gen_kw and overrides:
        aff, match, price, hour, alpha = gen_kw["signal_weights"]
        order, cross = gen_kw["signal_weights_v2"]
        gen_kw["signal_weights"] = (aff, overrides.get("match", match), price, hour,
                                    overrides.get("alpha", alpha))
        gen_kw["signal_weights_v2"] = (overrides.get("order", order),
                                       overrides.get("cross", cross))
    dbg = {}
    parts = jmake_replica(jcfg, num_users=150, num_items=400, num_impressions=50_000, seed=0,
                          debug_out=dbg, val_frac=val_frac, **gen_kw)
    if val_frac > 0:
        jtr, jval, jev = parts
        _same_data(val, jval)
    else:
        jtr, jev = parts
        assert val is ev
    _same_data(tr, jtr)
    _same_data(ev, jev)
    m = dbg["is_eval"]
    want = {
        "latent_bayes_ctr_auc": jexact_auc(dbg["bayes_logit"][m], dbg["y_ctr"][m]),
        "observable_ceiling_ctr_auc": jexact_auc(dbg["observable_logit"][m], dbg["y_ctr"][m]),
        "latent_bayes_cvr_auc": jexact_auc(dbg["bayes_cvr_score"][m], dbg["y_cvr"][m]),
        "observable_ceiling_cvr_auc": jexact_auc(dbg["observable_cvr_score"][m],
                                                 dbg["y_cvr"][m]),
    }
    assert set(anchors) == set(want)
    for k, v in want.items():
        assert abs(anchors[k] - v) <= 1e-12, k
        assert 0.5 < anchors[k] < 1.0, k


# quality_parity.py:462-509
TOP_KEYS = {"config", "scale", "geometry", "replica_version", "recipe", "dataset", "onetrans",
            "din_baseline", "ns_only_baseline", "lift_vs_baseline_pct",
            "lift_vs_baseline_pct_selected", "lift_baseline", "reference_anchors"}
DATASET_KEYS = {"num_users", "num_items", "train_impressions", "val_impressions",
                "eval_impressions", "latent_bayes_ctr_auc", "observable_ceiling_ctr_auc",
                "latent_bayes_cvr_auc", "observable_ceiling_cvr_auc", "scale_note"}
MODEL_KEYS = {"train_seconds", "train_epochs", "examples_per_s", "selected", "selected_epoch",
              "convergence_curve"}


def _lift(a, b):
    return {k: round((a[k] - b[k]) / abs(b[k]) * 100, 3)
            for k in ("ctr_auc", "ctr_uauc", "cvr_auc", "cvr_uauc")}


@pytest.fixture
def tiny_track(monkeypatch):
    """The track at 2 layers, d 32, 12,000 impressions, batch 64 and
    embedding widths 16."""
    sizes, base = q.onetrans_sizes, q.onetrans_base
    monkeypatch.setitem(q.ONETRANS_GEOMETRY, "S", dict(
        embed_dim=32, num_layers=2, num_heads=2, ffn_dim=64, pyramid_ratios=(0.5, 0.25)))
    monkeypatch.setattr(q, "onetrans_sizes",
                        lambda scale: {**sizes(scale), "num_impressions": 12_000, "batch": 64})
    monkeypatch.setattr(q, "onetrans_base", lambda *a, **kw: {
        **base(*a, **kw), "feature_embed_dim": 16, "seq_item_feature_dim": 16})


def test_a_one_epoch_run_writes_the_jax_tracks_json(tiny_track, tmp_path):
    out = tmp_path / "q.json"
    assert q.main(["--track", "onetrans", "--scale", "small", "--epochs", "1", "--replica",
                   "v2", "--device", "cpu", "--output", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["device"] == "cpu" and report["seed"] == 0
    r = report["onetrans_replica"]
    assert set(r) == TOP_KEYS
    assert DATASET_KEYS <= set(r["dataset"])
    assert r["scale"] == "small" and r["geometry"] == "S" and r["replica_version"] == "v2"
    assert r["lift_baseline"] == "din"
    steps = r["dataset"]["train_impressions"] // 64
    for name in ("onetrans", "din_baseline", "ns_only_baseline"):
        m = r[name]
        assert MODEL_KEYS <= set(m), name
        assert m["train_epochs"] == 1 and m["train_steps"] == steps and m["selected_epoch"] == 1
        assert [c["epoch"] for c in m["convergence_curve"]] == [1]
        # the last epoch selected: its metrics are the final ones
        final = {k: v for k, v in m.items()
                 if k not in set(q.RUN_KEYS) | {"selected", "selected_epoch"}}
        assert m["selected"] == final, name
        assert m["num_params"] > 0 and m["state_bytes"] > 4 * m["num_params"]
        for t in ("ctr", "cvr"):
            assert 0.0 < m[f"{t}_auc"] < 1.0 and m["num_samples"] == (
                r["dataset"]["eval_impressions"] // 64 * 64)
    assert r["lift_vs_baseline_pct"] == _lift(r["onetrans"], r["din_baseline"])
    assert r["lift_vs_baseline_pct_selected"] == _lift(r["onetrans"]["selected"],
                                                       r["din_baseline"]["selected"])


def test_models_flag_and_lift_block_skip_what_is_missing(capsys):
    assert q._models("din,ns_only") == ("din", "ns_only")
    with pytest.raises(SystemExit):
        q.main(["--track", "onetrans", "--models", "din,bogus", "--device", "cpu"])
    assert "unknown models ['bogus']" in capsys.readouterr().err
    assert q.lift_block(None, {"ctr_auc": 0.7}) == {}
    assert q.lift_block({"ctr_auc": 0.77}, {"ctr_auc": 0.7, "cvr_auc": float("nan")}) == {
        "ctr_auc": 10.0}
    assert q.replica_kwargs("v1", {"match": 9.0}) == {}
    assert q.replica_kwargs("v2", {"order": 1.0}) == dict(
        signal_weights=(3.5, 2.0, -0.8, 0.5, -3.3), signal_weights_v2=(1.0, 2.8))


def test_models_and_max_steps_train_a_capped_subset(tiny_track, tmp_path):
    out = tmp_path / "q.json"
    assert q.main(["--track", "onetrans", "--scale", "small", "--models", "din",
                   "--max-steps", "3", "--float32", "--device", "cpu", "--output",
                   str(out)]) == 0
    r = json.loads(out.read_text())["onetrans_replica"]
    assert r["recipe"]["float32"] is True  # the CPU computes in float32 anyway
    assert r["onetrans"] is None and r["ns_only_baseline"] is None
    din = r["din_baseline"]
    # no epoch ended: nothing validated, nothing selected
    assert din["train_steps"] == 3 and din["convergence_curve"] == [] and "selected" not in din
    assert r["lift_vs_baseline_pct"] == {} and r["lift_vs_baseline_pct_selected"] is None


def test_a_run_from_a_given_initial_draw_starts_from_it(tiny_track, tmp_path, monkeypatch):
    """``quality_torch_from_init.py`` starts OneTrans from the file's state
    dict: the port's own seed-0 draw in the file gives ``quality_torch.py``'s
    run, another draw another run, and a file of other names raises."""
    import quality_torch_from_init as from_init
    from recommend_tpu_torch.convert import init_params
    from recommend_tpu_torch.training import ranking_trainer

    # the runner swaps the trainer's initializer for the process: put it back after
    monkeypatch.setattr(ranking_trainer, "init_params", ranking_trainer.init_params)
    argv = ["--track", "onetrans", "--scale", "small", "--models", "onetrans", "--max-steps",
            "3", "--device", "cpu"]
    cfg = tget_config("ranking_base", **q.onetrans_base("small", "S", False))
    metrics = ("ctr_auc", "cvr_auc", "ctr_logloss", "cvr_logloss")

    def auc(run, out):
        assert run([*argv, "--output", str(out)]) == 0
        m = json.loads(out.read_text())["onetrans_replica"]["onetrans"]
        return [m[k] for k in metrics]

    def from_file(seed):
        path = tmp_path / f"init{seed}.pt"
        torch.save(init_params(cfg, seed=seed, device="cpu"), path)
        return lambda a: from_init.main([str(path), *a])

    ref = auc(q.main, tmp_path / "ref.json")
    assert auc(from_file(0), tmp_path / "same.json") == ref
    assert auc(from_file(3), tmp_path / "other.json") != ref
    bad = tmp_path / "bad.pt"
    torch.save({"tokenizer.sep_token": torch.zeros(32)}, bad)
    with pytest.raises(KeyError, match="does not hold this model's parameters"):
        from_init.main([str(bad), *argv])
