"""``BENCHMARK.json`` against the contract's limits, each configuration file
against the preset or ``bench.py`` it stands for, and the import rule."""

import ast
import json
import os
import re

import pytest

from conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PERF = os.path.join(ROOT, "perfbench")


def _config(name):
    return json.load(open(os.path.join(ROOT, f"perfbench/configs/{name}.json")))


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_files():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(PERF, "metrics", m["name"] + ".py"))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\t" not in m["layer"] and len(m["layer"]) <= 200
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(PERF, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(PERF, "limits", w["name"] + ".json"))
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == _config(c["name"])["reduced"]


def test_onetrans_l_is_the_preset_as_it_stands():
    from recommend_tpu_torch.config import get_config

    f = _config("onetrans_l")
    want = get_config("ranking_base", **f["overrides"]).to_dict()
    want.pop("__config_class__")
    want.pop("batch_size")
    assert json.loads(json.dumps(want)) == f["config"]
    # widths, depth and heads as published; only dropout changed from the preset
    assert set(f["overrides"]) - {"use_flash_attention", "use_sparse_embedding_updates",
                                  "sparse_update_mode"} == {"dropout_rate"}
    assert (f["config"]["embed_dim"], f["config"]["num_layers"], f["config"]["num_heads"],
            f["config"]["ffn_dim"]) == (384, 8, 4, 1536)


def test_onetrans_s_is_bench_py():
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "get_config")
    fields = {k.arg: ast.literal_eval(k.value) for k in call.keywords}
    fields.pop("batch_size")
    cfg = _config("onetrans_s")["config"]
    for k, v in fields.items():
        assert cfg[k] == (list(v) if isinstance(v, tuple) else v), k


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for d, _, files in os.walk(PERF):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, PERF))
def test_import_rule(path):
    from perfbench.run import FORBIDDEN

    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(FORBIDDEN)
    if os.sep + "reference" + os.sep in path:
        assert "recommend_tpu_torch" not in tops


def test_the_rule_compares_whole_names():
    # recommend_tpu_torch begins with recommend_tpu and is allowed
    from perfbench.run import FORBIDDEN as RUN_FORBIDDEN

    assert "recommend_tpu_torch".split(".")[0] not in RUN_FORBIDDEN
    assert "recommend_tpu.config".split(".")[0] in RUN_FORBIDDEN
