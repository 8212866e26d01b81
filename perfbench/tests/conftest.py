"""Shared set-up of the benchmark's tests: the repository root on the path,
the ``chip`` marker, and the cells cut to a size the CPU runs in seconds."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ("onetrans_l.train_s1190", "onetrans_s.train_b2048")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips, with its reason, where there is none")


def small(cfg: dict, **overrides) -> dict:
    """``cfg`` with the same structure at a CPU test's size: vocabularies of
    at most 500 ids, d 32, FFN 64, 4 NS tokens, 16-wide features."""
    out = json.loads(json.dumps(cfg))
    out["feature_vocab_sizes"] = [[k, min(v, 500)] for k, v in out["feature_vocab_sizes"]]
    out.update(embed_dim=32, ffn_dim=64, num_ns_tokens=4, feature_embed_dim=16,
               seq_item_feature_dim=16, task_head_hidden=16)
    out.update(overrides)
    return out


SMALL_TRAFFIC = {"kind": "train", "seq_len": 24, "batch_size": 16, "placed_batches": 4,
                 "warm_steps": 1, "profiled_steps": 1, "id_zipf": 1.1}


@pytest.fixture(params=CELLS)
def cell(request):
    """A cell's ``run.load_cell`` info, cut by ``small``."""
    from perfbench.run import load_cell

    info = load_cell(request.param)
    info["config"] = small(info["config"])
    info["traffic"] = dict(SMALL_TRAFFIC)
    info["name"] = request.param
    return info
