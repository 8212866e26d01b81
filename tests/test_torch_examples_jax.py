"""The port's entry points beside the JAX scripts they port, both run in this
process on the CPU at the same flags: ``train_retrieval --quick-start``
writes the same files with the same keys, and ``serving_demo --tiny``
prints the same sections with the same counts and stats keys. The weights
differ (each package draws its own), so values are compared only where
they do not depend on them.

``examples/train_ranking.py`` is not run: at ``ranking_small`` it computes
in bf16, and the CPU backend has no BF16 x BF16 dot, so the JAX script
stops on the CPU at its first step; ``tests/test_torch_examples.py`` holds
the port's files to the list in its code.
"""

import importlib.util
import json
import re
import sys
from pathlib import Path

import torch

from examples_torch import serving_demo, train_retrieval

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _jax_main(monkeypatch, name, argv):
    """Run ``examples/<name>.py``'s ``main`` with ``argv`` as its command line."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()


def _tree(root: Path) -> set:
    """Every file under ``root``, with a checkpoint's own layout (orbax's step
    directory, the port's ``ckpt_<step>.pt``) read as ``ckpt/<step>`` and the
    JAX trainer's TensorBoard directory left out."""
    out = set()
    for p in root.rglob("*"):
        rel = p.relative_to(root).parts
        if rel[:2] == ("logs", "train"):
            continue
        if rel[0] == "ckpt" and len(rel) > 1:
            m = re.fullmatch(r"(?:ckpt_)?(\d+)(?:\.pt)?", rel[1])
            if m:
                out.add(f"ckpt/{int(m.group(1))}")
                continue
        if p.is_file():
            out.add("/".join(rel))
    return out


def _keys(path: Path) -> set:
    return set(json.loads(path.read_text()))


def test_train_retrieval_quick_start_writes_what_the_jax_script_writes(monkeypatch, tmp_path):
    argv = ["--quick-start", "--batch_size", "16"]
    _jax_main(monkeypatch, "train_retrieval", [*argv, "--model_dir", str(tmp_path / "jax")])
    out = train_retrieval.run(train_retrieval.parse_args(
        [*argv, "--model_dir", str(tmp_path / "port"), "--device", "cpu"]))
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    assert _tree(port_dir) == _tree(jax_dir) == {
        "config.json", "eval.json", "ckpt/100", "ckpt/config.json", "ckpt/history.json",
        "logs/train.jsonl"}
    # the saved configs agree field for field, not only in their keys
    assert json.loads((port_dir / "config.json").read_text()) == json.loads(
        (jax_dir / "config.json").read_text())
    for name in ("eval.json", "ckpt/history.json"):
        assert _keys(port_dir / name) == _keys(jax_dir / name), name
    records = [[json.loads(line) for line in (d / "logs" / "train.jsonl").read_text().splitlines()]
               for d in (port_dir, jax_dir)]
    assert [r["step"] for r in records[0]] == [r["step"] for r in records[1]]
    assert [set(r) for r in records[0]] == [set(r) for r in records[1]]
    assert out["state"].step == 100


def _sections(text: str) -> dict:
    """The demo's printout: its section headers, the sweep's candidate counts,
    the engine's request counts and stats keys, and the recommendations'
    count and keys."""
    lines = text.splitlines()
    stats = next(eval(line.split(":", 1)[1]) for line in lines  # noqa: S307 - a dict repr
                 if line.startswith("  engine stats:"))
    top = next(eval(line.split(":", 1)[1]) for line in lines  # noqa: S307 - a list repr
               if line.startswith("  top-5:"))
    rstats = next(eval(line.split(":", 1)[1]) for line in lines  # noqa: S307 - a dict repr
                  if line.startswith("  stats:"))
    return dict(
        headers=[line for line in lines if line.startswith("== ")],
        sweep=[int(line.split()[0]) for line in lines if "ms/request" in line],
        loop=[line.split(" in ")[0] for line in lines if "QPS" in line and "requests" in line],
        counts={k: stats[k] for k in ("total", "success", "failure")},
        stats_keys=set(stats),
        top=(len(top), [set(r) for r in top]),
        retrieval_stats_keys=set(rstats),
        retrieval_requests=rstats["requests"],
    )


def test_serving_demo_tiny_prints_what_the_jax_demo_prints(monkeypatch, capsys):
    argv = ["--tiny", "--requests", "10", "--candidates", "20"]
    _jax_main(monkeypatch, "serving_demo", argv)
    jax_out = capsys.readouterr().out
    serving_demo.run(serving_demo.parse_args([*argv, "--device", "cpu"]))
    port_out = capsys.readouterr().out
    got, want = _sections(port_out), _sections(jax_out)
    assert got == want
    assert want["sweep"] == [1, 10, 50, 20] and want["counts"]["total"] == 34
