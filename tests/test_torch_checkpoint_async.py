"""The port's asynchronous checkpoint save, held to orbax's semantics on the
CPU:

- ``save`` returns once the state is copied, before the write: an in-place
  update right after it does not reach the checkpoint;
- the JAX manager (orbax) and the port's agree on ``latest_step`` and on the
  values restored over the same save sequence, and both keep
  ``max_to_keep``;
- a writer that raises surfaces at the next ``wait``, ``save`` or ``close``;
- a reader of the directory (another manager, an engine's
  ``from_checkpoint``) waits for the pending write; a process that exits
  with a save pending finishes it;
- ``RankingTrainer.train`` and ``RetrievalTrainer.train`` end with the last
  checkpoint on disk, as the JAX trainers' ``wait()`` leaves it.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from recommend_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
from recommend_tpu_torch.config import get_config
from recommend_tpu_torch.data.pipeline import retrieval_batches
from recommend_tpu_torch.data.synthetic import make_retrieval_data
from recommend_tpu_torch.training import checkpoint
from recommend_tpu_torch.training.checkpoint import CheckpointManager
from recommend_tpu_torch.training.ranking_trainer import RankingTrainer
from recommend_tpu_torch.training.trainer import RetrievalTrainer
from tests.test_torch_checkpoint import _assert_trees_equal, _batches, _train_cfg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def held_writes(monkeypatch):
    """``torch.save`` blocked until the returned event is set: the writer
    thread starts but writes nothing until the test lets it."""
    go = threading.Event()
    real = torch.save

    def held(obj, path, *args, **kwargs):
        assert go.wait(30), "the test never released the writer"
        return real(obj, path, *args, **kwargs)

    monkeypatch.setattr(torch, "save", held)
    return go


def _state(step):
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3) * step,
              "table": torch.full((4, 2), float(step))}
    opt = ({"count": torch.tensor(step), "mu": {"w": torch.ones(2, 3) * step}},
           {"table": torch.full((4, 2), 0.1 * step)})
    return params, opt


def test_an_in_place_update_after_save_returns_does_not_reach_the_checkpoint(
        tmp_path, held_writes):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    params, opt = _state(1)
    want_params = {k: v.clone() for k, v in params.items()}
    history = {"train": [{"step": 1, "loss": 0.5}]}
    mgr.save(1, params, opt, config_dict={"a": 1}, history=history)
    # save has returned; the writer has not written a byte yet
    assert not os.path.exists(mgr.path(1))
    for t in params.values():
        t.add_(100.0)
    opt[0]["count"].add_(5)
    opt[1]["table"].mul_(0.0)
    history["train"].append({"step": 2, "loss": 0.4})
    held_writes.set()
    mgr.wait()
    got = mgr.restore()
    assert got.step == 1
    _assert_trees_equal(got.params, want_params, "params")
    assert int(got.opt_state[0]["count"]) == 1
    assert torch.equal(got.opt_state[1]["table"], torch.full((4, 2), 0.1))
    assert len(json.load(open(tmp_path / "ck" / "history.json"))["train"]) == 1


def test_jax_and_port_managers_agree_over_one_save_sequence(tmp_path):
    jax_mgr = JaxCheckpointManager(str(tmp_path / "jax"), max_to_keep=2)
    port = CheckpointManager(str(tmp_path / "port"), max_to_keep=2)
    assert jax_mgr.latest_step() is None and port.latest_step() is None
    for step in (1, 2, 5):
        params, opt = _state(step)
        np_params = {k: v.numpy() for k, v in params.items()}
        np_opt = {"count": opt[0]["count"].numpy(), "mu": {"w": opt[0]["mu"]["w"].numpy()}}
        jax_mgr.save(step, np_params, np_opt)
        port.save(step, params, {"count": opt[0]["count"], "mu": opt[0]["mu"]})
        assert jax_mgr.latest_step() == port.latest_step() == step
    jax_mgr.wait()
    port.wait()
    like = {k: v.numpy() for k, v in _state(0)[0].items()}
    like_opt = {"count": np.zeros((), np.int64), "mu": {"w": np.zeros((2, 3), np.float32)}}
    j_step, j_params, j_opt = jax_mgr.restore(like, like_opt)
    got = port.restore()
    assert j_step == got.step == 5
    for k in like:
        np.testing.assert_array_equal(np.asarray(j_params[k]), got.params[k].numpy())
    assert int(j_opt["count"]) == int(got.opt_state["count"]) == 5
    np.testing.assert_array_equal(np.asarray(j_opt["mu"]["w"]), got.opt_state["mu"]["w"].numpy())
    # both keep max_to_keep = 2
    assert port.steps() == [2, 5]
    assert jax_mgr._mngr.all_steps() == [2, 5]
    jax_mgr.close()
    port.close()


def test_rotation_keeps_max_to_keep_and_leaves_no_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    for step in range(1, 8):
        mgr.save(step, *_state(step), config_dict={"step": step})
    mgr.wait()
    assert mgr.steps() == [5, 6, 7]
    assert sorted(os.listdir(mgr.directory)) == [
        "ckpt_00000005.pt", "ckpt_00000006.pt", "ckpt_00000007.pt", "config.json"]


@pytest.mark.parametrize("surface", ["wait", "save", "close"])
def test_a_writer_that_raises_surfaces_at_the_next_call(tmp_path, monkeypatch, surface):
    def full(obj, path, *args, **kwargs):
        raise OSError(28, "No space left on device")

    mgr = CheckpointManager(str(tmp_path / "ck"))
    monkeypatch.setattr(torch, "save", full)
    mgr.save(3, *_state(3))  # returns: the write has not been tried yet
    with pytest.raises(OSError, match="No space left"):
        if surface == "save":
            mgr.save(4, *_state(4))
        else:
            getattr(mgr, surface)()
    monkeypatch.undo()
    mgr.wait()  # raised once, not again
    assert not any(n.startswith("ckpt_") and n.endswith(".pt")
                   for n in os.listdir(mgr.directory))
    mgr.save(5, *_state(5))
    assert mgr.latest_step() == 5


def test_a_reader_of_the_directory_waits_for_the_pending_write(tmp_path, held_writes):
    d = str(tmp_path / "ck")
    CheckpointManager(d).save(2, *_state(2))
    results = {}
    reader = threading.Thread(
        target=lambda: results.update(step=CheckpointManager(d).latest_step()))
    reader.start()
    reader.join(0.5)
    assert reader.is_alive()  # blocked on the pending write
    held_writes.set()
    reader.join(30)
    assert results == {"step": 2}


def test_a_process_that_exits_with_a_save_pending_finishes_it(tmp_path):
    d = tmp_path / "ck"
    script = textwrap.dedent(f"""
        import sys, time, torch
        sys.path.insert(0, {str(ROOT)!r})
        from recommend_tpu_torch.training.checkpoint import CheckpointManager
        real = torch.save
        def slow(*args, **kwargs):
            time.sleep(1.0)
            return real(*args, **kwargs)
        torch.save = slow
        CheckpointManager({str(d)!r}).save(9, {{"w": torch.ones(3)}}, {{}})
        print("returned", flush=True)
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "returned"
    assert sorted(os.listdir(d)) == ["ckpt_00000009.pt"]
    got = torch.load(d / "ckpt_00000009.pt", weights_only=True)
    assert got["step"] == 9 and torch.equal(got["params"]["w"], torch.ones(3))


def _slow_writes(monkeypatch, seconds=0.3):
    import time

    real = torch.save

    def slow(*args, **kwargs):
        time.sleep(seconds)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "save", slow)


def test_ranking_trainer_train_ends_with_its_checkpoint_on_disk(tmp_path, monkeypatch):
    cfg = _train_cfg("rowwise")
    ck = tmp_path / "ck"
    _slow_writes(monkeypatch)
    RankingTrainer(cfg, device="cpu", checkpoint_dir=str(ck)).train(
        iter(_batches(cfg, 2)), 2, log_every=1)
    # no manager call in between: train() waited for its last save
    assert not checkpoint._WRITERS
    assert sorted(os.listdir(ck)) == ["ckpt_00000002.pt", "config.json", "history.json"]


def test_retrieval_trainer_train_ends_with_its_checkpoint_on_disk(tmp_path, monkeypatch):
    cfg = get_config("retrieval_small", embed_dim=32, num_layers=1, num_heads=2, ffn_dim=64,
                     max_seq_len=16, compression_schedule=((8, 4), (8, 1)),
                     video_vocab_size=500, warmup_steps=1, batch_size=8,
                     dropout_rate=0.0, compute_dtype="float32")
    data = make_retrieval_data(cfg, num_users=20, num_videos=200, seed=0)
    batches = list(retrieval_batches(data, cfg, batch_size=8, seed=0, num_epochs=1,
                                     use_native=False))[:2]
    ck = tmp_path / "ck"
    _slow_writes(monkeypatch)
    RetrievalTrainer(cfg, total_steps=4, checkpoint_dir=str(ck), device="cpu").train(
        iter(batches), 2, log_every=1)
    assert not checkpoint._WRITERS
    assert "ckpt_00000002.pt" in os.listdir(ck)


def test_many_threads_saving_leave_every_write_on_disk(tmp_path):
    """More saving threads than cores, on four shared directories, with the
    interpreter switching threads often: every manager's last step lands,
    the directory's readers see the newest, and no writer is left
    registered."""
    n_threads = 2 * (os.cpu_count() or 4)
    dirs = [str(tmp_path / f"d{i}") for i in range(4)]
    errors = []

    def work(t):
        try:
            mgr = CheckpointManager(dirs[t % len(dirs)], max_to_keep=2)
            for step in range(3):
                mgr.save(100 * t + step, {"w": torch.full((64,), float(t))}, {})
            mgr.wait()
        except Exception as e:  # collected, asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert not checkpoint._WRITERS
    for i, d in enumerate(dirs):
        mine = [t for t in range(n_threads) if t % len(dirs) == i]
        steps = CheckpointManager(d).steps()
        # each directory keeps two checkpoints, every one a step some thread wrote
        assert len(steps) == 2 and all(s // 100 in mine and s % 100 < 3 for s in steps)
        got = CheckpointManager(d).restore()
        assert torch.equal(got.params["w"], torch.full((64,), float(got.step // 100)))
