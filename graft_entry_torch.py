"""The PyTorch/CUDA port's counterparts of ``__graft_entry__.py``.

- ``entry()`` -> ``(fn, args)``: ``fn(*args)`` runs the flagship ranking
  model's forward on one card (``entry(device="cpu")`` on the CPU) at the
  tiny config, random weights from seed 0; ``args[0]`` is the state dict,
  so another one (e.g. ``convert.params_from_flax`` of the JAX entry's
  params) may take its place.
- ``dryrun_multichip(n)``: one full ranking training step on an n-rank
  ('data', 'model') mesh (the batch over ``data``; with ``model`` = 2 the
  dedicated NS stacks split over it), then the production combination: an
  item table of ``ROW_SHARD_MIN_VOCAB`` rows, row-sharded over ``model``,
  with rowwise touched-row sparse updates. It joins n new ranks
  (``parallel.launch``: NCCL, one card a rank; gloo with ``device="cpu"``),
  or, called on a rank of a process group of n ranks, runs there.

Usage:
    python graft_entry_torch.py                 # the card: entry, then every card
    python graft_entry_torch.py --device cpu    # the CPU: entry, then 8 gloo ranks
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import torch
import torch.distributed as dist

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.config import get_config
from recommend_tpu_torch.convert import init_params
from recommend_tpu_torch.data.pipeline import ranking_batches
from recommend_tpu_torch.data.synthetic import make_ranking_data
from recommend_tpu_torch.models.ranking import RankingModel
from recommend_tpu_torch.parallel import make_mesh
from recommend_tpu_torch.parallel.launch import launch
from recommend_tpu_torch.parallel.sharding import ROW_SHARD_MIN_VOCAB
from recommend_tpu_torch.training.ranking_trainer import RankingTrainer

ITEM_TABLE = "tokenizer.embeds.item_id.weight"


def _tiny_cfg(n_ns: int = 4):
    return get_config(
        "ranking_small",
        embed_dim=64,
        num_layers=2,
        num_heads=2,
        ffn_dim=128,
        num_ns_tokens=n_ns,
        pyramid_ratios=(0.5, 0.25),
        feature_vocab_sizes=(
            ("user_id", 1000), ("age_bucket", 16), ("gender", 4), ("city", 64),
            ("item_id", 2000), ("category", 50), ("brand", 100), ("price_bucket", 16),
            ("hour", 24), ("weekday", 7), ("device", 8),
        ),
        feature_embed_dim=16,
        seq_item_feature_dim=16,
        use_mixed_precision=False,
        dropout_rate=0.0,
        dense_lr=1e-3,
        dense_momentum=0.9,
        sparse_lr=0.05,
        batch_size=16,
    )


def _tiny_batch(cfg, batch_size: int):
    data = make_ranking_data(cfg, num_samples=max(64, batch_size * 2),
                             max_seq_per_feature=8, seed=0)
    return next(iter(ranking_batches(data, cfg, batch_size=batch_size, num_epochs=1)))


def entry(device=None):
    """Returns (fn, args) where ``fn(*args)`` runs the flagship ranking
    forward (per-task logits) on one card, or on ``device``."""
    device = resolve_device(device, "entry")
    cfg = _tiny_cfg()
    with torch.device("meta"):
        model = RankingModel(cfg)
    batch = _tiny_batch(cfg, cfg.batch_size)
    args_in = tuple({k: torch.as_tensor(v, device=device) for k, v in batch[group].items()}
                    for group in ("non_seq", "sequences", "seq_valid"))
    params = init_params(cfg, seed=0, device=device)

    def fn(params, non_seq, sequences, seq_valid):
        with torch.no_grad():
            return torch.func.functional_call(model, params, (non_seq, sequences, seq_valid))

    return fn, (params, *args_in)


def _step(cfg, mesh, batch_size: int):
    """One training step on the mesh from seed 0 -> (trainer, state, loss)."""
    batch = _tiny_batch(cfg, batch_size)
    trainer = RankingTrainer(cfg, mesh=mesh)
    state = trainer.init_state(seed=0)
    state, metrics = trainer._train_step(state, trainer._put_batch(batch),
                                         torch.Generator().manual_seed(0))
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: loss {loss}")
    return trainer, state, loss


def _dryrun(n_devices: int, device) -> dict:
    """Both steps on this rank of an n-rank process group -> the losses."""
    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) on {dist.get_world_size()} ranks")
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(data=n_devices // model_axis, model=model_axis, device=device)
    lead = dist.get_rank() == 0
    # n_ns divisible by the model axis: the dedicated stacks shard over it
    n_ns = 4 if model_axis == 2 else 3
    batch_size = max(_tiny_cfg().batch_size, n_devices * 2)
    _, _, loss = _step(_tiny_cfg(n_ns=n_ns), mesh, batch_size)
    if lead:
        print(f"dryrun_multichip({n_devices}): mesh={mesh.shape} loss={loss:.4f} ok",
              flush=True)

    # the flagship combination: a row-sharded item table (vocab >=
    # ROW_SHARD_MIN_VOCAB: ('model', None)) with touched-row sparse updates
    vocabs = dict(_tiny_cfg().feature_vocab_sizes)
    vocabs["item_id"] = ROW_SHARD_MIN_VOCAB
    cfg_sp = dataclasses.replace(
        _tiny_cfg(n_ns=n_ns),
        use_sparse_embedding_updates=True,
        sparse_update_mode="rowwise",
        feature_vocab_sizes=tuple(vocabs.items()),
    )
    trainer, state, loss_sp = _step(cfg_sp, mesh, batch_size)
    rows = state.params[ITEM_TABLE].shape[0]
    if model_axis > 1 and (ITEM_TABLE not in trainer.sharded
                           or rows != ROW_SHARD_MIN_VOCAB // model_axis):
        raise RuntimeError(f"dryrun_multichip: the item table holds {rows} rows a rank, "
                           f"not {ROW_SHARD_MIN_VOCAB} // {model_axis}")
    if lead:
        print(f"dryrun_multichip({n_devices}): sparse row-sharded table "
              f"[{ROW_SHARD_MIN_VOCAB} rows, {rows} a rank] loss={loss_sp:.4f} ok", flush=True)
    return {"mesh": dict(mesh.shape), "loss": loss, "sparse_loss": loss_sp,
            "item_table_rows_a_rank": rows}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One full DP/model-sharded ranking step and the row-sharded sparse
    step over an n-rank mesh; returns rank 0's losses and layout."""
    dev = resolve_device(device, "dryrun_multichip")
    if dist.is_initialized():
        return _dryrun(n_devices, dev.type)
    return launch(n_devices, _dryrun, n_devices, dev.type, device=dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device; the card unless given (cpu to run on the CPU)")
    args = p.parse_args(argv)
    device = resolve_device(args.device, "graft_entry_torch")
    fn, fn_args = entry(device)
    out = fn(*fn_args)
    print("entry forward:", {k: tuple(v.shape) for k, v in out.items()})
    dryrun_multichip(torch.cuda.device_count() if device.type == "cuda" else 8, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
