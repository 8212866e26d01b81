"""The rank side of the port's mesh tests (``tests/test_torch_parallel_*.py``).

Each function runs on every gloo rank (``torch_parallel_ranks.run_ranks``)
with the inputs the test built from its JAX references, and returns numpy
results for the test to hold against them. This module imports the port
alone: a spawned rank imports it, and must not import JAX.
"""

from __future__ import annotations

import torch

from recommend_tpu_torch.config import RankingConfig, RetrievalConfig
from recommend_tpu_torch.ops.topk import sharded_topk_retrieval
from recommend_tpu_torch.parallel import (
    make_mesh,
    shard_table,
    shard_table_column,
    sharded_lookup,
    sharded_lookup_a2a,
    sharded_lookup_column,
)
from recommend_tpu_torch.parallel.sharding import block

_MESHES = {}


def mesh_of(data: int, model: int):
    """One mesh per shape for the rank's whole run (each builds groups)."""
    if (data, model) not in _MESHES:
        _MESHES[(data, model)] = make_mesh(data=data, model=model, device="cpu")
    return _MESHES[(data, model)]


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, torch.Tensor):  # a copy: the trainers update in place
        return x.detach().cpu().numpy().copy()
    return x


# ---------------------------------------------------------------------------
# the mesh, the lookups and the corpus scan (4 ranks)
# ---------------------------------------------------------------------------


def _lookup(mesh, case):
    table = torch.as_tensor(case["table"])
    ids = torch.as_tensor(case["ids"])
    w = torch.as_tensor(case["w"])
    n, r = mesh.shape["model"], mesh.rank("model")
    kind = case["kind"]
    if kind == "psum":
        t = shard_table(mesh, table).requires_grad_()
        out = sharded_lookup(mesh, t, ids)
        loss = (out * w).sum()  # the same on every rank
    elif kind == "a2a":
        t = shard_table(mesh, table).requires_grad_()
        out = sharded_lookup_a2a(mesh, t, block(ids, n, r), capacity=case["capacity"])
        loss = (out * block(w, n, r)).sum()  # this rank's rows
    else:
        t = shard_table_column(mesh, table).requires_grad_()
        out = sharded_lookup_column(mesh, t, block(ids, n, r))
        loss = (out * block(w, n, r)).sum()
    (g,) = torch.autograd.grad(loss, [t])
    with torch.no_grad():
        if kind != "psum":
            out = mesh.all_gather(out, "model")
        g = (mesh.all_gather(g.T.contiguous(), "model").T if kind == "column"
             else mesh.all_gather(g, "model"))
    return {"out": _np(out), "grad": _np(g), "block": tuple(t.shape)}


def lookups_and_scan(rank, inputs):
    meshes = {"default": make_mesh(device="cpu").shape,
              "model2": make_mesh(model=2, device="cpu").shape}
    m14 = mesh_of(1, 4)
    m22 = mesh_of(2, 2)
    coords = {"1x4": (m14.rank("data"), m14.rank("model")),
              "2x2": (m22.rank("data"), m22.rank("model"))}
    lookups = {name: _lookup(m14, case) for name, case in inputs["lookups"].items()}
    m41 = mesh_of(4, 1)
    scans = {}
    for name, case in inputs["scans"].items():
        items = shard_table(m41, torch.as_tensor(case["corpus"]), axis="data")
        s, i = sharded_topk_retrieval(m41, torch.as_tensor(case["interests"]), items,
                                      case["k"], chunk_rows=case.get("chunk_rows"))
        scans[name] = {"scores": _np(s), "ids": _np(i), "block": tuple(items.shape)}
    return {"meshes": meshes, "coords": coords, "lookups": lookups, "scans": scans}


# ---------------------------------------------------------------------------
# the retrieval trainer and the sharded index
# ---------------------------------------------------------------------------


def _retrieval_step(case):
    from recommend_tpu_torch.training.trainer import RetrievalTrainer

    mesh = mesh_of(*case["mesh"])
    cfg = RetrievalConfig.from_dict(case["cfg"])
    trainer = RetrievalTrainer(cfg, total_steps=10, mode=case["mode"], mesh=mesh)
    state = trainer.init_state(case["params"], opt_state=case["opt"], accums=case["accums"])
    blocks = {n: tuple(t.shape) for n, t in state.params.items()}
    if cfg.use_sparse_embedding_updates:
        blocks.update({f"accum:{n}": tuple(t.shape) for n, t in state.opt_state[1].items()})
    gen = torch.Generator().manual_seed(case.get("seed", 0))
    for batch, pos in zip(case["batches"], case["pos"]):
        state, metrics = trainer._train_step(state, trainer._put_batch(batch), gen,
                                             mask_positions=pos)
    params, opt_state = trainer._full_state(state.params, state.opt_state)
    evals = trainer.evaluate(state, iter(case["batches"]))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "params": _np(params),
            "accums": _np(opt_state[1]) if cfg.use_sparse_embedding_updates else None,
            "blocks": blocks, "eval": evals}


def _index(case):
    from recommend_tpu_torch.evaluation.retrieval_eval import RetrievalEvaluator
    from recommend_tpu_torch.serving.retrieval_service import RetrievalIndex

    mesh = mesh_of(*case["mesh"])
    cfg = RetrievalConfig.from_dict(case["cfg"])
    index = RetrievalIndex(cfg, case["params"], mesh=mesh, embed_batch=64)
    index.build(case["corpus"])
    out = {"block": tuple(index.item_embeddings.shape), "sharded": index.sharded,
           "fetch": _np(index.fetch_items(case["seeds"])),
           "similar": index.similar_items(case["seeds"], top_k=10),
           "search": index.search(torch.as_tensor(case["interests"]), 20)}
    index.update_items(case["update"])
    out["after_update"] = _np(index.fetch_items(case["seeds"]))
    out["after_update_block"] = tuple(index.item_embeddings.shape)
    evaluator = RetrievalEvaluator(cfg, case["params"], mesh=mesh)
    data, batches = evaluation_data(cfg)
    out["evaluation"] = evaluator.evaluate_retrieval(data, batches)
    out["evaluator_sharded"] = evaluator.index.sharded
    return out


def evaluation_data(cfg):
    """The port's synthetic corpus of 256 videos and its batches of 4."""
    from recommend_tpu_torch.data.pipeline import retrieval_batches
    from recommend_tpu_torch.data.synthetic import make_retrieval_data

    data = make_retrieval_data(cfg, num_users=10, num_videos=256, seed=0)
    return data, list(retrieval_batches(data, cfg, batch_size=4, num_epochs=1,
                                        use_native=False))


def retrieval(rank, inputs):
    return {"steps": {name: _retrieval_step(case) for name, case in inputs["steps"].items()},
            "index": {name: _index(case) for name, case in inputs.get("index", {}).items()}}


# ---------------------------------------------------------------------------
# the ranking trainer and checkpoints (2 x 2)
# ---------------------------------------------------------------------------


def _ranking_trainer(case, **kw):
    from recommend_tpu_torch.training.ranking_trainer import RankingTrainer

    cfg = RankingConfig.from_dict(case["cfg"])
    return RankingTrainer(cfg, mesh=mesh_of(*case["mesh"]), **kw)


def _ranking_steps(case):
    trainer = _ranking_trainer(case)
    state = trainer.init_state(case["params"], accums=case["accums"])
    sparse = trainer.cfg.use_sparse_embedding_updates
    blocks = {n: tuple(t.shape) for n, t in state.params.items()}
    if sparse:
        blocks.update({f"accum:{n}": tuple(t.shape) for n, t in state.opt_state[1].items()})
    dense = state.opt_state[0] if sparse else state.opt_state
    blocks.update({f"opt:{n}": tuple(t.shape) for n, t in dense["dense"]["nu"].items()})
    gen = torch.Generator().manual_seed(case.get("seed", 0))
    out = []
    for batch in case["batches"]:
        state, metrics = trainer._train_step(state, trainer._put_batch(batch), gen)
        params, opt_state = trainer._full_state(state.params, state.opt_state)
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "params": _np(params),
                    "accums": _np(opt_state[1]) if sparse else None})
    evals = trainer.evaluate(state, iter(case["batches"]))
    return {"steps": out, "blocks": blocks, "eval": evals}


def _checkpoints(case):
    """Two steps unbroken; two steps resumed from a checkpoint at step 1;
    a checkpoint written by one device read into this mesh."""
    root = case["dir"]
    gen = torch.Generator().manual_seed(0)
    trainer = _ranking_trainer(case, checkpoint_dir=f"{root}/mesh")
    state = trainer.init_state(case["params"], generator=gen)
    batches = case["batches"]
    state, _ = trainer._train_step(state, trainer._put_batch(batches[0]), gen)
    trainer._save(state, gen)
    at_save = _np(trainer._full_state(state.params, state.opt_state))
    state, _ = trainer._train_step(state, trainer._put_batch(batches[1]), gen)
    unbroken = _np(trainer._full_state(state.params, state.opt_state))

    gen2 = torch.Generator().manual_seed(123)  # the checkpoint sets its state
    resumed_trainer = _ranking_trainer(case, checkpoint_dir=f"{root}/mesh")
    resumed = resumed_trainer.init_state(generator=gen2)
    step = resumed.step
    resumed, _ = resumed_trainer._train_step(resumed, resumed_trainer._put_batch(batches[1]),
                                            gen2)
    resumed_full = resumed_trainer._full_state(resumed.params, resumed.opt_state)

    one = _ranking_trainer(case, checkpoint_dir=f"{root}/one").init_state()
    one_full = trainer._full_state(one.params, one.opt_state)
    return {"at_save": at_save, "unbroken": unbroken, "resumed": _np(resumed_full),
            "resumed_step": step, "from_one_device": _np(one_full),
            "from_one_device_step": one.step}


def ranking(rank, inputs):
    out = {"steps": {name: _ranking_steps(case) for name, case in inputs["steps"].items()}}
    if "checkpoint" in inputs:
        out["checkpoint"] = _checkpoints(inputs["checkpoint"])
    return out


# ---------------------------------------------------------------------------
# graft_entry_torch.dryrun_multichip on the ranks' own process group
# ---------------------------------------------------------------------------


def graft_dryrun(rank, inputs):
    import graft_entry_torch

    return graft_entry_torch.dryrun_multichip(inputs["n"], device="cpu")
