"""Write the JAX package's initial OneTrans draw for the replica track, as a
state dict of the port (``convert.params_from_flax``), to a ``torch.save``
file: the draw ``examples/quality_parity.py`` trains from on the TPU
(``RankingTrainer.train`` initializes from ``jax.random.key(0)`` whatever
the run's ``--seed``). ``quality_torch_from_init.py`` starts the port from
it on the card, so that the two runs differ in their arithmetic alone.

    python -m tests.export_jax_onetrans_init build/jax_init_S.pt [--geometry S]

flax draws each parameter from its own path in the tree, so the float32
plain-attention config draws what the TPU's bf16 kernel config draws.
"""

import argparse

import jax
import numpy as np
import torch

import quality_torch as q
from recommend_tpu.config import get_config as jget_config
from recommend_tpu.data.pipeline import ranking_batches
from recommend_tpu.training.ranking_trainer import RankingTrainer as JaxTrainer
from recommend_tpu_torch.config import RankingConfig
from recommend_tpu_torch.convert import params_from_flax
from tests.test_torch_quality_onetrans import jax_base


def jax_init(geometry: str = "S") -> dict:
    """The port's state dict of JAX's key(0) draw at the full-scale track."""
    jcfg = jget_config("ranking_base", **jax_base("full", geometry, False))
    tcfg = RankingConfig.from_dict(jcfg.to_dict())
    # a batch of the track's shapes: the small replica under the full config
    tr, _, _, _ = q.make_replica(tcfg, "small", 0, "v2", 0.05, None)
    batch = next(iter(ranking_batches(tr, jcfg, 64, seed=0, num_epochs=1)))
    js = JaxTrainer(jcfg).init_state(jax.random.key(0), batch)
    return params_from_flax(jax.tree_util.tree_map(np.asarray, js.params), tcfg)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("output")
    p.add_argument("--geometry", choices=("S", "L"), default="S")
    args = p.parse_args(argv)
    torch.save(jax_init(args.geometry), args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
