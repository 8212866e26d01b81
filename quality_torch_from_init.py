#!/usr/bin/env python3
"""``quality_torch.py`` with OneTrans starting from a given initial state
dict instead of ``init_params(cfg, seed=0)``: for example the JAX package's
own draw (``python -m tests.export_jax_onetrans_init build/jax_init_S.pt``),
so that a run of the port on the card and the TPU's run differ in their
arithmetic alone, not in their initial draw.

    python3 quality_torch_from_init.py INIT.pt --track onetrans --models onetrans [flags]

Every other flag is ``quality_torch.py``'s. Only OneTrans takes the file:
a model whose parameter names differ raises.
"""

from __future__ import annotations

import sys

import torch

import quality_torch
from recommend_tpu_torch.training import ranking_trainer


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0].startswith("-"):
        print("usage: python3 quality_torch_from_init.py INIT.pt [quality_torch.py's flags]",
              file=sys.stderr)
        return 2
    given = torch.load(argv[0], weights_only=True)

    def init_params(cfg, seed=0, device=None, model=None):
        names = set(model.state_dict())
        if names != set(given):
            raise KeyError(f"{argv[0]} does not hold this model's parameters: "
                           f"{sorted(names ^ set(given))[:5]}")
        return {k: v.to(device) for k, v in given.items()}

    ranking_trainer.init_params = init_params
    return quality_torch.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
