"""Checkpoint and resume: the port's ``training/checkpoint.CheckpointManager``.

The JAX package's manager sits on orbax; this one writes one ``torch.save``
file per step, ``ckpt_<step>.pt``, holding the step, the parameters, the
optimizer state and (for the port's dropout stream) a generator state. Each
file is written under a temporary name and then renamed with ``os.replace``,
so a reader never sees a torn file. The newest ``max_to_keep`` are kept.
``config.json`` and ``history.json`` are written beside them, as the JAX
manager writes them.

Everything saved is plain dicts, tuples, ints and tensors, so ``restore``
loads with ``weights_only=True``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, NamedTuple, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class Restored(NamedTuple):
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
    rng_state: Optional[torch.Tensor]


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def save(
        self,
        step: int,
        params: Dict[str, torch.Tensor],
        opt_state: Any,
        config_dict: Optional[Dict] = None,
        history: Optional[Dict] = None,
        rng_state: Optional[torch.Tensor] = None,
    ) -> None:
        """Write step ``step``. Synchronous: the tensors are serialized
        before this returns, so the caller may update them in place next."""
        state = {"step": int(step), "params": params, "opt_state": opt_state,
                 "rng_state": rng_state}
        final = self.path(step)
        tmp = final + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        for name, obj in (("config.json", config_dict), ("history.json", history)):
            if obj is not None:
                tmp = os.path.join(self.directory, name + ".tmp")
                with open(tmp, "w") as f:
                    json.dump(obj, f, indent=2)
                os.replace(tmp, os.path.join(self.directory, name))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, map_location=None) -> Optional[Restored]:
        """The latest checkpoint with its tensors on ``map_location``, or
        None when the directory holds none."""
        step = self.latest_step()
        if step is None:
            return None
        state = torch.load(self.path(step), map_location=map_location, weights_only=True)
        return Restored(state["step"], state["params"], state["opt_state"],
                        state.get("rng_state"))

    def wait(self) -> None:
        """Saves are synchronous; nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open between calls."""
