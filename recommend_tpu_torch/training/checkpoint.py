"""Checkpoint and resume: the port's ``training/checkpoint.CheckpointManager``.

The JAX package's manager sits on orbax; this one writes one ``torch.save``
file per step, ``ckpt_<step>.pt``, holding the step, the parameters, the
optimizer state and (for the port's dropout stream) a generator state. Each
file is written under a temporary name and then renamed with ``os.replace``,
so a reader never sees a torn file. The newest ``max_to_keep`` are kept.
``config.json`` and ``history.json`` are written beside them, as the JAX
manager writes them.

Saves are asynchronous, as orbax's are: ``save`` copies the state off the
device (CUDA tensors into pinned host memory, CPU tensors cloned) and
returns once the copies have landed, so the caller may update its tensors in
place right away; a writer thread then does the ``torch.save``, the rename,
the rotation and the JSON files. ``wait()`` joins the writer and raises
what it raised. A second ``save``, ``restore``, ``steps``,
``latest_step`` and ``close`` wait first; so does any manager of the same
directory in this process, so a reader never misses a pending write, and
the writes into one directory run one after another. The writer is not a
daemon: a process that exits with a save pending finishes it, and one
killed mid-write leaves only the ``.tmp`` file.

Everything saved is plain dicts, tuples, ints and tensors, so ``restore``
loads with ``weights_only=True``.
"""

from __future__ import annotations

import copy
import json
import os
import re
import threading
from typing import Any, Dict, List, NamedTuple, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")
# directory -> the writer threads saving into it, oldest first, over every
# manager of this process: a reader of the directory waits for them all, and
# each writes only after the ones before it
_WRITERS: Dict[str, List[threading.Thread]] = {}
_WRITERS_LOCK = threading.Lock()


class Restored(NamedTuple):
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
    rng_state: Optional[torch.Tensor]


def _snapshot(x, devices: set):
    """A copy of ``x`` that nothing on the device can change: CUDA tensors
    are copied into pinned host memory on their device's current stream
    (``devices`` collects the devices, for the caller to wait on), CPU
    tensors cloned, containers rebuilt, anything else deep-copied."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_cuda:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            with torch.cuda.device(x.device):
                host.copy_(x, non_blocking=True)
            devices.add(x.device)
            return host
        return x.clone()
    if isinstance(x, dict):
        return type(x)((k, _snapshot(v, devices)) for k, v in x.items())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_snapshot(v, devices) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_snapshot(v, devices) for v in x)
    return copy.deepcopy(x)


def wait_for_writes(directory: str) -> None:
    """Wait until no save of this process is writing into ``directory``
    (a reader of its ``config.json`` or checkpoints calls this first)."""
    with _WRITERS_LOCK:
        threads = list(_WRITERS.get(os.path.abspath(directory), ()))
    for thread in threads:
        thread.join()


def writing(directory: str) -> bool:
    """Whether a save of this process is writing into ``directory`` now."""
    with _WRITERS_LOCK:
        return os.path.abspath(directory) in _WRITERS


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._error: Optional[BaseException] = None
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def _steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def steps(self) -> List[int]:
        """The saved steps, oldest first (after any pending save)."""
        self.wait()
        return self._steps()

    def save(
        self,
        step: int,
        params: Dict[str, torch.Tensor],
        opt_state: Any,
        config_dict: Optional[Dict] = None,
        history: Optional[Dict] = None,
        rng_state: Optional[torch.Tensor] = None,
    ) -> None:
        """Start writing step ``step``. Returns once the state is copied off
        the device, so the caller may update its tensors in place next; the
        write goes on in a thread until ``wait()``."""
        self.wait()
        devices: set = set()
        state = _snapshot({"step": int(step), "params": params, "opt_state": opt_state,
                           "rng_state": rng_state}, devices)
        for dev in devices:  # the copies were queued on each current stream
            with torch.cuda.device(dev):
                torch.cuda.current_stream(dev).synchronize()
        files = copy.deepcopy({"config.json": config_dict, "history.json": history})
        with _WRITERS_LOCK:  # registered and started at once: readers join started threads
            writers = _WRITERS.setdefault(self.directory, [])
            thread = threading.Thread(target=self._write, args=(state, files, list(writers)),
                                      name=f"checkpoint-{step}")
            writers.append(thread)
            thread.start()

    def _write(self, state: Dict, files: Dict[str, Any], earlier) -> None:
        try:
            for thread in earlier:  # another manager's pending write here goes first
                thread.join()
            final = self.path(state["step"])
            tmp = final + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, final)
            for old in self._steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
            for name, obj in files.items():
                if obj is not None:
                    tmp = os.path.join(self.directory, name + ".tmp")
                    with open(tmp, "w") as f:
                        json.dump(obj, f, indent=2)
                    os.replace(tmp, os.path.join(self.directory, name))
        except Exception as e:  # raised again by the next wait()
            self._error = e
        finally:
            with _WRITERS_LOCK:
                writers = _WRITERS[self.directory]
                writers.remove(threading.current_thread())
                if not writers:
                    del _WRITERS[self.directory]

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
        """Wait until the pending write into this directory is on disk;
        raise what this manager's writer raised."""
        wait_for_writes(self.directory)
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        """Wait for the pending write; nothing else is held open."""
        self.wait()
