"""ctypes bindings for the native (C++) input pipeline: the port of the JAX
package's ``data/native.py``, over the port's own copy of the source,
``csrc/batcher.cc``.

``load_native()`` builds the library with g++ at first use into
``build/native/`` at the repository root (or a directory the caller names)
and loads it:

- the library's file name carries a hash of the source, the compiler flags
  and the host's CPU (``-march=native`` code is built for the CPU it runs
  on), so an edited source or another host builds anew and a stale library
  is never loaded;
- each build writes a temporary name and ``os.replace``\\s it, so processes
  building at once do not race;
- unlike the JAX package's loader, which returns None and lets the pipeline
  fall back to numpy without a word, a failed build or load raises with the
  compiler's output.

It exposes ``fill_retrieval_batch`` (left-padded history batch assembly,
through ``FlatSequences``) and ``AliasSampler`` (O(1) popularity-weighted
sampling by Walker's alias method, with a distinct-excluding variant); both
take the JAX module's arguments and give its results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "batcher.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}

_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64, _u64 = ctypes.c_int64, ctypes.c_uint64
_SIGNATURES = {
    "fill_retrieval_batch": (
        [_i64p, _i64p, _i64p, _f32p, _i64p, _i64p, _i64p, _i64p, _i64, _i64, _f32p,
         _i64p, _i64p, _i64p, _f32p, _i64p, _u8p, _i64p, _i64p, _i64p, _f32p, _i64p, _f32p]),
    "build_alias_table": [_f64p, _i64, _f64p, _i64p],
    "sample_alias": [_f64p, _i64p, _i64, _i64, _u64, _i64p],
    "sample_alias_distinct_excluding": [_f64p, _i64p, _i64, _i64, _i64p, _i64, _u64, _i64p],
}


def _host_cpu() -> bytes:
    """The host's architecture and CPU feature flags (Linux), the target of
    ``-march=native``."""
    flags = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            flags = next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        pass
    return platform.machine().encode() + flags


def library_path(build_dir: Optional[Path] = None) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(_host_cpu())
    return Path(build_dir or BUILD_DIR) / f"librecbatch-{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """Compile the source into ``path``; raise with the compiler's output
    when it fails."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native batcher build failed: g++ not found ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native batcher build failed: {SOURCE.name} (g++ exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)


def load_native(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded batcher library, built first if its current build is not
    in ``build_dir`` (``build/native/`` by default). Raises RuntimeError
    with g++'s output when the build fails, and OSError when the library
    does not load."""
    path = library_path(build_dir)
    with _lock:
        lib = _loaded.get(path)
        if lib is None:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, None
            _loaded[path] = lib
        return lib


def _ptr(arr: np.ndarray, ctype):
    if not arr.flags.c_contiguous:
        raise ValueError("native buffers must be contiguous")
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class FlatSequences:
    """Per-user sequences flattened to contiguous arrays + offsets."""

    def __init__(self, user_sequences):
        lens = np.array([len(s["video_id"]) for s in user_sequences], dtype=np.int64)
        self.offsets = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=self.offsets[1:])
        total = int(self.offsets[-1])
        self.vids = np.empty(total, dtype=np.int64)
        self.cats = np.empty(total, dtype=np.int64)
        self.tags = np.empty(total, dtype=np.int64)
        self.durs = np.empty(total, dtype=np.float32)
        self.tss = np.empty(total, dtype=np.int64)
        for u, s in enumerate(user_sequences):
            a, b = self.offsets[u], self.offsets[u + 1]
            self.vids[a:b] = s["video_id"]
            self.cats[a:b] = s["category"]
            self.tags[a:b] = s["tag"]
            self.durs[a:b] = s["duration"]
            self.tss[a:b] = s["timestamp"]


def fill_retrieval_batch(
    lib,
    flat: FlatSequences,
    ex_user: np.ndarray,
    ex_split: np.ndarray,
    max_len: int,
    popularity_probs: np.ndarray,
) -> Dict[str, object]:
    """Examples (user ``ex_user[b]``, history ``seq[:ex_split[b]]`` with
    its most recent ``max_len`` items, target ``seq[ex_split[b]]``) -> the
    batch dict of ``retrieval_batches`` without ``history_popularity``."""
    b = len(ex_user)
    ex_user = np.ascontiguousarray(ex_user, np.int64)
    ex_split = np.ascontiguousarray(ex_split, np.int64)
    if len(ex_split) != b:
        raise ValueError(f"{b} users but {len(ex_split)} split points")
    n_users = len(flat.offsets) - 1
    lens = np.diff(flat.offsets)
    if b and (ex_user.min() < 0 or ex_user.max() >= n_users
              or ex_split.min() < 0 or (ex_split >= lens[ex_user]).any()):
        raise ValueError("an example's user or split point is outside its sequences")
    probs = np.ascontiguousarray(popularity_probs, dtype=np.float32)
    if b and flat.vids[flat.offsets[ex_user] + ex_split].max() >= len(probs):
        raise ValueError("a target's video id is outside popularity_probs")
    out = {
        "video_id": np.empty((b, max_len), np.int64),
        "category": np.empty((b, max_len), np.int64),
        "tag": np.empty((b, max_len), np.int64),
        "duration": np.empty((b, max_len), np.float32),
        "timestamp": np.empty((b, max_len), np.int64),
    }
    valid = np.empty((b, max_len), np.uint8)
    tgt = {
        "video_id": np.empty(b, np.int64),
        "category": np.empty(b, np.int64),
        "tag": np.empty(b, np.int64),
        "duration": np.empty(b, np.float32),
        "timestamp": np.empty(b, np.int64),
    }
    pop = np.empty(b, np.float32)
    i64, f32, u8 = ctypes.c_int64, ctypes.c_float, ctypes.c_uint8
    lib.fill_retrieval_batch(
        _ptr(flat.vids, i64), _ptr(flat.cats, i64), _ptr(flat.tags, i64),
        _ptr(flat.durs, f32), _ptr(flat.tss, i64), _ptr(flat.offsets, i64),
        _ptr(ex_user, i64), _ptr(ex_split, i64), b, max_len, _ptr(probs, f32),
        _ptr(out["video_id"], i64), _ptr(out["category"], i64),
        _ptr(out["tag"], i64), _ptr(out["duration"], f32),
        _ptr(out["timestamp"], i64), _ptr(valid, u8),
        _ptr(tgt["video_id"], i64), _ptr(tgt["category"], i64),
        _ptr(tgt["tag"], i64), _ptr(tgt["duration"], f32),
        _ptr(tgt["timestamp"], i64), _ptr(pop, f32),
    )
    return {
        "history": out,
        "history_valid": valid.astype(bool),
        "target": tgt,
        "target_popularity": pop,
    }


class AliasSampler:
    """O(1) popularity-weighted sampler (native alias method). Each call
    draws from the next seed of a 64-bit LCG started at ``seed``, as the
    JAX package's sampler does, so the same seed gives the same draws."""

    def __init__(self, lib, probs: np.ndarray, seed: int = 0):
        self.lib = lib
        self.n = len(probs)
        self.prob = np.empty(self.n, np.float64)
        self.alias = np.empty(self.n, np.int64)
        self._seed = seed
        p = np.ascontiguousarray(probs, dtype=np.float64)
        lib.build_alias_table(_ptr(p, ctypes.c_double), self.n,
                              _ptr(self.prob, ctypes.c_double), _ptr(self.alias, ctypes.c_int64))

    def _next_seed(self) -> int:
        self._seed = (self._seed * 6364136223846793005 + 1442695040888963407) % 2**63
        return self._seed

    def sample(self, num: int) -> np.ndarray:
        out = np.empty(num, np.int64)
        self.lib.sample_alias(_ptr(self.prob, ctypes.c_double), _ptr(self.alias, ctypes.c_int64),
                              self.n, num, self._next_seed(), _ptr(out, ctypes.c_int64))
        return out

    def sample_distinct_excluding(self, num: int, exclude: Sequence[int]) -> np.ndarray:
        """``num`` distinct ids, none in ``exclude`` (rejection sampling,
        then the lowest free ids if the draws run out)."""
        ex = np.ascontiguousarray(np.asarray(exclude, dtype=np.int64))
        free = self.n - len(np.unique(ex[(ex >= 0) & (ex < self.n)]))
        if num > free:
            raise ValueError(f"{num} distinct ids asked for, {free} not excluded")
        out = np.empty(num, np.int64)
        self.lib.sample_alias_distinct_excluding(
            _ptr(self.prob, ctypes.c_double), _ptr(self.alias, ctypes.c_int64),
            self.n, num, _ptr(ex, ctypes.c_int64), len(ex), self._next_seed(),
            _ptr(out, ctypes.c_int64))
        return out
