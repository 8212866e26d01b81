"""Build the port's CUDA kernels from the repository's sources at first use.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``build/kernels/`` at the repository
root, and loaded with ``ctypes``. The library's file name carries a hash of
its source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source is rebuilt and a stale library is never loaded. A failed build raises
with the compiler's output. ``build_all`` compiles every source at once, one
``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(stem: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{digest.hexdigest()[:16]}.so"


def build(stem: str) -> Path:
    """Compile ``csrc/<stem>.cu`` unless its current library exists, and
    return the library's path. The ptxas report (registers, shared memory,
    spills) lands beside the library as ``.log``."""
    path = library_path(stem)
    if path.exists():
        return path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    path.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed: {stem}.cu (nvcc exit {proc.returncode}):\n"
            f"{proc.stdout}")
    os.replace(tmp, path)
    return path


def build_all() -> List[Path]:
    """Build every ``csrc/*.cu`` concurrently (one ``nvcc`` per source) and
    return their library paths."""
    stems = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(stems)) as pool:
        return list(pool.map(build, stems))


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build(stem)))
            _loaded[stem] = lib
        return lib
