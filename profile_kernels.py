#!/usr/bin/env python3
"""Compare this checkout's band-attention kernels with another source tree's
on one card: what nvcc makes of each, and one [BH, L, Dh] forward of each
timed in turns on the same inputs.

    python3 profile_kernels.py OTHER_ROOT [NAME]   # from the repository root; one CUDA card

OTHER_ROOT is another checkout of the repository, e.g. the parent commit
unpacked with ``git archive`` under ``build/``. For each tree, other first,
it compiles each ``recommend_tpu_torch/csrc/*.cu`` alone with the flags of
``ops/_build.py`` and prints the compile time, the number of kernel
instances and the registers and spills ptxas reports for each. Then for NAME
(``band_attn_bh_fwd``, the default, or ``band_attn_blocked_fwd``: the two
forwards with the same C signature) at each shape ``chip_smoke.py`` lists
for it, in bf16 and float32, it checks both trees' outputs against the plain
version and times both with CUDA events in turns (other, this, this, other),
beside ``F.scaled_dot_product_attention``, the plain version and the bound.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke
from recommend_tpu_torch.ops import _build
from recommend_tpu_torch.ops import flash_attention as fa

BUILD = Path(__file__).resolve().parent / "build" / "profile_kernels"


def compile_tree(label: str, csrc: Path) -> Path:
    """Compile each source of ``csrc`` alone; print what ptxas says; return
    the forward library."""
    out_dir = BUILD / label
    out_dir.mkdir(parents=True, exist_ok=True)
    for src in sorted(csrc.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        t = time.perf_counter()
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        seconds = time.perf_counter() - t
        if proc.returncode != 0:
            raise RuntimeError(f"{label} {src.name}: nvcc exit {proc.returncode}\n{proc.stdout}")
        kernel = ""
        for line in proc.stdout.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"(band_attn_\w*?kernel)I(\w*?)EE", line)
                kernel = f"{m.group(1)}<{m.group(2)}>" if m else line.strip()
            elif "registers" in line or re.search(r"[1-9]\d* bytes spill", line):
                print(f"ptxas {label} {src.stem} {kernel}: {line.strip()}")
        print(f"nvcc {label} {src.name}: {seconds:.1f} s, "
              f"{proc.stdout.count('Compiling entry function')} kernel instances "
              f"[{chip_smoke.CARD}]", flush=True)
    return out_dir / "libband_attention.so"


def c_forward(lib, name, t, shape, dtype_code):
    """One call of the [BH, L, Dh] forward ``name`` of ``lib``."""
    fn = getattr(lib, name)
    fn.argtypes = fa._SIGNATURES[name]
    fn.restype = ctypes.c_int
    bh, lq, ls, dh = (shape[k] for k in ("b", "lq", "ls", "dh"))
    out = torch.empty_like(t["q"])
    lse = torch.empty((bh, lq), dtype=torch.float32, device="cuda")
    ptrs = (ctypes.c_void_p(x.data_ptr()) for x in (t["q"], t["k"], t["v"], t["bias"], out, lse))
    rc = fn(*ptrs, bh, lq, ls, dh, ls - lq, int(shape.get("causal", True)),
            ctypes.c_float(1.0 / dh ** 0.5), dtype_code,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
    return out, lse


def main(argv) -> int:
    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 1
    other = Path(argv[0]).resolve()
    name = argv[1] if len(argv) > 1 else "band_attn_bh_fwd"
    if name not in ("band_attn_bh_fwd", "band_attn_blocked_fwd"):
        raise ValueError(f"{name}: not a [BH, L, Dh] forward")
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.CARD = chip_smoke.card_line()
    print(chip_smoke.CARD)
    libs = {label: ctypes.CDLL(str(compile_tree(label, root / "recommend_tpu_torch" / "csrc")))
            for label, root in (("other", other), ("this", _build.CSRC.parents[1]))}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(chip_smoke.SEED)
    for shape in dict((n, s) for n, _, s in chip_smoke.KERNELS)[name]:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            t = chip_smoke.make_inputs(shape, dtype, gen)
            ref, ref_lse = chip_smoke.call(name, t, shape, fa, plain=True)
            live = ref_lse > -1e8
            ms, errs = {"other": [], "this": []}, {}
            for label, lib in libs.items():
                out, lse = c_forward(lib, name, t, shape, fa._DTYPE_CODE[dtype])
                torch.cuda.synchronize()
                errs[label] = (f"{(out.float() - ref.float()).abs().max().item():.3g}",
                               f"{(lse - ref_lse)[live].abs().max().item():.3g}")
            for label in ("other", "this", "this", "other"):
                ms[label].append(chip_smoke.cuda_ms(
                    lambda: c_forward(libs[label], name, t, shape, fa._DTYPE_CODE[dtype]), 20))
            sdpa = chip_smoke.cuda_ms(chip_smoke.library_call(t, shape), 20)
            plain = chip_smoke.cuda_ms(
                lambda: chip_smoke.call(name, t, shape, fa, plain=True), 5)
            b_ms, b_by = chip_smoke.bound(t, ref, ref_lse, shape, dn)
            print(f"{name} {dn} {shape}: other {ms['other'][0]:.4f} / {ms['other'][1]:.4f} ms, "
                  f"this {ms['this'][0]:.4f} / {ms['this'][1]:.4f} ms, sdpa {sdpa:.4f}, "
                  f"plain {plain:.4f}, bound {b_ms:.4f} ({b_by}); max err (out, lse) {errs}, "
                  f"max|ref| {ref.float().abs().max().item():.3g} [{chip_smoke.CARD}]",
                  flush=True)
            del t, ref, ref_lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
