"""MFU of the port's training step under three stated accountings: the
counterpart of ``tools/mfu_accounting.py``.

The OneTrans paper reports 30.8 MFU on 16×H100 for a system whose
sparse-embedding work (table gathers, touched-row updates, their optimizer
state) runs on parameter servers, off the accelerator and outside the MFU
denominator. The port's step carries all of it in-line
(``ops/sparse_embed.py``). From an ``analyze_profile.py --json`` dump this
tool computes, with the analytic training flops
(``evaluation.benchmark.ranking_model_flops`` × batch at ``s_len = 3·seq +
2``) over the card's dense bf16 peak (``peak_flops`` of the dump's device):

  - mfu_inline_pct: flops / (device time · peak), device time the sum of
    the trace's kernel, memcpy and memset durations a step;
  - mfu_parameter_server_view_pct: flops / ((device time − embedding slice)
    · peak), the slice every device event whose innermost
    ``recommend_tpu_torch`` frame (or, for a backward op, its forward op's)
    is in ``ops/sparse_embed.py``: the forward gathers and the touched-row
    updates; the dense optimizer stays in the denominator;
  - mfu_wall_pct, when the dump carries an untraced wall time a step
    (``analyze_profile.py --wall-ms``, from ``profile_bench.py --no-trace``):
    flops / (wall time · peak), the accounting of ``profile_bench.py
    --no-trace`` and of ``chip_smoke.py``'s phase D.

The config is the JAX tool's: ``ranking_base`` at the geometry's widths,
with its own feature widths, where ``profile_bench.py`` sets them to 128;
so its flops read 0.9% below ``profile_bench.py``'s at L (11.595 against
11.695 TFLOP a step at ``--seq 396``), as the two JAX tools' do.

Usage:
    python tools_torch/analyze_profile.py build/prof_L --json build/prof_L.json
    python tools_torch/mfu_accounting.py build/prof_L.json --geometry L --seq 396

It runs wherever it is given ``--device cpu``; without CUDA and without
``--device`` it raises, like every entry point of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recommend_tpu_torch._device import resolve_device
from recommend_tpu_torch.config import get_config
from recommend_tpu_torch.evaluation.benchmark import peak_flops, ranking_model_flops
from tools_torch.profile_bench import GEOMETRY


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("profile_json", help="analyze_profile.py --json output")
    ap.add_argument("--geometry", choices=("S", "L"), default="L")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seq", type=int, default=396,
                    help="per-feature behavior-sequence length (396 ⇒ "
                         "S≈1190, the paper's production stream)")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless given (cpu to run on the CPU)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    resolve_device(args.device, "mfu_accounting")
    cfg = get_config("ranking_base", **GEOMETRY[args.geometry], num_ns_tokens=12,
                     batch_size=args.batch)
    s_len = 3 * args.seq + 2  # three behavior sequences + two [SEP]s

    with open(args.profile_json) as f:
        prof = json.load(f)
    steps = max(prof.get("steps", 1), 1)
    rows = prof["rows"]
    total_us = sum(r.get("total_us") or 0.0 for r in rows)
    embed_us = sum(r.get("total_us") or 0.0 for r in rows
                   if "sparse_embed" in (r.get("source") or ""))
    total_ms = total_us / 1e3 / steps
    embed_ms = embed_us / 1e3 / steps
    peak = peak_flops(prof["device"])

    flops = ranking_model_flops(cfg, s_len, training=True) * args.batch
    mfu_inline = flops / (total_ms / 1e3) / peak
    # guard: frame mis-attribution could put the whole profile in the
    # sparse_embed slice — an empty denominator is a broken profile, not an
    # infinite MFU
    ps_denom_ms = max(total_ms - embed_ms, 1e-6)
    mfu_ps = flops / (ps_denom_ms / 1e3) / peak
    wall_ms = prof.get("wall_ms_per_step")
    out = {
        "geometry": args.geometry,
        "s_tokens": s_len,
        "batch": args.batch,
        "device": prof["device"],
        "peak_flops": peak,
        "device_ms_per_step": total_ms,
        "embedding_slice_ms_per_step": embed_ms,
        "embedding_slice_pct": embed_ms / total_ms * 100,
        "train_flops_per_step": flops,
        "mfu_inline_pct": mfu_inline * 100,
        "mfu_parameter_server_view_pct": mfu_ps * 100,
        **({"ps_view_error": "embedding slice >= total device time — frame "
            "attribution is broken; ps view is meaningless"}
           if embed_ms >= total_ms else {}),
        **({"wall_ms_per_step": wall_ms,
            "mfu_wall_pct": flops / (wall_ms / 1e3) / peak * 100} if wall_ms else {}),
        "note": "inline: device time (kernels + memcpy + memset) a step; ps view "
                "excludes ops/sparse_embed.py device time (forward table gathers + "
                "touched-row updates) from it — the paper's parameter-server "
                "accounting; dense optimizer stays included; wall: the untraced "
                "wall-clock step; each against the card's dense bf16 peak",
    }
    print(json.dumps(out, indent=2))
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
