"""Published peaks of the cards the benchmark runs on, by the name that
``torch.cuda.get_device_name()`` gives (NVIDIA H100 SXM datasheet, dense
rates without sparsity, at the full 700 W limit)."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "hbm_bytes": 3.35e12},
}


def peak(device_name: str, what: str) -> float:
    """One peak of the card named ``device_name``; a card not in the table
    raises, so no share is computed against a guess."""
    if device_name not in PEAKS:
        raise KeyError(f"no peaks for {device_name!r}; known: {sorted(PEAKS)}")
    return PEAKS[device_name][what]


def least_seconds(device_name: str, flops: float, nbytes: float) -> float:
    """The least time the card needs for ``flops`` and ``nbytes``."""
    return max(flops / peak(device_name, "bf16_flops"), nbytes / peak(device_name, "hbm_bytes"))
