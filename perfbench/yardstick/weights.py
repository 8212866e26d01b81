"""Initial weights drawn on the device from the run's seed, in a few large
calls: one N(0, 0.02) draw for every table and the [SEP] token, one
truncated-normal draw for every kernel, scaled once per fan-in; float32,
the type the parameters are trained in.

The same seed on the same device gives the same weights, so the reference
draws them again instead of keeping a copy, and ``tables_only`` redraws the
tables alone (they have a generator of their own).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from perfbench.yardstick.model_shapes import param_specs

# flax lecun_normal: truncated at +-2 std, the std corrected for the truncation
_TRUNC_CORRECTION = 0.87962566103423978


def derived_seed(seed: int, purpose: int) -> int:
    """A generator seed for one purpose of a run's ``seed`` (0: tables,
    1: kernels, 2: batches)."""
    return (int(seed) * 8 + purpose) % (2**63)


def _flat(specs, names, device):
    """One flat float32 buffer for ``names`` and a view of it per name."""
    total = sum(math.prod(specs[n].shape) for n in names)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    out, off = {}, 0
    for n in names:
        size = math.prod(specs[n].shape)
        out[n] = buf[off:off + size].view(specs[n].shape)
        off += size
    return buf, out


@torch.no_grad()
def make_weights(cfg: Mapping, seed: int, device, tables_only: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every parameter of
    ``param_specs(cfg)`` (only the ``normal`` ones with ``tables_only``)."""
    specs = param_specs(cfg)
    normal = [n for n, s in specs.items() if s.init == "normal"]
    buf, out = _flat(specs, normal, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, 0))
    buf.normal_(0.0, 0.02, generator=gen)
    if tables_only:
        return out
    # kernels, grouped by fan-in so that each group is one contiguous slice
    lecun = sorted((n for n, s in specs.items() if s.init == "lecun"),
                   key=lambda n: specs[n].fan_in)
    kbuf, kernels = _flat(specs, lecun, device)
    gen.manual_seed(derived_seed(seed, 1))
    torch.nn.init.trunc_normal_(kbuf, 0.0, 1.0, -2.0, 2.0, generator=gen)
    off = 0
    for fan_in in sorted({specs[n].fan_in for n in lecun}):
        size = sum(math.prod(specs[n].shape) for n in lecun if specs[n].fan_in == fan_in)
        kbuf[off:off + size].mul_(math.sqrt(1.0 / fan_in) / _TRUNC_CORRECTION)
        off += size
    out.update(kernels)
    for n, s in specs.items():
        if s.init in ("ones", "zeros", "const"):
            value = {"ones": 1.0, "zeros": 0.0}.get(s.init, s.value)
            out[n] = torch.full(s.shape, value, dtype=torch.float32, device=device)
    return {n: out[n] for n in specs}
