"""A CPU lowering of JAX's bf16 products and sums for tests that run JAX's
mixed-precision step beside the port's.

XLA's CPU backend cannot run a bf16 x bf16 -> f32 ``dot_general``
(``UNIMPLEMENTED ... DotThunk::Execute: BF16 x BF16 = F32``), and it sums a
bf16 ``reduce_sum`` in bf16. ``bf16_as_on_the_card()`` registers, for the
CPU only, rules for ``dot_general_p`` and ``reduce_sum_p`` that upcast bf16
operands to f32, run the op in f32 and convert the result to the op's own
output dtype; every other dtype goes to the rule that was there before.
This stands for the TPU's and the tensor cores' arithmetic: bf16 inputs,
f32 accumulation, the output rounded to the op's dtype.

The previous rules come back on exit, and JAX's caches are cleared on entry
and on exit, so no other test compiles or reuses code under the shim.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
from jax._src.interpreters import mlir
from jax._src.lax import lax

PRIMITIVES = (lax.dot_general_p, lax.reduce_sum_p)


def _previous(prim):
    entry = mlir._platform_specific_lowerings["cpu"].get(prim)
    return entry if entry is not None else mlir._lowerings[prim]


def _upcast_rule(prim, previous):
    def f32_op(*args, **params):
        args = [a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a for a in args]
        if prim is lax.dot_general_p:
            params = dict(params, preferred_element_type=jnp.float32)
        return prim.bind(*args, **params)

    def rule(ctx, *args, **params):
        if not any(a.dtype == jnp.bfloat16 for a in ctx.avals_in):
            return previous.rule(ctx, *args, **params)
        out_dtype = ctx.avals_out[0].dtype

        def fn(*xs):
            return f32_op(*xs, **params).astype(out_dtype)

        return mlir.lower_fun(fn, multiple_results=False)(ctx, *args)

    return rule


@contextlib.contextmanager
def bf16_as_on_the_card():
    """Within the block, JAX's CPU bf16 products and sums accumulate in f32."""
    saved = {p: mlir._platform_specific_lowerings["cpu"].get(p) for p in PRIMITIVES}
    jax.clear_caches()
    try:
        for p in PRIMITIVES:
            mlir.register_lowering(p, _upcast_rule(p, _previous(p)), platform="cpu")
        yield
    finally:
        for p, entry in saved.items():
            if entry is None:
                mlir._platform_specific_lowerings["cpu"].pop(p, None)
            else:
                mlir._platform_specific_lowerings["cpu"][p] = entry
        jax.clear_caches()
