"""
Constant-hoisting jit.

JAX lowers device arrays captured by closure into the program as *literal
MLIR constants* (verified on jax 0.9: a 16 MB captured array produces a
32 MB module; jax.closure_convert does not help — it only hoists constants
involved in differentiation). Kernel engines here legitimately capture
large tables — the ELL column/value tables (ops/ell.py), Explicit-subspace
state maps — and inlining them makes compilation payloads explode: every
table is copied into the program and through the compiler.

``hjit`` is a drop-in jit replacement for such functions: on first call per
input signature it traces the function to a jaxpr, splits out every
captured array constant, and jits an evaluator that takes those constants
as ordinary runtime arguments.
"""

from functools import wraps

import numpy as np
import jax

try:  # jax.core.eval_jaxpr moved around across jax versions
    from jax.core import eval_jaxpr as _eval_jaxpr
except ImportError:  # pragma: no cover
    from jax._src.core import eval_jaxpr as _eval_jaxpr

# constants at least this large are hoisted to arguments; tiny ones stay
# inline (hoisting them would only lengthen the signature)
HOIST_MIN_BYTES = 1 << 16


def hjit(fn, **jit_kwargs):
    """jit with closure-captured device arrays hoisted to arguments.

    The wrapped callable must be traceable (pure) like any jit target.
    Conversion is cached per (shape, dtype) signature of the positional
    arguments, like jit's own compilation cache. Extra keyword arguments
    (e.g. ``out_shardings``) are forwarded to jax.jit.
    """
    cache = {}

    @wraps(fn)
    def wrapper(*args):
        # the pytree structure is part of the key: two calls with identical
        # leaf signatures but different structures must not share a jaxpr
        key = (jax.tree_util.tree_structure(args), tuple(
            (x.shape, str(x.dtype)) if hasattr(x, 'shape') else x
            for x in jax.tree_util.tree_leaves(args)))
        entry = cache.get(key)
        if entry is None:
            flat_args, in_tree = jax.tree_util.tree_flatten(args)

            def flat_fn(*flat):
                a = jax.tree_util.tree_unflatten(in_tree, flat)
                return fn(*a)

            closed, out_shape = jax.make_jaxpr(
                flat_fn, return_shape=True)(*flat_args)
            out_tree = jax.tree_util.tree_structure(out_shape)

            hoisted_ix, inline_ix = [], []
            for i, c in enumerate(closed.consts):
                size = getattr(c, 'nbytes', 0)
                (hoisted_ix if size >= HOIST_MIN_BYTES
                 else inline_ix).append(i)
            hoisted = [closed.consts[i] for i in hoisted_ix]
            inline = [closed.consts[i] for i in inline_ix]
            n = len(closed.consts)

            def run(h_consts, *flat):
                consts = [None] * n
                for slot, v in zip(hoisted_ix, h_consts):
                    consts[slot] = v
                for slot, v in zip(inline_ix, inline):
                    consts[slot] = v
                out = _eval_jaxpr(closed.jaxpr, consts, *flat)
                return jax.tree_util.tree_unflatten(out_tree, out)

            entry = (jax.jit(run, **jit_kwargs), hoisted, in_tree)
            cache[key] = entry
        jf, hoisted, in_tree = entry
        flat_args = jax.tree_util.tree_leaves(args)
        return jf(hoisted, *flat_args)

    wrapper._hjit_cache = cache  # introspection for tests
    return wrapper
