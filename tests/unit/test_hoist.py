"""
The constant-hoisting jit (utils/hoist.py): captured device tables must
become runtime arguments, never inline MLIR constants — inlining them
copies every table into the compiled program.
"""

import numpy as np
import jax
import jax.numpy as jnp

from dynamite_tpu.utils.hoist import hjit


def _make_fn():
    big_i = jnp.arange(1 << 20, dtype=jnp.int32)          # 4 MB int table
    big_f = jnp.ones((1 << 20,), jnp.float32) * 2.0        # 4 MB float
    small = jnp.asarray([1.0, 2.0, 3.0, 4.0], jnp.float32)

    def fn(x):
        idx = jnp.clip(x.astype(jnp.int32), 0, 3)
        return x + big_f[idx] + big_i[idx].astype(jnp.float32) + small[idx]

    return fn


def test_hjit_matches_plain():
    fn = _make_fn()
    x = jnp.asarray([0.0, 1.0, 2.0, 3.0], jnp.float32)
    got = hjit(fn)(x)
    want = fn(x)
    assert np.allclose(np.asarray(got), np.asarray(want))


def test_hjit_hoists_large_consts():
    fn = _make_fn()
    x = jnp.asarray([0.0, 1.0, 2.0, 3.0], jnp.float32)
    wrapped = hjit(fn)
    wrapped(x)

    (jf, hoisted, _tree), = wrapped._hjit_cache.values()
    # both 4 MB tables hoisted; the 16-byte vector stays inline
    assert len(hoisted) == 2
    assert {str(h.dtype) for h in hoisted} == {'int32', 'float32'}

    # the lowered module must NOT contain the tables as literals: with
    # them inlined it would be tens of MB of hex
    mlir = jf.lower(hoisted, x).as_text()
    assert len(mlir) < 200_000, f'module unexpectedly large: {len(mlir)}'


def test_hjit_kernel_tables_are_arguments(monkeypatch):
    """End to end: an ELL-engine kernel's jitted apply must receive its
    tables as arguments (the sector engine is disabled so the kernel
    builds the table-heavy ELL gather path)."""
    from dynamite_tpu import models, config
    from dynamite_tpu.subspaces import SpinConserve

    monkeypatch.setattr(config, 'use_sector', False, raising=False)
    H = models.localized(14)
    sub = SpinConserve(14, 7)
    H.add_subspace(sub)
    kernel = H.get_mat(subspaces=(sub, sub))
    fn = kernel.traceable(sharded=False)

    @hjit
    def apply_once(v):
        return fn(v)

    x = jnp.zeros((2, sub.get_dimension()),
                  jnp.float64).at[0, 0].set(1.0)
    apply_once(x)
    (jf, hoisted, _t), = apply_once._hjit_cache.values()
    assert hoisted, 'kernel tables were not hoisted'
    mlir = jf.lower(hoisted, x).as_text()
    assert len(mlir) < 2_000_000, len(mlir)
