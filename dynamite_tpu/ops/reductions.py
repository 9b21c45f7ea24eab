"""
Device-side reductions over the Pauli term sweep: matrix infinity norm and
the subspace conservation check.

Both are the matvec engine (ops/apply.py) with the accumulation replaced by
a reduction — exactly how the reference implements them as variants of its
shell kernel: MatNorm_CPU (max over rows of the |coefficient| row sum,
bpetsc_template_2.c:906-981) and CheckConserves (logical AND over columns
that every active mask image lands inside the left subspace,
bpetsc_template_2.c:990-1056). The reference runs them distributed over MPI
ranks; here they run as one fused XLA program: an outer lax.scan over index
chunks (the same fusion-cliff avoidance as the apply engine) with an inner
lax.scan over fixed-size term chunks, reduced with max / logical-and.

Host-side numpy equivalents live in operators.py (`_infinity_norm_host`)
and serve as the small-dimension oracle in tests.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from . import msc as msc_mod
from .index_maps import device_map, parity_j
from .apply import TERM_CHUNK
from ..utils.hoist import hjit

# rows (columns) per outer scan step
RED_CHUNK_BITS = 16


def _term_chunks(msc, int_dtype):
    """Split the mask groups into fixed-size term chunks with a
    last-chunk-of-group flag, so per-group totals can be finalized inside a
    scan (a group's |total| must be taken after summing ALL its terms)."""
    masks, offsets = msc_mod.mask_groups(msc)
    m_l, s_l, cr_l, ci_l, last_l, scale_l = [], [], [], [], [], []
    for g, m in enumerate(masks):
        sl = slice(offsets[g], offsets[g + 1])
        signs = msc['signs'][sl].astype(np.int64)
        coeffs = msc['coeffs'][sl].astype(np.complex128)
        group_scale = float(np.sum(np.abs(coeffs)))
        n = len(signs)
        for start in range(0, n, TERM_CHUNK):
            piece_s = signs[start:start + TERM_CHUNK]
            piece_c = coeffs[start:start + TERM_CHUNK]
            s_pad = np.zeros(TERM_CHUNK, dtype=np.int64)
            c_pad = np.zeros(TERM_CHUNK, dtype=np.complex128)
            s_pad[:len(piece_s)] = piece_s
            c_pad[:len(piece_c)] = piece_c
            m_l.append(int(m))
            s_l.append(s_pad)
            cr_l.append(c_pad.real.copy())
            ci_l.append(c_pad.imag.copy())
            last_l.append(start + TERM_CHUNK >= n)
            scale_l.append(group_scale)
    return (np.asarray(m_l, dtype=int_dtype), np.stack(s_l).astype(int_dtype),
            np.stack(cr_l), np.stack(ci_l),
            np.asarray(last_l), np.asarray(scale_l))


def _base(subspace):
    from .. import subspaces as sp
    return subspace.parent if isinstance(subspace, sp.XParity) else subspace


def build_infinity_norm(msc, left, right, real_dtype, int_dtype):
    """A jitted () -> scalar computing max_row sum_groups |f_m(bra)| over
    rows of the left subspace, counting only columns inside the right
    subspace. ``msc`` must already be reduced (and XParity-rewritten)."""
    msc = msc_mod.combine_terms(msc)
    left_map = device_map(_base(left))
    right_map = device_map(_base(right))
    dim = _base(left).get_dimension()
    chunks = _term_chunks(msc, int_dtype)

    C = min(1 << RED_CHUNK_BITS, dim)
    n_chunks = -(-dim // C)
    padded = n_chunks * C
    needs_pad = padded != dim
    dtype = jnp.dtype(real_dtype)

    if len(chunks[0]) == 0:
        return jax.jit(lambda: jnp.asarray(0.0, dtype))

    def norm_fn():
        masks_d = jnp.asarray(chunks[0])
        signs_d = jnp.asarray(chunks[1])
        cr_d = jnp.asarray(chunks[2], dtype)
        ci_d = jnp.asarray(chunks[3], dtype)
        last_d = jnp.asarray(chunks[4])

        def outer(c, _):
            base_row = (c * C).astype(int_dtype)
            rows = lax.broadcasted_iota(int_dtype, (C,), 0) + base_row
            if needs_pad:
                in_range = rows < dim
                rows = jnp.minimum(rows, dim - 1)
            kets = left_map.i2s(rows)

            def inner(carry, args):
                row_sum, pfr, pfi = carry
                m, signs, cr, ci, is_last = args
                bra = kets ^ m
                w = (1 - 2 * parity_j(bra[:, None] & signs[None, :])
                     ).astype(dtype)
                fr = pfr + jnp.dot(w, cr, precision=lax.Precision.HIGHEST)
                fi = pfi + jnp.dot(w, ci, precision=lax.Precision.HIGHEST)
                _, valid = right_map.s2i(bra)
                add = jnp.sqrt(fr * fr + fi * fi) * valid.astype(dtype)
                row_sum = row_sum + jnp.where(is_last, add, 0)
                keep = jnp.where(is_last, 0, 1).astype(dtype)
                return (row_sum, fr * keep, fi * keep), None

            z = jnp.zeros(C, dtype)
            (row_sum, _, _), _ = lax.scan(
                inner, (z, z, z), (masks_d, signs_d, cr_d, ci_d, last_d))
            if needs_pad:
                row_sum = jnp.where(in_range, row_sum, 0)
            return c + 1, jnp.max(row_sum)

        _, maxes = lax.scan(outer, jnp.asarray(0, int_dtype), None,
                            length=n_chunks)
        return jnp.max(maxes)

    return hjit(norm_fn)


def build_check_conserves(msc, left, right, real_dtype, int_dtype):
    """A jitted () -> bool device check that the operator's image of the
    right subspace lies inside the left subspace: for every column state
    and every mask group with non-cancelling total coefficient, the image
    state must have a valid left index. ``msc`` must already be reduced
    (and XParity-rewritten); exact symbolic cancellations that survive as
    float roundoff are treated as zero relative to each group's coefficient
    scale."""
    msc = msc_mod.combine_terms(msc)
    left_map = device_map(_base(left))
    right_map = device_map(_base(right))
    dim = _base(right).get_dimension()
    chunks = _term_chunks(msc, int_dtype)

    C = min(1 << RED_CHUNK_BITS, dim)
    n_chunks = -(-dim // C)
    padded = n_chunks * C
    needs_pad = padded != dim
    dtype = jnp.dtype(real_dtype)

    if len(chunks[0]) == 0:
        return jax.jit(lambda: jnp.asarray(True))

    # relative-roundoff threshold on the squared magnitude
    tol2 = (1e-12 * chunks[5]) ** 2

    def check_fn():
        masks_d = jnp.asarray(chunks[0])
        signs_d = jnp.asarray(chunks[1])
        cr_d = jnp.asarray(chunks[2], dtype)
        ci_d = jnp.asarray(chunks[3], dtype)
        last_d = jnp.asarray(chunks[4])
        tol2_d = jnp.asarray(tol2, dtype)

        def outer(c, _):
            base_col = (c * C).astype(int_dtype)
            cols = lax.broadcasted_iota(int_dtype, (C,), 0) + base_col
            if needs_pad:
                in_range = cols < dim
                cols = jnp.minimum(cols, dim - 1)
            states = right_map.i2s(cols)

            def inner(carry, args):
                ok, pfr, pfi = carry
                m, signs, cr, ci, is_last, t2 = args
                w = (1 - 2 * parity_j(states[:, None] & signs[None, :])
                     ).astype(dtype)
                fr = pfr + jnp.dot(w, cr, precision=lax.Precision.HIGHEST)
                fi = pfi + jnp.dot(w, ci, precision=lax.Precision.HIGHEST)
                active = (fr * fr + fi * fi) > t2
                _, valid = left_map.s2i(states ^ m)
                ok = ok & jnp.where(is_last, valid | ~active, True)
                keep = jnp.where(is_last, 0, 1).astype(dtype)
                return (ok, fr * keep, fi * keep), None

            z = jnp.zeros(C, dtype)
            (ok, _, _), _ = lax.scan(
                inner, (jnp.ones(C, bool), z, z),
                (masks_d, signs_d, cr_d, ci_d, last_d, tol2_d))
            if needs_pad:
                ok = ok | ~in_range
            return c + 1, jnp.all(ok)

        _, oks = lax.scan(outer, jnp.asarray(0, int_dtype), None,
                          length=n_chunks)
        return jnp.all(oks)

    return hjit(check_fn)
