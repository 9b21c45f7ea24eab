"""
Semi-explicit ELL-format apply engine for general subspace pairs.

For a fixed (msc, left, right) triple, the column index of every nonzero is
a *static* function of the row: col = s2i_right(i2s_left(row) ^ mask), and
so is the Walsh coefficient f_m(bra). Computing them on the fly (the XLA
engine's general path) repeats the combinatorial ranking on every apply,
far more work than the gathers themselves. This engine precomputes
both once at kernel-build time, ON DEVICE (one jitted pass reusing the same
traced index maps — no host round-trip), and the hot apply becomes a scan
of pure gather+FMA steps:

    y += (fr[g] + i fi[g]) * x[:, cols[g]]      for each mask group g

This is the analog of the reference's explicit CSR mode (BuildPetsc,
bpetsc_template_2.c:57-205): a materialized matrix in ELL layout (one
permutation-structured column block per Pauli mask group), chosen over CSR
because every row has the same group structure. Memory: one int + one or
two floats per (row, group), bounded by config.ell_budget (the matrix-free
on-the-fly engine remains the fallback above the budget).

Many-group operators (SYK: ~10k masks) batch several groups per scan step
so the scan trip count stays bounded; the per-step gather then moves a
(KB, dim) block.

The tables are device arrays captured by closure in the returned traceable;
every jit entry point in this package hoists such captures to runtime
arguments (utils/hoist.py) — inlining them as MLIR constants would make
compile payloads explode.

The sharded variant stores only the rows each device owns (tables sharded
over the state axis) and all-gathers x over the mesh — the same communication
pattern as the on-the-fly sharded general path (apply.py), with the sweep
replaced by gathers.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

DEFAULT_ELL_BUDGET = 4 << 30  # bytes of device memory for the tables
TERM_CHUNK = 8                # terms per build step (matches apply.py)
MAX_SCAN_STEPS = 128          # target bound on apply scan trip count


def ell_budget():
    from .. import config
    return getattr(config, 'ell_budget', DEFAULT_ELL_BUDGET)


def ell_enabled():
    from .. import config
    return getattr(config, 'use_ell', True)


def chunk_groups(groups):
    """Split mask groups into <=TERM_CHUNK-term build chunks, tracking which
    group each chunk belongs to. Returns (masks, signs, crs, cis, gids, G).
    """
    masks, signs, crs, cis, gids = [], [], [], [], []
    for g, (m, _perm, s, c) in enumerate(groups):
        for start in range(0, len(s), TERM_CHUNK):
            s_pad = np.zeros(TERM_CHUNK, dtype=np.int64)
            c_pad = np.zeros(TERM_CHUNK, dtype=np.complex128)
            piece_s = s[start:start + TERM_CHUNK]
            piece_c = c[start:start + TERM_CHUNK]
            s_pad[:len(piece_s)] = piece_s
            c_pad[:len(piece_c)] = piece_c
            masks.append(int(m))
            signs.append(s_pad)
            crs.append(c_pad.real.copy())
            cis.append(c_pad.imag.copy())
            gids.append(g)
    return (np.asarray(masks, dtype=np.int64), np.stack(signs),
            np.stack(crs), np.stack(cis),
            np.asarray(gids, dtype=np.int32), len(groups))


def _coeff_bytes():
    """Bytes per real coefficient table entry — tables are built in
    config.real_dtype (8 under the default 'double' precision)."""
    from .. import config
    return np.dtype(config.real_dtype).itemsize


def table_bytes(plan, storage_rows=None):
    """Estimated table memory for a plan (mesh-wide; the sharded variant
    splits this across devices)."""
    rows = storage_rows if storage_rows is not None else plan.dim_left
    idx_bytes = 4 if plan.int_dtype == np.int32 else 8
    cb = _coeff_bytes()
    # cols + fr (+ fi when any group has imaginary coefficients)
    return len(plan.groups) * rows * (idx_bytes + cb + cb)


def _batch(G):
    """(n_steps, KB) batching of G groups for the apply scan."""
    kb = -(-G // MAX_SCAN_STEPS)
    return -(-G // kb), kb


def build_tables(plan, n_rows, real_dtype, out_shardings=None,
                 with_conserves=False):
    """One jitted device pass computing the (cols, fr, fi) tables for rows
    [0, n_rows), already reshaped for the batched apply scan:
    cols (S, KB, n_rows) int, fr/fi (S, KB, n_rows) real. Rows >=
    plan.dim_left (uneven-sharding storage pad) get zero coefficients, as
    do group-batch pad slots.

    ``with_conserves`` additionally returns the conservation flag — every
    row's every non-cancelling mask image lands inside the right subspace —
    as a byproduct of the same pass (for Hermitian operators on a square
    pair this equals the reference's column-wise CheckConserves,
    bpetsc_template_2.c:990-1056), saving the separate device reduction.

    Returns (cols, fr, fi_or_None[, conserves_bool]).
    """
    from .index_maps import parity_j

    masks_c, signs_c, cr_c, ci_c, gids, G = chunk_groups(plan.groups)
    C = len(masks_c)
    has_fi = bool(np.any(ci_c != 0))
    idt = plan.int_dtype
    dim_left = plan.dim_left
    S, KB = _batch(G)
    G_pad = S * KB
    # roundoff threshold for "this row's group coefficient cancels" (exact
    # symbolic cancellations survive as float residue, e.g. in folded
    # operators) — relative to each chunk's coefficient scale
    chunk_scale = (np.abs(cr_c) + np.abs(ci_c)).sum(axis=1)
    # row index of the first chunk of each group (its cols row is the
    # group's cols row; duplicates within a group are identical)
    first = np.full(G, -1, dtype=np.int64)
    for c, g in enumerate(gids):
        if first[g] < 0:
            first[g] = c

    def build():
        rows = lax.broadcasted_iota(idt, (n_rows,), 0)
        if n_rows != dim_left:
            valid_row = rows < dim_left
            rows = jnp.minimum(rows, dim_left - 1)
        else:
            valid_row = None
        row_states = plan.row_states(rows)

        masks_d = jnp.asarray(masks_c, idt)
        signs_d = jnp.asarray(signs_c, idt)
        cr_d = jnp.asarray(cr_c, real_dtype)
        ci_d = jnp.asarray(ci_c, real_dtype)

        def step(_, args):
            m, signs, cr, ci = args
            bra = row_states ^ m
            w = (1 - 2 * parity_j(bra[:, None] & signs[None, :])
                 ).astype(real_dtype)
            # HIGHEST: TF32 would round the coefficients to ~1e-3
            fr = jnp.dot(w, cr, precision=lax.Precision.HIGHEST)
            fi = jnp.dot(w, ci, precision=lax.Precision.HIGHEST)
            col, sub_valid = plan.right_map.s2i(bra)
            valid = sub_valid
            if valid_row is not None:
                valid = valid & valid_row
            ok = valid.astype(real_dtype)
            col = jnp.where(valid, col, 0)
            out = [col, fr * ok]
            if has_fi:
                out.append(fi * ok)
            if with_conserves:
                # raw (unmasked, signed) coefficients: the conservation
                # test must see the value a row would have had outside the
                # subspace, summed over the whole group before |.|. Storage
                # pad rows auto-pass (they are not physical rows).
                test_valid = sub_valid
                if valid_row is not None:
                    test_valid = sub_valid | ~valid_row
                out.append(test_valid)
                out.append(fr)
                if has_fi:
                    out.append(fi)
            return None, tuple(out)

        _, outs = lax.scan(step, None, (masks_d, signs_d, cr_d, ci_d))
        outs = list(outs)
        fi_raw_c = outs.pop() if (with_conserves and has_fi) else None
        fr_raw_c = outs.pop() if with_conserves else None
        valid_c = outs.pop() if with_conserves else None
        cols_c = outs[0]
        fr_ck = outs[1]
        fi_ck = outs[2] if has_fi else None

        # consolidate chunks into per-group rows, pad to the batch grid
        def to_groups(v, take_first=False):
            if C != G:
                if take_first:
                    v = v[jnp.asarray(first)]
                else:
                    v = jax.ops.segment_sum(v, jnp.asarray(gids),
                                            num_segments=G)
            return v

        def batch_pad(v):
            if G_pad != G:
                v = jnp.pad(v, ((0, G_pad - G), (0, 0)))
            return v.reshape(S, KB, n_rows)

        cols_g = batch_pad(to_groups(cols_c, take_first=True))
        fr_gt = to_groups(fr_ck)
        fi_gt = to_groups(fi_ck) if has_fi else None

        conserved = None
        if with_conserves:
            # every row of every group must either land inside the right
            # subspace or have a (numerically) cancelling coefficient
            gscale = np.zeros(G)
            np.add.at(gscale, gids, chunk_scale)
            tol = jnp.asarray(1e-12 * gscale, real_dtype)[:, None]
            mag = jnp.abs(to_groups(fr_raw_c))
            if has_fi:
                mag = mag + jnp.abs(to_groups(fi_raw_c))
            gvalid = to_groups(valid_c, take_first=True)
            conserved = jnp.all(gvalid | (mag <= tol))

        fr_g = batch_pad(fr_gt)
        fi_g = batch_pad(fi_gt) if has_fi else None
        out = [cols_g, fr_g]
        if has_fi:
            out.append(fi_g)
        if with_conserves:
            out.append(conserved)
        return tuple(out)

    kwargs = {}
    if out_shardings is not None:
        n_tables = 3 if has_fi else 2
        specs = (out_shardings,) * n_tables
        if with_conserves:
            from jax.sharding import NamedSharding, PartitionSpec
            specs = specs + (NamedSharding(out_shardings.mesh,
                                           PartitionSpec()),)
        kwargs['out_shardings'] = specs
    outs = list(jax.jit(build, **kwargs)())
    conserved = bool(outs.pop()) if with_conserves else None
    cols, fr = outs[0], outs[1]
    fi = outs[2] if has_fi else None
    if with_conserves:
        return cols, fr, fi, conserved
    return cols, fr, fi


def make_apply(out_rows, has_fi, vary_axis=None):
    """The traceable ELL apply (tables passed as arguments so the sharded
    wrapper can shard them): apply(x, cols, fr[, fi]) -> y (2, out_rows).

    A lax.scan over group batches; each step is one (KB, rows) gather +
    contraction. The scan keeps the program size O(1) in the group
    count.
    """
    def apply_fn(x, cols, fr, fi=None):
        dtype = x.dtype
        y0 = jnp.zeros((2, out_rows), dtype)
        if vary_axis is not None:
            # inside shard_map the carry becomes device-varying on the
            # first step; mark the initial zeros to match
            y0 = lax.pcast(y0, (vary_axis,), to='varying')

        # HIGHEST: below it a GPU may take the f32 products in TF32
        # (~1e-3 relative)
        def dot(spec, a, b):
            return jnp.einsum(spec, a, b, precision=lax.Precision.HIGHEST)

        if not has_fi:
            def step(y, args):
                c, f = args                      # (KB, rows)
                xp = x[:, c]                     # (2, KB, rows)
                return y + dot('kr,pkr->pr', f, xp), None
            xs = (cols, fr)
        else:
            def step(y, args):
                c, f_r, f_i = args
                xp = x[:, c]
                sr = dot('kr,kr->r', f_r, xp[0]) - dot('kr,kr->r', f_i, xp[1])
                si = dot('kr,kr->r', f_r, xp[1]) + dot('kr,kr->r', f_i, xp[0])
                return y + jnp.stack([sr, si]), None
            xs = (cols, fr, fi)

        y, _ = lax.scan(step, y0, xs)
        return y

    return apply_fn
