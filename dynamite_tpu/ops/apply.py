"""
The matrix-free Pauli-string matvec engine.

An operator's MSC terms, grouped by mask, compile at trace time into a fused
sweep: for each unique mask m,

    y[row] += f_m(bra) * x[col(bra)],   bra = i2s_left(row) ^ m
    f_m(bra) = sum_{terms t with mask m} coeff_t * (-1)**parity(bra & sign_t)
    col(bra) = s2i_right(bra)   (contribution dropped where invalid)

This is the row-oriented (gather, no scatter) formulation of the reference's
shell MatMult (bpetsc_template_2.c:371-504), JIT-specialized per
(left, right) subspace pair instead of C-macro-templated per pair
(bpetsc_impl.c:22-163).

Fast path: when both subspaces are Full (or both Parity in the same sector),
col(bra) == row ^ m' for a reduced mask m', a pure XOR permutation — lowered
as two small constant-index takes over a blocked view (see xor_permute), and
in the distributed case as a pairwise lax.ppermute over the mesh axis for
the high (device) bits, the analog of the reference's
rank = high-bits trick (bpetsc_template_2.c:781-783).

Scan path: operators with many mask groups (e.g. SYK) compile to a
lax.scan over (mask, term-chunk) pairs instead of an unrolled loop, keeping
XLA program size bounded.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..utils.bitwise import parity as parity_np
from ..utils.hoist import hjit
from . import msc as msc_mod
from .index_maps import device_map, parity_j, FullMap, ParityMap

# groups with more terms than this get chunked in the scan path
TERM_CHUNK = 8
# operators with more mask groups than this use the scan path
UNROLL_GROUP_LIMIT = 128
# and with more total terms than this
UNROLL_TERM_LIMIT = 512
# states larger than this are processed in chunks of this size (an outer
# lax.scan), which bounds the sweep's temporaries: XLA materializes about
# eleven state-sized buffers for a whole-state sweep (1.5 GB at 2**24
# rows). On an H100 the whole-state sweep at 2**24 rows ran 4.0 ms against
# 5.2 ms chunked at 2**20 (PERF.md), so chunking starts above 2**24
CHUNK_BITS = 24
# gathered-input size above which the sharded general path switches from
# all_gather to the memory-scaling ring exchange (per-device bytes)
RING_GENERAL_BYTES = 1 << 31


def _xor_kernel_wanted(plan, device_bits=0):
    """Whether the hand-written GPU kernel (ops/xor_triton.py) serves
    this plan: f32 XOR pairs on the GPU. It has no CPU form outside the
    Pallas interpreter, which the tests drive directly."""
    from .. import config
    from . import xor_triton
    return (config.precision == 'single' and jax.default_backend() == 'gpu'
            and xor_triton.supported(plan, device_bits))


def _is_xor_pair(left, right):
    """Whether col(bra) reduces to a pure XOR permutation of row indices."""
    from .. import subspaces as sp
    if isinstance(left, sp.XParity):
        left = left.parent
    if isinstance(right, sp.XParity):
        right = right.parent
    if isinstance(left, sp.Full) and isinstance(right, sp.Full):
        return True
    if (isinstance(left, sp.Parity) and isinstance(right, sp.Parity)):
        return True
    return False


class _Plan:
    """Host-side compilation plan for one (msc, left, right) triple."""

    def __init__(self, msc, left, right):
        from .. import subspaces as sp

        msc = msc_mod.combine_terms(msc)
        self.L = left.L
        self.dim_left = left.get_dimension()
        self.dim_right = right.get_dimension()
        self.left_map = device_map(left)
        self.right_map = device_map(right)
        self.int_dtype = np.int32 if self.L <= 31 else np.int64

        self.xor_mode = _is_xor_pair(left, right)

        lbase = left.parent if isinstance(left, sp.XParity) else left
        rbase = right.parent if isinstance(right, sp.XParity) else right

        masks, offsets = msc_mod.mask_groups(msc)
        groups = []
        for g, m in enumerate(masks):
            sl = slice(offsets[g], offsets[g + 1])
            signs = msc['signs'][sl].astype(np.int64)
            coeffs = msc['coeffs'][sl].astype(np.complex128)
            m = int(m)

            if self.xor_mode:
                if isinstance(lbase, sp.Parity):
                    # validity of s2i is uniform over the group:
                    # parity(bra) = left.space ^ parity(m) must equal
                    # right.space
                    if (lbase.space ^ int(parity_np(np.int64(m)))) \
                            != rbase.space:
                        continue  # projected away entirely
                    perm_mask = m >> 1
                else:
                    perm_mask = m
            else:
                perm_mask = None

            groups.append((m, perm_mask, signs, coeffs))

        self.groups = groups
        self.nterms = sum(len(g[2]) for g in groups)
        self.use_scan = (len(groups) > UNROLL_GROUP_LIMIT
                         or self.nterms > UNROLL_TERM_LIMIT)

    # ---- shared pieces ------------------------------------------------------

    def row_states(self, rows):
        return self.left_map.i2s(rows)

    def group_coefficient(self, bra, signs, coeffs, dtype):
        """f_m(bra): sum over the group's terms of coeff * Walsh sign."""
        fr = None
        fi = None
        one = jnp.asarray(1, bra.dtype)
        two = jnp.asarray(2, bra.dtype)
        for s, c in zip(signs, coeffs):
            w = (one - two * parity_j(bra & jnp.asarray(s, bra.dtype))
                 ).astype(dtype)
            cr, ci = float(c.real), float(c.imag)  # weak-typed scalars
            if cr != 0:
                fr = cr * w if fr is None else fr + cr * w
            if ci != 0:
                fi = ci * w if fi is None else fi + ci * w
        return fr, fi


def _accumulate(y, fr, fi, xp):
    """y += (fr + i fi) * xp over the stacked-real layout."""
    yr, yi = y
    xr, xi = xp[0], xp[1]
    if fr is not None:
        yr = yr + fr * xr
        yi = yi + fr * xi
    if fi is not None:
        yr = yr - fi * xi
        yi = yi + fi * xr
    return (yr, yi)


# log2 of the inner block size for the XOR permutation: the state axis is
# viewed as (n_blocks, 2**XOR_BLOCK_BITS) and the permutation becomes two
# small constant-index takes
XOR_BLOCK_BITS = 10


def xor_permute(x, mask, nbits):
    """x[..., k ^ mask]: the pure XOR permutation of the state axis.

    Lowered as (at most) two jnp.take ops with small constant index vectors
    over a rank-3 view — block-level for the mask's high bits, lane-level
    for its low bits. A flip/reverse lowering of the same permutation over
    a rank-L view is far slower to compile, and the reference's
    'iterate_max = 1 << ctz(mask)' contiguity insight
    (bpetsc_template_2.c:610-631) is subsumed: contiguous runs stay
    contiguous inside the blocks. On the GPU, XLA writes a permuted copy of
    x per take; the f32 GPU kernel (ops/xor_triton.py) avoids that.
    """
    if mask == 0:
        return x
    lead = x.shape[:-1]
    dim = 1 << nbits
    block_bits = min(XOR_BLOCK_BITS, nbits)
    B = 1 << block_bits
    n_blocks = dim // B
    m_hi, m_lo = mask >> block_bits, mask & (B - 1)

    v = x.reshape(lead + (n_blocks, B))
    if m_hi:
        idx_hi = jnp.asarray(np.arange(n_blocks, dtype=np.int32) ^ m_hi)
        v = jnp.take(v, idx_hi, axis=-2)
    if m_lo:
        idx_lo = jnp.asarray(np.arange(B, dtype=np.int32) ^ m_lo)
        v = jnp.take(v, idx_lo, axis=-1)
    return v.reshape(lead + (dim,))


class OperatorKernel:
    """A compiled matrix-free matvec y = A @ x for one subspace pair.

    ``apply(x)`` takes the (2, dim_right) stacked-real state and returns the
    (2, dim_left) result. When x is sharded over the mesh state axis and the
    plan supports it, the distributed (ppermute) path is used.
    """

    def __init__(self, msc, left, right, mesh=None):
        self.plan = _Plan(msc, left, right)
        self.left = left
        self.right = right
        self.mesh = mesh
        # names of the engines that serve the local and the sharded apply,
        # set when each is built
        self.engine = None
        self.sharded_engine = None
        self.sector_plan = None  # set when the sector engine is built
        self.xor_dense_info = None  # set when the XOR-dense engine is built
        # conservation flag computed as a byproduct of the ELL table build
        # (None when the engine in use has no cheap byproduct)
        self.conserves_hint = None
        # engines build lazily on first use: the ELL engine materializes
        # device tables at build time, which a purely-sharded usage should
        # never pay at full (unsharded) size
        self._local_callable = None
        self._local_fn = None
        self._sharded_callable = None
        self._sharded_fn = None
        self._padded_local_fn = None
        self._krylov_ops = {}

    # -- public ---------------------------------------------------------------

    def apply(self, x):
        if self._use_sharded(x):
            return self.sharded_fn(x)
        if x.shape[-1] != self.plan.dim_right:
            # padded storage (multi-device mesh) arriving on the local
            # (replicated) path: strip the pad, apply, re-pad the output
            return self.padded_local_fn(x)
        if self._local_fn is None:
            self._local_fn = hjit(self.traceable(sharded=False))
        return self._local_fn(x)

    @property
    def padded_local_fn(self):
        if self._padded_local_fn is None:
            from ..parallel.mesh import storage_dim
            plan = self.plan
            inner = self.traceable(sharded=False)
            sdim_left = storage_dim(plan.dim_left, self.mesh)

            def fn(x):
                y = inner(x[:, :plan.dim_right])
                if sdim_left != plan.dim_left:
                    y = jnp.pad(y, ((0, 0),
                                    (0, sdim_left - plan.dim_left)))
                return y

            self._padded_local_fn = hjit(fn)
        return self._padded_local_fn

    def traceable(self, sharded=False):
        """The unjitted apply callable, for embedding in larger programs
        (Krylov solvers trace it into their fused iteration)."""
        if sharded:
            if self._sharded_callable is None:
                self._sharded_callable = self._build_sharded_callable()
            return self._sharded_callable
        if self._local_callable is None:
            self._local_callable = self._build_local()
        return self._local_callable

    def should_shard(self, x):
        return self._use_sharded(x)

    def sharded_default(self):
        """Whether solvers that create their own work vectors (eigsolve
        generates its start vector internally) should run distributed."""
        if self.mesh is None or self.mesh.devices.size == 1:
            return False
        return self.sharded_supported

    def krylov_ops(self, m, sharded=False):
        """Cached compiled Krylov building blocks for subspace size m."""
        key = (m, sharded)
        if key not in self._krylov_ops:
            from ..solvers.krylov import KrylovOps
            self._krylov_ops[key] = KrylovOps(self.traceable(sharded), m)
        return self._krylov_ops[key]

    def _use_sharded(self, x):
        if self.mesh is None or self.mesh.devices.size == 1:
            return False
        sharding = getattr(x, 'sharding', None)
        if not isinstance(sharding, NamedSharding):
            return False
        if sharding.spec != P(None, self.mesh.axis_names[0]):
            return False
        return self.sharded_supported

    @property
    def sharded_supported(self):
        # the general path handles any (dim, device-count) pair: state
        # storage is padded to a multiple of the device count (the analog
        # of the reference's uneven row partition, PetscSplitOwnership,
        # bpetsc_template_2.c:232-235) and pad rows are masked in-kernel
        return True

    @property
    def _xor_sharded_eligible(self):
        """Whether the pairwise-ppermute fast path applies."""
        p = self.plan
        if not p.xor_mode or p.dim_left != p.dim_right:
            return False
        nd = self.mesh.devices.size if self.mesh is not None else 1
        return (nd & (nd - 1)) == 0 and p.dim_right % nd == 0

    @property
    def sharded_fn(self):
        if self._sharded_fn is None:
            self._sharded_fn = hjit(self.traceable(sharded=True))
        return self._sharded_fn

    # -- local (single device / replicated) path --------------------------------

    def _build_local(self):
        plan = self.plan
        if _xor_kernel_wanted(plan):
            from .xor_triton import build_xor_kernel
            self.engine = 'xor_triton'
            return build_xor_kernel(plan, self.left, self.right)
        for name, build in (('sector', self._try_sector_local),
                            ('xor_dense', self._try_xor_dense_local),
                            ('ell', self._try_ell_local)):
            fn = build()
            if fn is not None:
                self.engine = name
                return fn
        self.engine, fn = self.sweep_callable()
        return fn

    def sweep_callable(self):
        """(name, traceable) of the on-the-fly XLA term sweep: the engine
        of last resort for every pair, and on the GPU the plain reference
        the XOR kernel is compared with."""
        plan = self.plan
        if plan.use_scan:
            return 'sweep_scan', self._build_local_scan()
        if plan.dim_left > (1 << CHUNK_BITS):
            return 'sweep_chunked', self._build_local_chunked()

        def apply_fn(x):
            dtype = x.dtype
            idt = plan.int_dtype
            rows = lax.broadcasted_iota(idt, (plan.dim_left,), 0)
            row_states = plan.row_states(rows)
            y = (jnp.zeros(plan.dim_left, dtype),
                 jnp.zeros(plan.dim_left, dtype))

            nbits = plan.dim_right.bit_length() - 1
            for m, perm_mask, signs, coeffs in plan.groups:
                bra = row_states ^ jnp.asarray(m, idt)
                fr, fi = plan.group_coefficient(bra, signs, coeffs, dtype)

                if plan.xor_mode:
                    xp = xor_permute(x, perm_mask, nbits)
                else:
                    col, valid = plan.right_map.s2i(bra)
                    col = jnp.where(valid, col, 0)
                    xp = x[:, col]
                    ok = valid.astype(dtype)
                    if fr is not None:
                        fr = fr * ok
                    if fi is not None:
                        fi = fi * ok

                y = _accumulate(y, fr, fi, xp)

            return jnp.stack(y)

        return 'sweep', apply_fn

    def _try_sector_local(self):
        """The sector-blocked matmul engine (ops/sector_apply.py) for square
        SpinConserve pairs (plain or XParity-wrapped): the basis ordering
        makes every symmetry sector a contiguous matrix block and the
        matvec a handful of dense matmuls per sector."""
        from .sector_apply import build_sector_apply
        fn, sp = build_sector_apply(self.plan, self.left, self.right)
        if fn is None:
            return None
        # build byproduct: True / False / None (None = possible cross-
        # subgroup cancellation, needs the standalone device check)
        self.conserves_hint = sp.conserved
        self.sector_plan = sp
        return fn

    def _try_xor_dense_local(self):
        """The XOR-blocked dense-matmul engine (ops/xor_dense.py) for
        many-mask XOR-mode operators (SYK): terms merge into per-high-mask
        channel matrices and the apply is a lax.scan of dense matmuls."""
        from .xor_dense import build_xor_dense
        fn, info = build_xor_dense(self.plan, self.left, self.right)
        if fn is None:
            return None
        self.xor_dense_info = info
        return fn

    def _try_ell_local(self):
        """The precomputed-table ELL engine (ops/ell.py) for plans whose
        on-the-fly path would recompute subspace rankings every apply:
        non-XOR pairs the sector engine declines (Explicit/Auto/
        projections/rectangular pairs) and many-mask XOR operators (SYK).
        XOR pairs with few masks keep the cheaper table-free xor_permute
        path."""
        from . import ell
        plan = self.plan
        if not ell.ell_enabled() or not plan.groups:
            return None
        if plan.xor_mode and not plan.use_scan:
            return None
        from .. import config

        if ell.table_bytes(plan) > ell.ell_budget():
            return None
        *tables, conserved = ell.build_tables(plan, plan.dim_left,
                                              config.real_dtype,
                                              with_conserves=True)
        self.conserves_hint = bool(conserved)
        cols, fr = tables[0], tables[1]
        fi = tables[2] if len(tables) > 2 else None
        inner = ell.make_apply(plan.dim_left, fi is not None)
        if fi is None:
            return lambda x: inner(x, cols, fr)
        return lambda x: inner(x, cols, fr, fi)

    def _build_local_chunked(self):
        """Row-chunked sweep: an outer lax.scan over output chunks whose
        body is the full (unrolled) group sweep on one chunk, so the
        sweep's temporaries stay chunk-sized."""
        plan = self.plan
        bits = CHUNK_BITS
        C = 1 << bits
        n_chunks = -(-plan.dim_left // C)
        padded = n_chunks * C
        needs_pad = padded != plan.dim_left

        def apply_fn(x):
            dtype = x.dtype
            idt = plan.int_dtype

            def body(c, _):
                base = (c * C).astype(idt)
                rows = lax.broadcasted_iota(idt, (C,), 0) + base
                if needs_pad:
                    in_range = rows < plan.dim_left
                    rows = jnp.minimum(rows, plan.dim_left - 1)
                row_states = plan.row_states(rows)
                y = (jnp.zeros(C, dtype), jnp.zeros(C, dtype))

                for m, perm_mask, signs, coeffs in plan.groups:
                    bra = row_states ^ jnp.asarray(m, idt)
                    fr, fi = plan.group_coefficient(bra, signs, coeffs,
                                                    dtype)

                    if plan.xor_mode:
                        # source chunk for this output chunk, then the
                        # in-chunk permutation
                        m_chunk = perm_mask >> bits
                        src = lax.dynamic_slice(
                            x, (0, (c ^ m_chunk) * C), (2, C))
                        xp = xor_permute(src, perm_mask & (C - 1), bits)
                    else:
                        col, valid = plan.right_map.s2i(bra)
                        col = jnp.where(valid, col, 0)
                        xp = x[:, col]
                        ok = valid.astype(dtype)
                        if fr is not None:
                            fr = fr * ok
                        if fi is not None:
                            fi = fi * ok

                    if needs_pad:
                        pad_ok = in_range.astype(dtype)
                        if fr is not None:
                            fr = fr * pad_ok
                        if fi is not None:
                            fi = fi * pad_ok

                    y = _accumulate(y, fr, fi, xp)

                return c + 1, jnp.stack(y)

            _, ys = lax.scan(body, jnp.asarray(0, plan.int_dtype), None,
                             length=n_chunks)
            out = jnp.moveaxis(ys, 0, 1).reshape(2, padded)
            if needs_pad:
                out = out[:, :plan.dim_left]
            return out

        return apply_fn

    def _build_local_scan(self):
        plan = self.plan
        masks_c, signs_c, cr_c, ci_c = _chunked_arrays(plan.groups)

        def apply_fn(x):
            dtype = x.dtype
            idt = plan.int_dtype
            rows = lax.broadcasted_iota(idt, (plan.dim_left,), 0)
            row_states = plan.row_states(rows)
            y0 = jnp.zeros((2, plan.dim_left), dtype)

            masks_d = jnp.asarray(masks_c, idt)
            signs_d = jnp.asarray(signs_c, idt)
            cr_d = jnp.asarray(cr_c, dtype)
            ci_d = jnp.asarray(ci_c, dtype)

            def step(y, args):
                m, signs, cr, ci = args
                bra = row_states ^ m
                # (dim, T) Walsh signs, contracted against the chunk coeffs;
                # zero-padded coefficients contribute nothing
                w = (1 - 2 * parity_j(bra[:, None] & signs[None, :])
                     ).astype(dtype)
                fr = jnp.dot(w, cr, precision=lax.Precision.HIGHEST)
                fi = jnp.dot(w, ci, precision=lax.Precision.HIGHEST)

                col, valid = plan.right_map.s2i(bra)
                col = jnp.where(valid, col, 0)
                xp = x[:, col]
                ok = valid.astype(dtype)
                fr = fr * ok
                fi = fi * ok

                yr = y[0] + fr * xp[0] - fi * xp[1]
                yi = y[1] + fr * xp[1] + fi * xp[0]
                return jnp.stack([yr, yi]), None

            y, _ = lax.scan(step, y0, (masks_d, signs_d, cr_d, ci_d))
            return y

        return apply_fn

    # -- distributed (shard_map + ppermute) path ----------------------------------

    def _build_sharded_callable(self):
        if not self._xor_sharded_eligible:
            return self._build_sharded_general()
        plan = self.plan
        mesh = self.mesh
        nd = mesh.devices.size
        if _xor_kernel_wanted(plan, nd.bit_length() - 1):
            from .xor_triton import build_xor_kernel_sharded
            self.sharded_engine = 'xor_triton_ppermute'
            return build_xor_kernel_sharded(plan, self.left, self.right,
                                            mesh)
        self.sharded_engine = 'xor_ppermute'
        local_dim = plan.dim_right // nd
        local_bits = local_dim.bit_length() - 1
        axis = mesh.axis_names[0]

        # group the mask groups by which device-permutation they induce, so
        # each distinct high mask costs exactly one ppermute
        by_hi = {}
        for g in plan.groups:
            m_hi = g[1] >> local_bits
            by_hi.setdefault(m_hi, []).append(g)

        def local_fn(x_local):
            # x_local: (2, local_dim)
            dtype = x_local.dtype
            idt = plan.int_dtype
            me = lax.axis_index(axis).astype(idt)
            j = lax.broadcasted_iota(idt, (local_dim,), 0)
            rows = (me << local_bits) | j
            row_states = plan.row_states(rows)

            y = (jnp.zeros(local_dim, dtype), jnp.zeros(local_dim, dtype))

            for m_hi, groups in sorted(by_hi.items()):
                if m_hi == 0:
                    src = x_local
                else:
                    src = lax.ppermute(
                        x_local, axis,
                        [(i, i ^ m_hi) for i in range(nd)])
                for m, perm_mask, signs, coeffs in groups:
                    m_lo = perm_mask & (local_dim - 1)
                    xp = xor_permute(src, m_lo, local_bits)
                    bra = row_states ^ jnp.asarray(m, idt)
                    fr, fi = plan.group_coefficient(bra, signs, coeffs,
                                                    dtype)
                    y = _accumulate(y, fr, fi, xp)

            return jnp.stack(y)

        return jax.shard_map(local_fn, mesh=mesh,
                             in_specs=P(None, axis), out_specs=P(None, axis))

    def _build_sharded_general(self):
        """Distributed matvec for arbitrary subspace pairs (SpinConserve,
        Explicit, Auto, projections): the sharded input is all-gathered over
        the mesh, then each device sweeps only its owned output rows.

        This is the analog of the reference's multi-GPU path
        (VecScatterCreateToAll + grid-stride row kernel,
        bcuda_template_2.cu:141-273); the XOR fast path above replaces the
        gather with pairwise ppermutes when the subspace structure allows.
        Compute and output bandwidth scale with devices; input memory is
        O(dim_right) per device during the sweep.

        Operates on padded storage (parallel.mesh.storage_dim): rows beyond
        dim_left are masked to zero, and pad columns of the gathered input
        are never indexed (cols come from s2i, always < dim_right).
        """
        from ..parallel.mesh import storage_dim
        plan = self.plan
        mesh = self.mesh
        nd = mesh.devices.size
        axis = mesh.axis_names[0]
        sdim_left = storage_dim(plan.dim_left, mesh)
        local_left = sdim_left // nd
        has_pad = local_left * nd != plan.dim_left

        fn = self._try_sector_sharded(sdim_left)
        if fn is not None:
            return fn

        from . import ell
        if (ell.ell_enabled() and plan.groups
                and ell.table_bytes(plan, sdim_left) <= ell.ell_budget()):
            self.sharded_engine = 'ell_all_gather'
            return self._build_sharded_ell(sdim_left, local_left)

        if plan.use_scan:
            chunked = _chunked_arrays(plan.groups)
            if self._ring_general_wanted():
                self.sharded_engine = 'sweep_ring'
                return self._build_sharded_ring_general(
                    sdim_left, local_left, chunked)
        else:
            chunked = None
        self.sharded_engine = 'sweep_all_gather'

        def local_fn(x_local):
            dtype = x_local.dtype
            idt = plan.int_dtype
            me = lax.axis_index(axis).astype(idt)
            rows = (lax.broadcasted_iota(idt, (local_left,), 0)
                    + me * jnp.asarray(local_left, idt))
            if has_pad:
                valid_row = (rows < plan.dim_left).astype(dtype)
                rows = jnp.minimum(rows, plan.dim_left - 1)
            row_states = plan.row_states(rows)
            x = lax.all_gather(x_local, axis, axis=1, tiled=True)

            if chunked is not None:
                masks_c, signs_c, cr_c, ci_c = chunked
                masks_d = jnp.asarray(masks_c, idt)
                signs_d = jnp.asarray(signs_c, idt)
                cr_d = jnp.asarray(cr_c, dtype)
                ci_d = jnp.asarray(ci_c, dtype)
                y0 = jnp.zeros((2, local_left), dtype)
                # the scan carry becomes device-varying on the first step
                # (rows depend on axis_index); mark the initial zeros to
                # match
                y0 = lax.pcast(y0, (axis,), to='varying')

                def step(y, args):
                    m, signs, cr, ci = args
                    bra = row_states ^ m
                    w = (1 - 2 * parity_j(bra[:, None] & signs[None, :])
                         ).astype(dtype)
                    fr = jnp.dot(w, cr, precision=lax.Precision.HIGHEST)
                    fi = jnp.dot(w, ci, precision=lax.Precision.HIGHEST)
                    col, valid = plan.right_map.s2i(bra)
                    col = jnp.where(valid, col, 0)
                    xp = x[:, col]
                    ok = valid.astype(dtype)
                    fr = fr * ok
                    fi = fi * ok
                    yr = y[0] + fr * xp[0] - fi * xp[1]
                    yi = y[1] + fr * xp[1] + fi * xp[0]
                    return jnp.stack([yr, yi]), None

                y, _ = lax.scan(step, y0, (masks_d, signs_d, cr_d, ci_d))
                if has_pad:
                    y = y * valid_row[None, :]
                return y

            y = (jnp.zeros(local_left, dtype), jnp.zeros(local_left, dtype))
            for m, _perm, signs, coeffs in plan.groups:
                bra = row_states ^ jnp.asarray(m, idt)
                fr, fi = plan.group_coefficient(bra, signs, coeffs, dtype)
                col, valid = plan.right_map.s2i(bra)
                col = jnp.where(valid, col, 0)
                xp = x[:, col]
                ok = valid.astype(dtype)
                if fr is not None:
                    fr = fr * ok
                if fi is not None:
                    fi = fi * ok
                y = _accumulate(y, fr, fi, xp)
            out = jnp.stack(y)
            if has_pad:
                out = out * valid_row[None, :]
            return out

        return jax.shard_map(local_fn, mesh=mesh,
                             in_specs=P(None, axis), out_specs=P(None, axis))

    def _ring_general_wanted(self):
        """Whether the scan-path general matvec should ring-exchange the
        input instead of all-gathering it: forced by
        ``config.sharded_ring_general``, else automatic once a gathered
        input would exceed RING_GENERAL_BYTES per device."""
        from .. import config
        forced = getattr(config, 'sharded_ring_general', None)
        if forced is not None:
            return bool(forced)
        from ..parallel.mesh import storage_dim
        cb = np.dtype(config.real_dtype).itemsize
        sdim_right = storage_dim(self.plan.dim_right, self.mesh)
        return 2 * sdim_right * cb > RING_GENERAL_BYTES

    def _build_sharded_ring_general(self, sdim_left, local_left, chunked):
        """Memory-scaling general matvec for arbitrary subspace pairs: the
        sharded input circulates around the mesh ring and each device
        accumulates the contributions whose source column falls inside the
        passing block, so per-device resident memory is O(dim/n_devices +
        one block) instead of the all-gather's O(dim). The group sweep
        reruns once per ring step (n_devices x the arithmetic of the
        all-gather path) — the same streaming-vs-memory trade the
        reference's multi-rank CPU protocol makes
        (bpetsc_template_2.c:413-504), without its MPI_Allreduce(BAND)
        termination rounds."""
        from ..parallel.mesh import storage_dim
        plan = self.plan
        mesh = self.mesh
        nd = mesh.devices.size
        axis = mesh.axis_names[0]
        sdim_right = storage_dim(plan.dim_right, mesh)
        local_right = sdim_right // nd
        has_pad = local_left * nd != plan.dim_left
        masks_c, signs_c, cr_c, ci_c = chunked
        perm = [(i, (i + 1) % nd) for i in range(nd)]

        def local_fn(x_local):
            dtype = x_local.dtype
            idt = plan.int_dtype
            me = lax.axis_index(axis).astype(idt)
            rows = (lax.broadcasted_iota(idt, (local_left,), 0)
                    + me * jnp.asarray(local_left, idt))
            if has_pad:
                valid_row = (rows < plan.dim_left).astype(dtype)
                rows = jnp.minimum(rows, plan.dim_left - 1)
            row_states = plan.row_states(rows)

            masks_d = jnp.asarray(masks_c, idt)
            signs_d = jnp.asarray(signs_c, idt)
            cr_d = jnp.asarray(cr_c, dtype)
            ci_d = jnp.asarray(ci_c, dtype)
            y0 = jnp.zeros((2, local_left), dtype)
            y0 = lax.pcast(y0, (axis,), to='varying')

            def ring_step(r, carry):
                block, y = carry
                base = (((me - r.astype(idt)) % jnp.asarray(nd, idt))
                        * jnp.asarray(local_right, idt))

                def step(y, args):
                    m, signs, cr, ci = args
                    bra = row_states ^ m
                    w = (1 - 2 * parity_j(bra[:, None] & signs[None, :])
                         ).astype(dtype)
                    fr = jnp.dot(w, cr, precision=lax.Precision.HIGHEST)
                    fi = jnp.dot(w, ci, precision=lax.Precision.HIGHEST)
                    col, valid = plan.right_map.s2i(bra)
                    in_blk = valid & (col >= base) \
                        & (col < base + local_right)
                    cl = jnp.clip(col - base, 0, local_right - 1)
                    xp = block[:, cl]
                    ok = in_blk.astype(dtype)
                    fr = fr * ok
                    fi = fi * ok
                    yr = y[0] + fr * xp[0] - fi * xp[1]
                    yi = y[1] + fr * xp[1] + fi * xp[0]
                    return jnp.stack([yr, yi]), None

                y, _ = lax.scan(step, y, (masks_d, signs_d, cr_d, ci_d))
                block = lax.ppermute(block, axis, perm)
                return block, y

            _blk, y = lax.fori_loop(0, nd, ring_step, (x_local, y0))
            if has_pad:
                y = y * valid_row[None, :]
            return y

        return jax.shard_map(local_fn, mesh=mesh,
                             in_specs=P(None, axis),
                             out_specs=P(None, axis))

    def _try_sector_sharded(self, sdim_left):
        """The sector engine on the mesh.

        Default: the explicit shard_map ring program (ops/sector_shard.py)
        whose per-device peak memory is O(dim/n_devices + one exchange
        window) — the memory-scaling distributed SpinConserve path that
        beats both the reference's multi-GPU allgather
        (bcuda_template_2.cu:164-171) and its streaming CPU protocol
        (bpetsc_template_2.c:413-504).

        ``config.sector_shard_ring = False`` falls back to the GSPMD-
        partitioned global program (correct, but the partitioner
        materializes ~4.4x one full input in per-device temps)."""
        from .. import config
        if getattr(config, 'sector_shard_ring', True):
            from .sector_shard import build_sector_sharded
            fn, sp = build_sector_sharded(self.plan, self.left, self.right,
                                          self.mesh)
            if fn is not None:
                self.conserves_hint = sp.conserved
                self.sector_plan = sp
                self.sharded_engine = 'sector_ring'
                return fn
            return None

        from .sector_apply import build_sector_apply
        plan = self.plan
        fn, sp = build_sector_apply(plan, self.left, self.right)
        if fn is None:
            return None
        self.conserves_hint = sp.conserved
        self.sector_plan = sp
        self.sharded_engine = 'sector_gspmd'
        mesh = self.mesh
        axis = mesh.axis_names[0]
        spec = NamedSharding(mesh, P(None, axis))

        def wrapped(x):
            y = fn(x[:, :plan.dim_right])
            if sdim_left != plan.dim_left:
                y = jnp.pad(y, ((0, 0), (0, sdim_left - plan.dim_left)))
            return jax.lax.with_sharding_constraint(y, spec)

        return wrapped

    def _build_sharded_ell(self, sdim_left, local_left):
        """Distributed ELL apply: tables sharded over the owned output rows,
        input all-gathered over the mesh (see ops/ell.py)."""
        from . import ell
        from .. import config
        mesh = self.mesh
        axis = mesh.axis_names[0]

        spec = NamedSharding(mesh, P(None, None, axis))
        cols, fr, fi = ell.build_tables(self.plan, sdim_left,
                                        config.real_dtype,
                                        out_shardings=spec)
        inner = ell.make_apply(local_left, fi is not None, vary_axis=axis)

        if fi is None:
            def local_fn(x_local, cols_l, fr_l):
                x = lax.all_gather(x_local, axis, axis=1, tiled=True)
                return inner(x, cols_l, fr_l)
            n_tables = 2
        else:
            def local_fn(x_local, cols_l, fr_l, fi_l):
                x = lax.all_gather(x_local, axis, axis=1, tiled=True)
                return inner(x, cols_l, fr_l, fi_l)
            n_tables = 3

        mapped = jax.shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(None, axis),) + (P(None, None, axis),) * n_tables,
            out_specs=P(None, axis))

        if fi is None:
            return lambda x: mapped(x, cols, fr)
        return lambda x: mapped(x, cols, fr, fi)


def _chunked_arrays(groups, chunk=TERM_CHUNK):
    """Split mask groups into fixed-size term chunks, zero-padding the
    coefficients (a zero coefficient contributes nothing, so no mask array
    is needed)."""
    masks, signs, crs, cis = [], [], [], []
    for m, _perm, s, c in groups:
        for start in range(0, len(s), chunk):
            sl = slice(start, start + chunk)
            s_pad = np.zeros(chunk, dtype=np.int64)
            c_pad = np.zeros(chunk, dtype=np.complex128)
            piece_s = s[sl]
            piece_c = c[sl]
            s_pad[:len(piece_s)] = piece_s
            c_pad[:len(piece_c)] = piece_c
            masks.append(m)
            signs.append(s_pad)
            crs.append(c_pad.real.copy())
            cis.append(c_pad.imag.copy())
    return (np.asarray(masks, dtype=np.int64), np.stack(signs),
            np.stack(crs), np.stack(cis))
