"""
Sector-blocked matmul apply engine for SpinConserve pairs.

In the sector-major basis (ops/sectors.py) every symmetry sector of the
SpinConserve subspace is a contiguous (nb x na) matrix block — rows indexed
by the rank of the high-rest bits, columns by the rank of the low half —
and a Pauli-string matvec decomposes into dense matrix products:

* every mask confined to the low half contributes to ONE merged (na x na)
  column matrix A per sector:            Y_s += X_s @ A_s^T
* every mask confined to the high bits contributes to merged (nb x nb')
  row matrices N per (input, output) sector pair:   Y_so += N @ X_si
* masks spanning the boundary become a contiguous-row gather composed with
  a column matrix:                Y_so += W ⊙ (X_si[bidx] @ M^T)
* the identity mask becomes a precomputed diagonal field (the analog of
  the reference's PrecomputeDiagonal, bpetsc_template_1.c:169-202):
  Y += D ⊙ X.

Walsh sign factors (-1)^{bra & s} split multiplicatively over the three bit
regions, so they fold into the matrices; the (rare) masks whose sign bits
cross the boundary get per-row scale vectors (subgrouped by the high part
of the sign mask).

This replaces both the ranked-gather ELL path and the roll-schedule shift
engine of earlier revisions for SpinConserve: instead of O(#classes) masked
full-length sweeps (or ranked gathers), the hot loop is a handful of
matmuls per sector plus one diagonal stream — the reference's
one-kernel-family bar (bpetsc_impl.c:22-163) met with dense matrix
products.

Matrices are deduplicated by content across sectors (the low matrices
depend only on the sector's low-half weight, so 24 sectors share ~13
distinct A matrices), built host-side in numpy (they are small — a few MB
for chain models), and hoisted to runtime arguments by utils/hoist.hjit.

Supports plain SpinConserve pairs and XParity-wrapped ones (the reduced
MSC's masks never touch the top spin, so only the t=0 sectors — exactly
the XParity representatives — participate).
"""

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..utils.bitwise import popcount, parity
from . import sectors as sec_mod

# operators with more mask groups than this (e.g. SYK: thousands of
# non-conserving masks) take the scan/ELL engines instead. Long-range
# two-body models stay under this for any L <= 63 (O(L^2/2) mask groups:
# XX and YY share a group), and channel merging keeps the channel count
# O(sectors + distinct crossing masks), so the limit only exists to stop
# pathological operators from minutes-long host builds
SECTOR_GROUP_LIMIT = 2048
_TOL = 1e-12


def _resolve(subspace):
    """The underlying SpinConserve, or None; second value: XParity flag."""
    from .. import subspaces as sp
    if isinstance(subspace, sp.XParity):
        parent = subspace.parent
        if isinstance(parent, sp.SpinConserve):
            return parent, True
        return None, False
    if isinstance(subspace, sp.SpinConserve):
        return subspace, False
    return None, False


def sector_supported(plan, left, right):
    """Whether the sector engine applies to this (msc, left, right)."""
    lbase, lx = _resolve(left)
    rbase, rx = _resolve(right)
    if lbase is None or rbase is None:
        return False
    if lx != rx:
        return False
    if (lbase.L, lbase.k) != (rbase.L, rbase.k):
        return False
    if plan.dim_left != plan.dim_right:
        return False
    if not plan.groups or len(plan.groups) > SECTOR_GROUP_LIMIT:
        return False
    return True


def _split_mask(m, L, La, Lr):
    mt = (m >> (L - 1)) & 1
    mr = (m >> La) & ((1 << Lr) - 1)
    ma = m & ((1 << La) - 1)
    return mt, mr, ma


def table_bytes_estimate(plan, left, right):
    """Pre-build upper bound on device table memory (for the budget gate
    and Operator.estimate_memory)."""
    from .. import config
    lbase, lx = _resolve(left)
    lay = sec_mod.layout(lbase.L, lbase.k)
    secs = [s for s in range(lay.n_sectors) if not (lx and lay.t[s])]
    cb = np.dtype(config.real_dtype).itemsize
    na = lay.na[secs]
    nb = lay.nb[secs]
    # cross-matrix families: masks that TOUCH BOTH halves (high-only
    # masks become row matrices, low-only ones merge into the shared
    # column matrices), one family per distinct high-rest part
    cross_mrs = set()
    diag_imag = False
    for m, _pm, _signs, coeffs in plan.groups:
        mt, mr, ma = _split_mask(int(m), lbase.L, lay.La, lay.Lr)
        if ma and (mr or mt):
            cross_mrs.add(mr)
        if m == 0 and np.any(np.abs(np.imag(coeffs)) > 0):
            diag_imag = True
    # matrices are deduplicated by content across sectors: low matrices
    # and cross matrices depend only on the low-half weight(s), so count
    # unique na values, not per-sector copies; high (row) matrices are
    # genuinely per sector pair (internal + two boundary families)
    una = np.unique(na)
    low = int(np.sum(una ** 2))
    high = 3 * int(np.sum(nb ** 2))
    cross = 2 * len(cross_mrs) * int(np.sum(una ** 2))
    diag = (2 if diag_imag else 1) * plan.dim_left
    return cb * (low + high + cross + diag)


class SectorPlan:
    """Host-side decomposition of an apply plan into sector channels."""

    def __init__(self, plan, left, right, real_dtype):
        lbase, self.xparity = _resolve(left)
        L, k = lbase.L, lbase.k
        lay = sec_mod.layout(L, k)
        self.lay = lay
        self.dim = plan.dim_left
        self.real_dtype = real_dtype

        La, Lr = lay.La, lay.Lr
        nck = sec_mod.nchoosek_table(L, k)

        # participating sectors (XParity: only t=0 representatives — the
        # reduced MSC's masks have the top bit clear, subspaces.reduce_msc)
        self.secs = [s for s in range(lay.n_sectors)
                     if not (self.xparity and lay.t[s])]
        self.sec_index = {s: i for i, s in enumerate(self.secs)}
        assert lay.off[self.secs[0]] == 0
        assert (lay.off[self.secs[-1]]
                + lay.nb[self.secs[-1]] * lay.na[self.secs[-1]]) == self.dim

        # cached half-state enumerations and ranks
        hr_lists = {}   # kr -> sorted Lr-bit states
        sa_lists = {}   # ka -> sorted La-bit states

        def hr_of(kr):
            if kr not in hr_lists:
                hr_lists[kr] = sec_mod.states_of_popcount(Lr, kr)
            return hr_lists[kr]

        def sa_of(ka):
            if ka not in sa_lists:
                sa_lists[ka] = sec_mod.states_of_popcount(La, ka)
            return sa_lists[ka]

        def rank_r(x):
            return sec_mod.rank_bits(x, Lr, nck, k)

        def rank_a(x):
            return sec_mod.rank_bits(x, La, nck, k)

        # channel accumulators
        colmm = {}     # (si, so, mr, mt, s_r) -> M_cplx
        rowmm = {}     # (si, so, s_a) -> N_cplx
        diag_terms = []
        conserved = True  # exact build byproduct (reference CheckConserves)

        for m, _perm, signs, coeffs in plan.groups:
            m = int(m)
            scale = float(np.sum(np.abs(coeffs)))
            tol = _TOL * max(scale, 1e-300)
            if m == 0:
                diag_terms.extend(
                    (complex(c), int(s)) for s, c in zip(signs, coeffs))
                continue
            mt, mr, ma = _split_mask(m, L, La, Lr)
            if self.xparity:
                assert mt == 0  # guaranteed by XParity.reduce_msc
            s_tops = (np.asarray(signs, dtype=np.int64) >> (L - 1)) & 1
            s_rs = (np.asarray(signs, dtype=np.int64) >> La) \
                & ((1 << Lr) - 1)
            s_as = np.asarray(signs, dtype=np.int64) & ((1 << La) - 1)

            for so in self.secs:
                t_o, kr_o, ka_o = lay.t[so], lay.kr[so], lay.ka[so]
                t_b = t_o ^ mt
                sa_o = sa_of(ka_o)
                sa_b = sa_o ^ ma
                pcb = popcount(sa_b)
                hr_o = hr_of(kr_o)
                hr_b = hr_o ^ mr
                kr_b = popcount(hr_b) if mr else np.full(len(hr_o), kr_o)

                if ma:
                    # column-matrix channels: one per realizable input
                    # sector; terms subgrouped by the row part of the sign
                    # (within a subgroup the row factor is shared, so the
                    # alpha action is a single matrix)
                    ra_b = rank_a(np.where(pcb <= k, sa_b, 0))
                    subs = []  # (s_r, fa) per subgroup, beta-independent
                    for s_r in np.unique(s_rs):
                        tsel = s_rs == s_r
                        w_top = 1 - 2.0 * ((t_b * s_tops[tsel]) & 1)
                        wa = 1 - 2.0 * parity(
                            sa_b[:, None] & s_as[None, tsel])
                        subs.append((int(s_r), wa @ (coeffs[tsel] * w_top)))
                    for kr_i in np.unique(kr_b):
                        ka_i = k - t_b - kr_i
                        slot = t_b * (Lr + 1) + kr_i
                        si = int(lay.sec_tk[slot]) \
                            if 0 <= ka_i <= La else -1
                        live = si >= 0 and si in self.sec_index
                        csel = (pcb == ka_i) if live \
                            else np.zeros(len(sa_b), bool)
                        # transitions leaving the subspace are dropped;
                        # the operator conserves the sector only if their
                        # total weight (summed over sign subgroups, which
                        # can cancel) vanishes — reconstructed exactly as
                        # a sum of outer products on the dropped entries
                        if conserved and any(
                                np.any(np.abs(fa[~csel]) > tol)
                                for _sr, fa in subs):
                            brow = np.nonzero(kr_b == kr_i)[0]
                            F = np.zeros((len(brow), int((~csel).sum())),
                                         dtype=np.complex128)
                            for s_r, fa in subs:
                                wr = 1 - 2.0 * parity(hr_b[brow] & s_r)
                                F += np.outer(wr, fa[~csel])
                            if np.any(np.abs(F) > tol):
                                conserved = False
                        if not live or not np.any(csel):
                            continue
                        rows = np.nonzero(csel)[0]
                        for s_r, fa in subs:
                            if not np.any(np.abs(fa[rows]) > 0):
                                continue
                            key = (si, so, mr, mt, s_r)
                            M = colmm.get(key)
                            if M is None:
                                M = np.zeros((lay.na[so], lay.na[si]),
                                             dtype=np.complex128)
                                colmm[key] = M
                            np.add.at(M, (rows, ra_b[rows]), fa[rows])
                else:
                    # row-matrix channels (mask confined to the high bits):
                    # alpha is untouched, so the live channel needs
                    # ka_i == ka_o; terms subgrouped by the low sign part
                    subs = []  # (s_a, fb) per subgroup, alpha-independent
                    for s_a in np.unique(s_as):
                        tsel = s_as == s_a
                        w_top = 1 - 2.0 * ((t_b * s_tops[tsel]) & 1)
                        wr = 1 - 2.0 * parity(
                            hr_b[:, None] & s_rs[None, tsel])
                        subs.append((int(s_a), wr @ (coeffs[tsel] * w_top)))
                    rb_b = rank_r(np.where(kr_b <= k, hr_b, 0))
                    for kr_i in np.unique(kr_b):
                        ka_i = k - t_b - kr_i
                        slot = t_b * (Lr + 1) + kr_i
                        si = int(lay.sec_tk[slot]) \
                            if 0 <= ka_i <= La else -1
                        live = (si >= 0 and si in self.sec_index
                                and ka_i == ka_o)
                        rsel = kr_b == kr_i
                        if not live:
                            brow = np.nonzero(rsel)[0]
                            if conserved and any(
                                    np.any(np.abs(fb[brow]) > tol)
                                    for _sa, fb in subs):
                                F = np.zeros((len(brow), len(sa_o)),
                                             dtype=np.complex128)
                                for s_a, fb in subs:
                                    wa = 1 - 2.0 * parity(sa_o & s_a)
                                    F += np.outer(fb[brow], wa)
                                if np.any(np.abs(F) > tol):
                                    conserved = False
                            continue
                        rows = np.nonzero(rsel)[0]
                        for s_a, fb in subs:
                            if not np.any(np.abs(fb[rows]) > 0):
                                continue
                            key = (si, so, s_a)
                            N = rowmm.get(key)
                            if N is None:
                                N = np.zeros((lay.nb[so], lay.nb[si]),
                                             dtype=np.complex128)
                                rowmm[key] = N
                            np.add.at(N, (rows, rb_b[rows]), fb[rows])

        self.conserved = conserved

        # ---- finalize channels ------------------------------------------
        # column channels need the row gather index and a row scale (the
        # validity mask times the rest-part Walsh sign). Subgroups whose
        # row scales agree up to a global sign merge into one channel with
        # the sign folded into the matrix — e.g. the XX and YY parts of a
        # boundary hop, whose sign bits sit inside the mask and are
        # therefore constant on each channel.
        pre = {}
        pre_order = []
        for (si, so, mr, mt, s_r), M in colmm.items():
            if not np.any(np.abs(M) > 0):
                continue
            kr_i = lay.kr[si]
            hr_o = hr_of(lay.kr[so])
            hr_b = hr_o ^ mr
            valid = popcount(hr_b) == kr_i
            bidx = np.where(valid, rank_r(np.where(valid, hr_b, 0)), 0)
            w = ((1 - 2.0 * parity(hr_b & s_r)) * valid).astype(np.float64)
            sign = 1.0
            nzi = np.nonzero(w)[0]
            if len(nzi) and w[nzi[0]] < 0:
                sign = -1.0
            wc = w * sign + 0.0  # +0.0 canonicalizes -0.0 on masked rows
            bidx_arr = None if (mr == 0 and np.all(valid)) \
                else bidx.astype(np.int32)
            key = (si, so,
                   None if bidx_arr is None else bidx_arr.tobytes(),
                   wc.tobytes())
            ent = pre.get(key)
            if ent is None:
                pre[key] = [bidx_arr, wc, sign * M]
                pre_order.append(key)
            else:
                ent[2] = ent[2] + sign * M

        self.col_channels = []   # (si, so, bidx|None, W|None, Mr, Mi|None)
        for key in pre_order:
            si, so = key[0], key[1]
            bidx_arr, wc, M = pre[key]
            if not np.any(np.abs(M) > 0):
                continue
            W = None if np.all(wc == 1.0) else wc.astype(real_dtype)
            Mr = np.ascontiguousarray(M.real, dtype=real_dtype)
            Mi = np.ascontiguousarray(M.imag, dtype=real_dtype) \
                if np.any(np.abs(M.imag) > 0) else None
            self.col_channels.append((si, so, bidx_arr, W, Mr, Mi))

        # row channels: same merging on the column scale
        rpre = {}
        rpre_order = []
        for (si, so, s_a), N in rowmm.items():
            if not np.any(np.abs(N) > 0):
                continue
            sa_o = sa_of(lay.ka[so])
            ca = (1 - 2.0 * parity(sa_o & s_a)).astype(np.float64)
            sign = 1.0
            if ca[0] < 0:
                sign = -1.0
            cc = ca * sign
            key = (si, so, cc.tobytes())
            ent = rpre.get(key)
            if ent is None:
                rpre[key] = [cc, sign * N]
                rpre_order.append(key)
            else:
                ent[1] = ent[1] + sign * N

        self.row_channels = []   # (si, so, ca|None, Nr, Ni|None)
        for key in rpre_order:
            si, so = key[0], key[1]
            cc, N = rpre[key]
            if not np.any(np.abs(N) > 0):
                continue
            ca_arr = None if np.all(cc == 1.0) else cc.astype(real_dtype)
            Nr = np.ascontiguousarray(N.real, dtype=real_dtype)
            Ni = np.ascontiguousarray(N.imag, dtype=real_dtype) \
                if np.any(np.abs(N.imag) > 0) else None
            self.row_channels.append((si, so, ca_arr, Nr, Ni))

        # ---- diagonal stream --------------------------------------------
        # built on device in one jitted pass over the traced index map —
        # the host equivalent moves O(nterms * dim) complex doubles and
        # dominated the build at large L (the reference's
        # PrecomputeDiagonal analog, bpetsc_template_1.c:169-202)
        self.diag = None
        if diag_terms:
            self.diag = _device_diagonal(plan, diag_terms, real_dtype)

        self._dedup()

    def _dedup(self):
        """Share identical matrices across channels (the low matrices, for
        one, depend only on the sector's low-half weight)."""
        pool = {}

        def share(a):
            if a is None:
                return None
            key = (a.shape, a.dtype.str, hash(a.tobytes()))
            got = pool.get(key)
            if got is not None and np.array_equal(got, a):
                return got
            pool[key] = a
            return a

        self.col_channels = [
            (si, so, share(b), share(w), share(mr), share(mi))
            for si, so, b, w, mr, mi in self.col_channels]
        self.row_channels = [
            (si, so, share(ca), share(nr), share(ni))
            for si, so, ca, nr, ni in self.row_channels]

    @property
    def table_bytes(self):
        seen = set()
        total = 0
        for ch in self.col_channels:
            for a in ch[2:]:
                if a is not None and id(a) not in seen:
                    seen.add(id(a))
                    total += a.nbytes
        for ch in self.row_channels:
            for a in ch[2:]:
                if a is not None and id(a) not in seen:
                    seen.add(id(a))
                    total += a.nbytes
        if self.diag is not None:
            total += sum(d.nbytes for d in self.diag if d is not None)
        return total

    @property
    def n_channels(self):
        return len(self.col_channels) + len(self.row_channels)


def _device_diagonal(plan, diag_terms, real_dtype):
    """(Dr, Di|None) host arrays of the diagonal field, computed on device:
    D[row] = sum_t c_t (-1)^{pc(state(row) & s_t)}."""
    import jax
    from .index_maps import parity_j

    has_imag = any(abs(c.imag) > 0 for c, _s in diag_terms)

    @jax.jit
    def build():
        rows = lax.broadcasted_iota(plan.int_dtype, (plan.dim_left,), 0)
        states = plan.row_states(rows)
        dr = jnp.zeros(plan.dim_left, real_dtype)
        di = jnp.zeros(plan.dim_left, real_dtype) if has_imag else None
        for c, s in diag_terms:
            w = (1 - 2 * parity_j(states & jnp.asarray(s, states.dtype))
                 ).astype(real_dtype)
            if c.real:
                dr = dr + float(c.real) * w
            if has_imag and c.imag:
                di = di + float(c.imag) * w
        return (dr, di) if has_imag else (dr,)

    out = build()
    Dr = np.asarray(out[0])
    Di = np.asarray(out[1]) if has_imag else None
    return (Dr, Di)


def matmul_precision():
    """Matmul precision of the sector and XOR-dense engines.

    HIGHEST in both precisions: below it, a GPU may take an f32 product in
    TF32 (a 10-bit mantissa, ~1e-3 relative), which stalls an f32 Lanczos
    residual far above the solver tolerances. ``config.sector_precision``
    ('default' | 'high' | 'highest') overrides it for measurements."""
    from .. import config
    name = getattr(config, 'sector_precision', None)
    if name is not None:
        return {'default': lax.Precision.DEFAULT,
                'high': lax.Precision.HIGH,
                'highest': lax.Precision.HIGHEST}[name]
    return lax.Precision.HIGHEST


def build_sector_apply(plan, left, right):
    """Returns the traceable (2, dim) -> (2, dim) sector-engine apply and
    its SectorPlan, or (None, None) when unsupported / over budget."""
    from .. import config
    from . import ell

    if not sector_supported(plan, left, right):
        return None, None
    if not getattr(config, 'use_sector', True):
        return None, None
    if table_bytes_estimate(plan, left, right) > ell.ell_budget():
        return None, None

    sp = SectorPlan(plan, left, right, config.real_dtype)
    lay = sp.lay
    secs = sp.secs
    base_off = int(lay.off[secs[0]])
    offs = [int(lay.off[s]) - base_off for s in secs]
    shapes = [(int(lay.nb[s]), int(lay.na[s])) for s in secs]
    prec = matmul_precision()

    col_channels = [
        (sp.sec_index[si], sp.sec_index[so],
         None if b is None else jnp.asarray(b),
         None if w is None else jnp.asarray(w),
         jnp.asarray(mr), None if mi is None else jnp.asarray(mi))
        for si, so, b, w, mr, mi in sp.col_channels]
    row_channels = [
        (sp.sec_index[si], sp.sec_index[so],
         None if ca is None else jnp.asarray(ca),
         jnp.asarray(nr), None if ni is None else jnp.asarray(ni))
        for si, so, ca, nr, ni in sp.row_channels]
    diag = None if sp.diag is None else tuple(
        None if d is None else jnp.asarray(d) for d in sp.diag)
    dim = sp.dim

    def cplx_col(src, Mr, Mi):
        """(2, nb, na_i) @ M^T with complex M in the stacked-real layout."""
        yr = jnp.einsum('bi,oi->bo', src[0], Mr, precision=prec)
        yi = jnp.einsum('bi,oi->bo', src[1], Mr, precision=prec)
        if Mi is not None:
            yr = yr - jnp.einsum('bi,oi->bo', src[1], Mi, precision=prec)
            yi = yi + jnp.einsum('bi,oi->bo', src[0], Mi, precision=prec)
        return jnp.stack([yr, yi])

    def cplx_row(Nr, Ni, src):
        yr = jnp.einsum('ob,ba->oa', Nr, src[0], precision=prec)
        yi = jnp.einsum('ob,ba->oa', Nr, src[1], precision=prec)
        if Ni is not None:
            yr = yr - jnp.einsum('ob,ba->oa', Ni, src[1], precision=prec)
            yi = yi + jnp.einsum('ob,ba->oa', Ni, src[0], precision=prec)
        return jnp.stack([yr, yi])

    # ---- cross-sector matmul batching -----------------------------------
    # channels sharing the same (deduplicated) matrices — e.g. the merged
    # low-half A matrix, identical for every sector of a given low weight,
    # or a cross family's M across the two top-spin copies — run as ONE
    # matmul over their concatenated source rows. At chain-model channel
    # counts each matmul is small, so the fixed cost per matmul dominates
    # and halving the matmul count is a direct win.
    col_groups = {}      # matrix identity -> group index
    groups = []          # [{'members': [(si, so, bidx, W)], 'Mr', 'Mi'}]
    chan_slot = []       # per col channel: (group id, member rank)
    for (si, so, b, w, mr_np, mi_np), ch in zip(sp.col_channels,
                                                col_channels):
        key = (id(mr_np), None if mi_np is None else id(mi_np),
               None if b is None else (id(b), True))
        gid = col_groups.get(key)
        if gid is None:
            gid = len(groups)
            col_groups[key] = gid
            groups.append({'members': [], 'Mr': ch[4], 'Mi': ch[5]})
        groups[gid]['members'].append((ch[0], ch[1], ch[2], ch[3]))
        chan_slot.append((gid, len(groups[gid]['members']) - 1))

    # channels grouped by output sector: the apply finalizes one output
    # block at a time through a dynamic_update_slice chain, so XLA cannot
    # keep hundreds of sector-sized channel outputs live simultaneously
    # (unordered accumulation ran out of device memory on the 450-channel
    # 27-site kagome, dim 2.0e7 — the per-block peak is a handful of blocks
    # plus the pending slices of in-flight batched groups)
    by_out = {o: ([], []) for o in range(len(secs))}
    for ci, ch in enumerate(col_channels):
        by_out[ch[1]][0].append(chan_slot[ci])
    for ch in row_channels:
        by_out[ch[1]][1].append(ch)

    def apply_fn(x):
        dtype = x.dtype
        xs = [lax.slice(x, (0, off), (2, off + nb * na)).reshape(2, nb, na)
              for off, (nb, na) in zip(offs, shapes)]

        pending = {}

        def group_out(gid, rank):
            got = pending.pop((gid, rank), None)
            if got is not None:
                return got
            g = groups[gid]
            members = g['members']
            srcs = []
            for si, _so, bidx, _W in members:
                s = xs[si]
                if bidx is not None:
                    s = jnp.take(s, bidx, axis=1)
                srcs.append(s)
            src = srcs[0] if len(srcs) == 1 \
                else jnp.concatenate(srcs, axis=1)
            out = cplx_col(src, g['Mr'], g['Mi']).astype(dtype)
            row0 = 0
            res = None
            for r, (si, _so, bidx, _W) in enumerate(members):
                nrows = (shapes[si][0] if bidx is None
                         else int(bidx.shape[0]))
                piece = lax.slice(out, (0, row0, 0),
                                  (2, row0 + nrows, out.shape[2]))
                row0 += nrows
                if r == rank:
                    res = piece
                else:
                    pending[(gid, r)] = piece
            return res

        y = jnp.zeros((2, dim), dtype)
        for so in range(len(secs)):
            cols, rows = by_out[so]
            if not cols and not rows:
                continue
            acc = None
            for gid, rank in cols:
                _si, _so2, _bidx, W = groups[gid]['members'][rank]
                out = group_out(gid, rank)
                if W is not None:
                    out = out * W[None, :, None].astype(dtype)
                acc = out if acc is None else acc + out
            for si, _so, ca, Nr, Ni in rows:
                out = cplx_row(Nr, Ni, xs[si]).astype(dtype)
                if ca is not None:
                    out = out * ca[None, None, :].astype(dtype)
                acc = out if acc is None else acc + out
            y = lax.dynamic_update_slice(
                y, acc.reshape(2, -1), (0, offs[so]))

        if diag is not None:
            Dr, Di = diag
            Dr = Dr.astype(dtype)
            yr = y[0] + Dr * x[0]
            yi = y[1] + Dr * x[1]
            if Di is not None:
                Di = Di.astype(dtype)
                yr = yr - Di * x[1]
                yi = yi + Di * x[0]
            y = jnp.stack([yr, yi])
        return y

    apply_fn.sector_plan = sp
    return apply_fn, sp
