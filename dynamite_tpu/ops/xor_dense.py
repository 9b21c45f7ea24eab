"""
XOR-blocked dense-matmul engine for many-mask XOR-mode operators (SYK).

Operators like SYK carry thousands of distinct Pauli masks; the reference
streams them as explicit CSR (bpetsc_template_2.c:57-205) and earlier
revisions here used a gather-table scan — both bound by an index stream.

This engine restructures the matvec into dense matmuls.  On an XOR-mode
pair (Full/Parity), a term acts in index space as

    y[j] += c * (-1)^{pc(j & s)} * x[j ^ m].

Split the index j = (h, a) into high/low halves (a = La low bits) and view
the state as an (nh, na) matrix.  Terms sharing the *high* parts (mh, sh)
of their mask and sign AND the type of their coefficient (purely real or
purely imaginary — every Pauli-string term is one or the other) merge into
one channel:

    Y += diag((-1)^{pc(h & sh)}) . X[h ^ mh, :] @ B_{mh,sh,type}^T

where B[a_out, a_in] = sum of |c| * sign * (-1)^{pc(a_out & s_low)} over
the channel's terms with a_in = a_out ^ m_low.  Keying on the coefficient
type keeps every channel SINGLE-table: a real-type channel multiplies both
planes by B; an imaginary-type channel multiplies and rotates the planes
(yr -= B xi, yi += B xr).  Compared to carrying (real, imag) table pairs on
every channel this halves both the table stream and the matmul work of
pure channels — on SYK N=32 at La=9, 2.29 GB -> 1.54 GB and 378 of 1093
(mh, sh) channels were mixed-type pairs.

The row permutation is a cheap contiguous-row gather; the column action is
one (2*nh, na) @ (na, na) matmul per channel — the re/im planes are folded
into the ROW axis, so each product has twice the rows even when nh is
small. The apply is a lax.scan per type class with uniform shapes — one
stacked (C, na, na) matrix table streamed from device memory, one (C, nh)
row index table, one (C, nh) row sign table — so program size is O(1) in
the term count.

La is chosen to minimize the bytes one apply streams (the channel tables
plus the gathered source rows) under the table budget (config.ell_budget);
see pick_split.
"""

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..utils.bitwise import parity

MIN_DIM = 1 << 12     # below this, launch overhead dominates any engine
CHANNEL_BATCH = 64    # channels per scan step (amortizes step dispatch)
_COEFF_TOL = 0.0         # exact: a term is real xor imaginary


def _typed_channels_at(groups, eff, La):
    """Distinct (mh, sh, type) channel keys at a given split."""
    keys = set()
    for gi, (m, pm, signs, coeffs) in enumerate(groups):
        mh = pm >> La
        for (s_eff, _sgn), c in zip(eff[gi], coeffs):
            if abs(c.real) > _COEFF_TOL:
                keys.add((mh, s_eff >> La, 0))
            if abs(c.imag) > _COEFF_TOL:
                keys.add((mh, s_eff >> La, 1))
    return keys


def split_range(nbits):
    """The candidate splits. Below nbits // 2 - 3 the gathered rows alone
    stream more bytes than the minimum (SYK N=32-40)."""
    return range(max(1, nbits // 2 - 3), nbits)


def pick_split(groups, eff, nbits, budget, coeff_bytes):
    """Choose La minimizing the bytes one apply streams: the channel tables
    (C * na^2 coefficients) plus the gathered source rows (C channels of
    (2, nh, na)). Growing La merges channels (C falls) but widens the
    tables, so the two streams trade off; no device rate enters. Measured
    on an H100 (PERF.md), this minimum is the fastest La for SYK N=32 and
    N=36; at N=40 it picks La=9 where La=8, with 29% fewer matmul FLOPs,
    is 1.19x faster (config.xor_dense_la overrides the choice).
    Returns (bytes, La, C, table bytes), or None when no split fits the
    table budget."""
    best = None
    for La in split_range(nbits):
        na = 1 << La
        nh = 1 << (nbits - La)
        C = len(_typed_channels_at(groups, eff, La))
        table = C * na * na * coeff_bytes
        if table > budget:
            continue
        streamed = table + C * 2 * nh * na * coeff_bytes
        if best is None or streamed < best[0]:
            best = (streamed, La, C, table)
    return best


def xor_dense_supported(plan):
    from .. import config
    if not getattr(config, 'use_xor_dense', True):
        return False
    if not plan.xor_mode or plan.dim_left != plan.dim_right:
        return False
    if not plan.use_scan:
        return False  # few-mask operators keep the fused sweep paths
    if plan.dim_right < MIN_DIM:
        return False
    return (plan.dim_right & (plan.dim_right - 1)) == 0


def _class_scan(Ms, rowidx, wh, na, nh, prec, imag_type, batch):
    """Build the scan over one type class. Tables: (C_pad, na, na),
    (C_pad, nh), (C_pad, nh) reshaped into (S, KB, ...) step batches.

    Each step is ONE batched gather + ONE batched dot_general over its KB
    channels (an unrolled per-channel inner loop cost ~4x the ops per
    step)."""
    C_pad = Ms.shape[0]
    S = C_pad // batch
    Ms_d = jnp.asarray(Ms.reshape(S, batch, na, na))
    rowidx_d = jnp.asarray(rowidx.reshape(S, batch, nh))
    wh_d = jnp.asarray(wh.reshape(S, batch, nh))

    def run(xv, y, dtype):
        # xv: (2, nh, na)
        def step(y, args):
            M, ridx, w = args
            src = jnp.take(xv, ridx.reshape(-1), axis=1) \
                .reshape(2, batch, nh, na)
            # batch over channels; the (plane, row) free dims fold into
            # the rows of one product
            out = lax.dot_general(
                src, M.astype(dtype),
                (((3,), (2,)), ((1,), (0,))),
                precision=prec)                     # (batch, 2, nh, na)
            out = out * w.astype(dtype)[:, None, :, None]
            contrib = jnp.sum(out, axis=0)          # (2, nh, na)
            if imag_type:
                # table holds the term coefficients' imaginary parts:
                # y += i * (B x)
                y = y + jnp.stack([-contrib[1], contrib[0]])
            else:
                y = y + contrib
            return y, None

        y, _ = lax.scan(step, y, (Ms_d, rowidx_d, wh_d))
        return y

    return run


def build_xor_dense(plan, left, right):
    """Returns (apply_fn, info) or (None, None). apply_fn maps the
    (2, dim) stacked-real state through the typed channel scans."""
    from .. import config
    from . import ell
    from .index_maps import effective_sign_mask
    from .sector_apply import matmul_precision

    if not xor_dense_supported(plan):
        return None, None

    nbits = plan.dim_right.bit_length() - 1
    real_dtype = config.real_dtype
    cb = np.dtype(real_dtype).itemsize

    # effective index-space sign masks (folds the Parity subspace bit)
    eff = []
    try:
        for m, pm, signs, coeffs in plan.groups:
            eff.append([effective_sign_mask(int(s), int(m), left, right)
                        for s in signs])
    except TypeError:
        return None, None

    pick = pick_split(plan.groups, eff, nbits, ell.ell_budget(), cb)
    if pick is None:
        return None, None
    _bytes, La, C, _table = pick
    # manual override for tuning experiments (config.xor_dense_la)
    La_cfg = getattr(config, 'xor_dense_la', None)
    if La_cfg is not None:
        La = int(La_cfg)
    na = 1 << La
    nh = 1 << (nbits - La)
    amask = na - 1

    # ---- host build of the typed channel tables -------------------------
    chan = {}
    a = np.arange(na, dtype=np.int64)
    for gi, (m, pm, signs, coeffs) in enumerate(plan.groups):
        pm = int(pm)
        mh, ml = pm >> La, pm & amask
        cols = a ^ ml
        for (s_eff, const_sign), c in zip(eff[gi], coeffs):
            sh, sa = s_eff >> La, s_eff & amask
            w = 1.0 - 2.0 * parity(a & sa)
            for typ, part in ((0, (complex(c) * const_sign).real),
                              (1, (complex(c) * const_sign).imag)):
                if abs(part) <= _COEFF_TOL:
                    continue
                key = (mh, sh, typ)
                B = chan.get(key)
                if B is None:
                    B = np.zeros((na, na), dtype=np.float64)
                    chan[key] = B
                B[a, cols] += part * w

    h = np.arange(nh, dtype=np.int64)
    prec = matmul_precision()
    runs = []
    table_bytes = 0
    for typ in (0, 1):
        keys = sorted(k for k in chan if k[2] == typ)
        if not keys:
            continue
        Ct = len(keys)
        KB = min(CHANNEL_BATCH, Ct)
        C_pad = -(-Ct // KB) * KB
        Ms = np.zeros((C_pad, na, na), dtype=real_dtype)
        rowidx = np.tile(h.astype(np.int32), (C_pad, 1))
        wh = np.zeros((C_pad, nh), dtype=real_dtype)
        for i, k in enumerate(keys):
            Ms[i] = chan[k]
            rowidx[i] = (h ^ k[0]).astype(np.int32)
            wh[i] = 1.0 - 2.0 * parity(h & k[1])
        table_bytes += Ms.nbytes + rowidx.nbytes + wh.nbytes
        runs.append(_class_scan(Ms, rowidx, wh, na, nh, prec,
                                imag_type=bool(typ), batch=KB))

    def apply_fn(x):
        dtype = x.dtype
        xv = x.reshape(2, nh, na)
        y = jnp.zeros((2, nh, na), dtype)
        for run in runs:
            y = run(xv, y, dtype)
        return y.reshape(2, plan.dim_left)

    info = {'La': La, 'channels': len(chan), 'table_bytes': table_bytes}
    apply_fn.xor_dense_info = info
    return apply_fn, info
