"""
Reduced density matrices.

The state, viewed as a [2]*L tensor over the spins, is transposed so the
kept spins lead, reshaped to (2^k, 2^(L-k)), and contracted
rho = V V^dagger — one matmul on the device mesh, instead of the
reference's gather-to-rank-0 outer-product loop
(bpetsc_template_1.c:87-165, a scalability bottleneck acknowledged in the
reference's docs/FAQ.rst:35). For subspace states the amplitudes are first
scattered into the (sharded) full space through the traced subspace index
map; the only host transfer is the final 2^k x 2^k density matrix.

Bit convention: spin i is bit i (LSB) of the state integer; the returned
density matrix is indexed by r = sum_j bit(keep[j]) << j, matching the
reference's combine_states interleave (bpetsc_template_1.c:29-55).
"""

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

# HIGHEST: below it a GPU may take the f32 products in TF32 (~1e-3
# relative), which would blur the small eigenvalues of rho
_mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def _bit_perm(L, keep):
    """The tensor-axis permutation that brings the kept spins to the front
    (most-significant kept bit first): axis a of the [2]*L view corresponds
    to bit (L-1-a) of the state integer."""
    keep = list(map(int, keep))
    traced = [i for i in range(L) if i not in keep]
    return ([L - 1 - b for b in reversed(keep)]
            + [L - 1 - b for b in reversed(traced)])


def _merged_transpose(L, perm):
    """Collapse runs of source axes that stay adjacent under ``perm`` so the
    device transpose operates on the lowest possible rank (contiguous keep
    regions — the common entropy cut — reduce to a rank<=3 transpose).

    Returns (src_dims, merged_perm): reshape the 2^L vector to ``src_dims``,
    transpose with ``merged_perm``.
    """
    # group dest-consecutive source axes that are also source-consecutive
    groups = []  # (src_start, length), in dest order
    for ax in perm:
        if groups and ax == groups[-1][0] + groups[-1][1]:
            groups[-1] = (groups[-1][0], groups[-1][1] + 1)
        else:
            groups.append((ax, 1))
    src_order = sorted(range(len(groups)), key=lambda g: groups[g][0])
    src_dims = [1 << groups[g][1] for g in src_order]
    rank = {g: i for i, g in enumerate(src_order)}
    merged_perm = [rank[g] for g in range(len(groups))]
    return src_dims, merged_perm


@lru_cache(maxsize=32)
def _build_rdm_device(subspace, keep, int_dtype):
    """Jitted (2, dim) re/im state -> (rho_re, rho_im) on device.

    The subspace scatter, bit transpose, and V V^dagger contraction run in
    one compiled program; GSPMD inserts the collectives when the input is
    sharded over the mesh.
    """
    from .. import subspaces as sp
    from .index_maps import device_map

    L = subspace.L
    k = len(keep)
    full_dim = 1 << L
    is_full = isinstance(subspace, sp.Full)
    imap = None if is_full else device_map(subspace)
    dim = subspace.get_dimension()
    src_dims, merged_perm = _merged_transpose(L, _bit_perm(L, keep))

    from ..utils.hoist import hjit

    @hjit
    def rdm(data):
        data = data[:, :dim]  # drop any storage pad (parallel.mesh)
        if is_full:
            full = data
        else:
            states = imap.i2s(jnp.arange(dim, dtype=int_dtype))
            full = jnp.zeros((2, full_dim), dtype=data.dtype)
            full = full.at[:, states].set(data)
        V = jnp.transpose(
            full.reshape([2] + src_dims),
            [0] + [a + 1 for a in merged_perm]).reshape(2, 1 << k, -1)
        Vr, Vi = V[0], V[1]
        rho_re = _mm(Vr, Vr.T) + _mm(Vi, Vi.T)
        rho_im = _mm(Vi, Vr.T) - _mm(Vr, Vi.T)
        return rho_re, rho_im

    return rdm


def rdm_device(state, keep):
    """Compute the RDM on the device mesh; host transfer only for the final
    2^k x 2^k matrix (reference analog: bpetsc_template_1.c:87-165, which
    instead gathers the full vector to rank 0)."""
    from .. import subspaces as sp

    L = state.L
    keep = tuple(map(int, np.asarray(keep, dtype=np.int64)))
    if isinstance(state.subspace, sp.SpinConserve):
        return rdm_spinconserve(state, keep)
    int_dtype = jnp.int32 if L <= 31 else jnp.int64
    fn = _build_rdm_device(state.subspace, keep, int_dtype)
    rho_re, rho_im = fn(state.data)
    rho_re, rho_im = jax.device_get((rho_re, rho_im))
    return (np.asarray(rho_re, dtype=np.float64)
            + 1j * np.asarray(rho_im, dtype=np.float64))


def _unrank_subset_j(rank, kk, nbits, nck, kmax, int_dtype):
    """Traced inverse combinatorial rank: the popcount-``kk`` nbits-bit
    integer with value-order rank ``rank`` (rank may be an array; kk is a
    static int). jnp analog of sectors.unrank_bits."""
    idx = rank.astype(int_dtype)
    k = jnp.full(idx.shape, kk, int_dtype)
    state = jnp.zeros(idx.shape, int_dtype)
    nck_d = jnp.asarray(nck, int_dtype)
    for n in range(nbits, 0, -1):
        state = state << 1
        cur = jnp.where(k > n - 1, 0,
                        nck_d[jnp.minimum(k, kmax), n - 1])
        take = idx >= cur
        idx = idx - jnp.where(take, cur, 0)
        k = k - take.astype(int_dtype)
        state = state | take.astype(int_dtype)
    return state


def _deposit_j(compact, bits, int_dtype):
    """Scatter bit p of ``compact`` to absolute position bits[p]."""
    out = jnp.zeros(compact.shape, int_dtype)
    for p, b in enumerate(bits):
        out = out | (((compact >> p) & 1) << b)
    return out


@lru_cache(maxsize=32)
def _build_rdm_spinconserve(subspace, keep, int_dtype):
    """Jitted (2, storage) state -> per-weight-block RDM factors.

    In a fixed-Hamming-weight space the RDM over the kept spins is BLOCK
    DIAGONAL in the kept weight g (the traced weight k - g is shared by
    bra and ket), and each block is B_g^dagger B_g where
    B_g[rank(traced bits), rank(kept bits)] holds the amplitudes of that
    weight class. Every entry's source index follows in closed form from
    (un)ranking arithmetic, so — unlike the product-basis path above —
    NOTHING of size 2^L is ever materialized: total gathered elements =
    dim = C(L, k), and the largest temporary is one weight block
    (C(L/2, g) x C(L/2, k-g) at a half cut). The reference walks the same
    weight classes serially on rank 0 (bpetsc_template_1.c:87-165); here
    each block is one matrix contraction.
    """
    from math import comb
    from .index_maps import device_map
    from . import sectors as sec_mod

    L = subspace.L
    k = subspace.k
    keep_bits = list(keep)
    traced_bits = [b for b in range(L) if b not in keep]
    nK, nT = len(keep_bits), len(traced_bits)
    smap = device_map(subspace)
    nck = sec_mod.nchoosek_table(L, k)

    gs = [g for g in range(min(k, nK) + 1) if 0 <= k - g <= nT]

    from ..utils.hoist import hjit

    @hjit
    def blocks(data):
        out = []
        for g in gs:
            n_k = comb(nK, g)
            n_t = comb(nT, k - g)
            p = jnp.arange(n_t * n_k, dtype=int_dtype)
            rt = p // n_k
            rk = p - rt * n_k
            t = _unrank_subset_j(rt, k - g, nT, nck, k, int_dtype)
            r = _unrank_subset_j(rk, g, nK, nck, k, int_dtype)
            s = _deposit_j(t, traced_bits, int_dtype) \
                | _deposit_j(r, keep_bits, int_dtype)
            idx, _valid = smap.s2i(s)   # every s is in the subspace
            B = data[:, idx].reshape(2, n_t, n_k)
            br, bi = B[0], B[1]
            rho_re = _mm(br.T, br) + _mm(bi.T, bi)
            rho_im = _mm(bi.T, br) - _mm(br.T, bi)
            out.append((rho_re, rho_im))
        return out

    return blocks, gs


def rdm_spinconserve(state, keep):
    """SpinConserve RDM from per-weight blocks (no 2^L intermediate)."""
    from . import sectors as sec_mod

    sub = state.subspace
    L = sub.L
    int_dtype = jnp.int32 if L <= 31 else jnp.int64
    fn, gs = _build_rdm_spinconserve(sub, tuple(map(int, keep)), int_dtype)
    blocks = jax.device_get(fn(state.data))

    nK = len(keep)
    rho = np.zeros((1 << nK, 1 << nK), dtype=np.complex128)
    for g, (re, im) in zip(gs, blocks):
        pos = sec_mod.states_of_popcount(nK, g)
        rho[np.ix_(pos, pos)] = (np.asarray(re, dtype=np.float64)
                                 + 1j * np.asarray(im, dtype=np.float64))
    return rho


def rdm_host(state, keep):
    """Compute the RDM on the host from a gathered state vector."""
    from .. import subspaces as sp

    L = state.L
    keep = np.asarray(keep, dtype=np.int64)
    amps = state.to_numpy()

    if isinstance(state.subspace, sp.Full):
        full = amps
    else:
        full = np.zeros(1 << L, dtype=np.complex128)
        dim = len(amps)
        block = 1 << 16
        for start in range(0, dim, block):
            stop = min(dim, start + block)
            states = state.subspace.idx_to_state(np.arange(start, stop))
            full[states] = amps[start:stop]

    return rdm_from_full_vector(full, keep, L)


def rdm_from_full_vector(full, keep, L):
    """rho = Tr_traced |psi><psi| for a full-space vector."""
    keep = list(map(int, keep))
    traced = [i for i in range(L) if i not in keep]
    k = len(keep)

    # tensor axis a corresponds to bit (L-1-a); put kept bits leading,
    # most-significant kept bit first
    tensor = full.reshape([2] * L)
    perm = ([L - 1 - b for b in reversed(keep)]
            + [L - 1 - b for b in reversed(traced)])
    V = np.transpose(tensor, perm).reshape(1 << k, 1 << (L - k))
    return V @ V.conj().T
