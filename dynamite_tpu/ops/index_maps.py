"""
Device-side (traced, jittable) subspace index maps.

These are the JIT-specialized equivalents of the reference's C index-map
header (bsubspace_impl.h): for each subspace type, vectorized
state->index (s2i) and index->state (i2s) functions over integer lanes,
designed to be fused directly into the matvec kernel.

Each map is represented by a small host object with

* ``i2s(idx)``   — product state for each index (indices assumed valid)
* ``s2i(state)`` — (index, valid) pair; index is garbage where ~valid

built from the host-side Subspace objects via :func:`device_map`.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..utils.bitwise import parity as parity_np


def parity_j(x):
    """Parity (popcount mod 2) of each integer lane."""
    return lax.population_count(x) & jnp.asarray(1, x.dtype)


def effective_sign_mask(s, m, left, right):
    """Reduce parity(bra & s) to parity(k & s_eff) ^ const over row indices
    k, for XOR-mode subspace pairs.

    Full: bra = k ^ m            -> s_eff = s,        const = parity(m & s)
    Parity: bra = ((k<<1)|pb) ^ m with pb = parity(k) ^ space
        -> s_eff = (s>>1) ^ (all-ones if s&1), folding the parity bit's
           contribution parity(k) into the mask; const collects the m and
           space terms.
    Returns (s_eff, sign) with sign = +-1.
    """
    from .. import subspaces as sp
    lbase = left.parent if isinstance(left, sp.XParity) else left
    if isinstance(lbase, sp.Full):
        s_eff = int(s)
        const = int(parity_np(np.int64(s & m)))
        return s_eff, 1 - 2 * const
    if isinstance(lbase, sp.Parity):
        nbits = lbase.L - 1
        ones = (1 << nbits) - 1
        s_eff = (int(s) >> 1) ^ (ones if (s & 1) else 0)
        const = int(parity_np(np.int64((s >> 1) & (m >> 1))))
        const ^= int(s & 1) & (lbase.space ^ (int(m) & 1))
        return s_eff, 1 - 2 * const
    raise TypeError('effective sign mask only defined for Full/Parity')


class FullMap:
    def __init__(self, L):
        self.L = L

    def i2s(self, idx):
        return idx

    def s2i(self, state):
        return state, jnp.ones(state.shape, dtype=bool)


class ParityMap:
    def __init__(self, L, space):
        self.L = L
        self.space = space

    def i2s(self, idx):
        pbit = parity_j(idx) ^ jnp.asarray(self.space, idx.dtype)
        return (idx << 1) | pbit

    def s2i(self, state):
        valid = parity_j(state) == jnp.asarray(self.space, state.dtype)
        return state >> 1, valid


class SpinConserveMap:
    """Sector-major (un)ranking of fixed-popcount bitstrings (see
    ops/sectors.py): index = sector offset + rank(high rest) * na +
    rank(low half). The two half-rank loops are unrolled at trace time
    (together they cost the same L-1 fused steps as a flat combinatorial
    rank — the reference's formulation, bsubspace_impl.h:191-228 — while
    producing the layout the sector matmul engine needs)."""

    def __init__(self, L, k, nchoosek):
        from .sectors import layout
        self.L = L
        self.k = k
        self.nchoosek = np.asarray(nchoosek)  # [kk, n] = C(n, kk)
        self.lay = layout(L, k)

    def _rank(self, x, nbits, flat, ld):
        """Unrolled value-order combinatorial rank over one half."""
        dt = x.dtype
        one = jnp.asarray(1, dt)
        idx = jnp.zeros_like(x)
        kk = jnp.zeros_like(x)
        for n in range(nbits):
            bit = (x >> n) & one
            kk = kk + bit
            idx = idx + bit * flat[jnp.clip(kk, 0, self.k) * ld + n]
        return idx

    def _unrank(self, idx, k0, nbits, flat, ld):
        """Unrolled unrank over one half; k0 is a per-lane popcount."""
        dt = idx.dtype
        state = jnp.zeros_like(idx)
        k = k0
        for n in range(nbits, 0, -1):
            state = state << 1
            current = jnp.where(
                k > n - 1, jnp.zeros_like(idx),
                flat[jnp.clip(k, 0, self.k) * ld + (n - 1)])
            take = idx >= current
            idx = idx - jnp.where(take, current, 0)
            k = k - take.astype(dt)
            state = state | take.astype(dt)
        return state

    def i2s(self, idx):
        dt = idx.dtype
        lay = self.lay
        flat = jnp.asarray(self.nchoosek.reshape(-1), dtype=dt)
        ld = self.nchoosek.shape[1]
        offs = jnp.asarray(lay.off, dtype=dt)
        sec = jnp.searchsorted(offs, idx, side='right') - 1
        rem = idx - offs[sec]
        na = jnp.asarray(lay.na, dtype=dt)[sec]
        rb = rem // na
        ra = rem - rb * na
        hr = self._unrank(rb, jnp.asarray(lay.kr, dt)[sec], lay.Lr,
                          flat, ld)
        sa = self._unrank(ra, jnp.asarray(lay.ka, dt)[sec], lay.La,
                          flat, ld)
        t = jnp.asarray(lay.t, dt)[sec]
        return (t << (self.L - 1)) | (hr << lay.La) | sa

    def s2i(self, state):
        dt = state.dtype
        lay = self.lay
        flat = jnp.asarray(self.nchoosek.reshape(-1), dtype=dt)
        ld = self.nchoosek.shape[1]
        one = jnp.asarray(1, dt)
        t = (state >> (self.L - 1)) & one
        hr = (state >> lay.La) & jnp.asarray((1 << lay.Lr) - 1, dt)
        sa = state & jnp.asarray((1 << lay.La) - 1, dt)
        kr = lax.population_count(hr)
        ka = lax.population_count(sa)
        valid = (t + kr + ka) == jnp.asarray(self.k, dt)
        slot = t * (lay.Lr + 1) + kr
        off = jnp.asarray(lay.off_tk, dtype=dt)[slot]
        na = jnp.asarray(lay.na_tk, dtype=dt)[slot]
        rb = self._rank(hr, lay.Lr, flat, ld)
        ra = self._rank(sa, lay.La, flat, ld)
        return off + rb * na + ra, valid


class ExplicitMap:
    """Sorted-array binary search (as jnp.searchsorted) with an optional
    permutation back to user order (reference: bsubspace_impl.h:306-331)."""

    def __init__(self, L, state_map, rmap_states, rmap_indices):
        self.L = L
        self.state_map = np.asarray(state_map)
        self.rmap_states = np.asarray(rmap_states)
        self.rmap_indices = (None if rmap_indices is None
                             else np.asarray(rmap_indices))

    def i2s(self, idx):
        table = jnp.asarray(self.state_map, dtype=idx.dtype)
        return table[idx]

    def s2i(self, state):
        dt = state.dtype
        sorted_states = jnp.asarray(self.rmap_states, dtype=dt)
        pos = jnp.searchsorted(sorted_states, state)
        pos = jnp.minimum(pos, len(self.rmap_states) - 1)
        valid = sorted_states[pos] == state
        if self.rmap_indices is not None:
            idx = jnp.asarray(self.rmap_indices, dtype=dt)[pos]
        else:
            idx = pos.astype(dt)
        return idx, valid


def device_map(subspace):
    """Build the device index map for a host Subspace object.

    XParity is handled at the operator level (its MSC gets rewritten and its
    index maps coincide with the parent's on representatives), so here it
    resolves to its parent's map.
    """
    from .. import subspaces as sp

    if isinstance(subspace, sp.XParity):
        return device_map(subspace.parent)
    if isinstance(subspace, sp.Full):
        return FullMap(subspace.L)
    if isinstance(subspace, sp.Parity):
        return ParityMap(subspace.L, subspace.space)
    if isinstance(subspace, sp.SpinConserve):
        return SpinConserveMap(subspace.L, subspace.k, subspace.nchoosek)
    if isinstance(subspace, sp.Explicit):
        return ExplicitMap(subspace.L, subspace.state_map,
                           subspace.rmap_states, subspace.rmap_indices)
    raise TypeError(f'no device map for subspace type {type(subspace)}')
