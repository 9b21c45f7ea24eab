"""
Unit tests for subspace index maps (modeled on the reference's
tests/unit/test_subspaces.py: dimensions and mappings computed two ways).
"""

import numpy as np
import pytest

from dynamite_tpu.subspaces import (Full, Parity, SpinConserve, Explicit,
                                    Auto, XParity)
from dynamite_tpu.utils.bitwise import popcount, parity


class TestFull:
    def test_dimension(self):
        for L in (1, 4, 10):
            assert Full(L=L).get_dimension() == 2 ** L

    def test_maps(self):
        s = Full(L=5)
        idx = np.arange(32)
        assert np.array_equal(s.idx_to_state(idx), idx)
        assert np.array_equal(s.state_to_idx(idx), idx)

    def test_out_of_bounds(self):
        s = Full(L=3)
        with pytest.raises(ValueError):
            s.idx_to_state(8)

    def test_equality(self):
        assert Full(L=4) == Full(L=4)
        assert Full(L=4) != Full(L=5)


class TestParity:
    @pytest.mark.parametrize('space', [0, 1])
    def test_roundtrip(self, space):
        for L in (2, 5):
            s = Parity(space, L=L)
            dim = s.get_dimension()
            assert dim == 2 ** (L - 1)
            states = s.idx_to_state(np.arange(dim))
            # all states have the right parity, are unique, and map back
            assert np.all(parity(states) == space)
            assert len(np.unique(states)) == dim
            assert np.array_equal(s.state_to_idx(states), np.arange(dim))

    def test_wrong_parity_state(self):
        s = Parity('even', L=4)
        assert s.state_to_idx(0b0001) == -1
        assert s.state_to_idx(0b0011) != -1

    def test_space_validation(self):
        assert Parity('even').space == 0
        assert Parity('odd').space == 1
        with pytest.raises(ValueError):
            Parity('sideways')


class TestSpinConserve:
    @pytest.mark.parametrize('L,k', [(4, 2), (6, 3), (8, 2), (7, 5)])
    def test_roundtrip(self, L, k):
        from math import comb
        s = SpinConserve(L, k)
        dim = s.get_dimension()
        assert dim == comb(L, k)
        states = s.idx_to_state(np.arange(dim))
        assert np.all(popcount(states) == k)
        assert len(np.unique(states)) == dim
        assert np.array_equal(s.state_to_idx(states), np.arange(dim))

    def test_sector_major_order(self):
        """States are emitted sector-major: primarily by the top spin, then
        by the Hamming weight of the high rest, then by value within each
        half (ops/sectors.py) — the ordering that makes every sector a
        contiguous matrix block for the sector matmul engine."""
        L, k = 5, 2
        s = SpinConserve(L, k)
        La = L // 2

        def key(x):
            t = x >> (L - 1)
            hr = (x >> La) & ((1 << (L - La - 1)) - 1)
            return (t, bin(hr).count('1'), hr, x & ((1 << La) - 1))

        expected = sorted((x for x in range(2 ** L)
                           if bin(x).count('1') == k), key=key)
        got = s.idx_to_state(np.arange(s.get_dimension()))
        assert list(got) == expected

    def test_xparity_representatives_first(self):
        """For k = L/2 the first dim/2 states have the top spin clear —
        the invariant XParity's representative convention needs."""
        L = 6
        s = SpinConserve(L, L // 2)
        dim = s.get_dimension()
        states = s.idx_to_state(np.arange(dim))
        assert np.all(states[:dim // 2] >> (L - 1) == 0)
        assert np.all(states[dim // 2:] >> (L - 1) == 1)
        # complementation is exact index reversal
        flip = (1 << L) - 1
        assert np.array_equal(s.state_to_idx(flip ^ states),
                              np.arange(dim)[::-1])

    def test_wrong_weight(self):
        s = SpinConserve(4, 2)
        assert s.state_to_idx(0b0001) == -1
        assert s.state_to_idx(0b0111) == -1

    def test_k_validation(self):
        with pytest.raises(ValueError):
            SpinConserve(4, 5)


class TestExplicit:
    def test_sorted_list(self):
        states = [0b00, 0b11, 0b101]
        s = Explicit(states, L=3)
        assert s.get_dimension() == 3
        assert np.array_equal(s.idx_to_state(np.arange(3)), states)
        assert np.array_equal(s.state_to_idx(np.array(states)),
                              np.arange(3))
        assert s.state_to_idx(0b10) == -1

    def test_unsorted_list(self):
        states = [0b101, 0b00, 0b11]
        s = Explicit(states, L=3)
        assert np.array_equal(s.idx_to_state(np.arange(3)), states)
        assert np.array_equal(s.state_to_idx(np.array(states)),
                              np.arange(3))

    def test_unique(self):
        with pytest.raises(ValueError):
            Explicit([1, 2, 1], L=2)

    def test_L_check(self):
        with pytest.raises(ValueError):
            Explicit([0b111], L=2)

    def test_equals_spinconserve(self):
        sc = SpinConserve(5, 2)
        ex = Explicit(sc.idx_to_state(np.arange(sc.get_dimension())), L=5)
        assert ex == sc


class TestAuto:
    def test_finds_spinconserve_sector(self):
        from dynamite_tpu.models import heisenberg
        H = heisenberg(6)
        auto = Auto(H, 'UUUDDD')
        sc = SpinConserve(6, 3)
        assert auto.get_dimension() == sc.get_dimension()
        assert auto == sc

    def test_nosort_is_same_set(self):
        from dynamite_tpu.models import heisenberg
        H = heisenberg(6)
        a1 = Auto(H, 'UUUDDD')
        a2 = Auto(H, 'UUUDDD', sort=False)
        assert set(a1.state_map) == set(a2.state_map)


class TestReprs:
    """repr() must evaluate back to an identical subspace."""

    cases = [
        lambda: Full(L=4),
        lambda: Parity('odd', L=5),
        lambda: Parity('even', L=3),
        lambda: SpinConserve(6, 3),
        lambda: Explicit([1, 2, 3], L=3),
        lambda: XParity(SpinConserve(6, 3), sector=-1),
        lambda: XParity(Full(L=4), sector='+'),
    ]

    @pytest.mark.parametrize('mk', cases)
    def test_eval_roundtrip(self, mk):
        s = mk()
        s2 = eval(repr(s))  # noqa: S307 - controlled input
        assert s2 == s and s2.get_dimension() == s.get_dimension()

    def test_explicit_repr_truncates(self):
        # a huge state list must not appear verbatim in the repr
        states = list(range(0, 512, 2))
        r = repr(Explicit(states, L=10))
        assert len(r) < 500


class TestChecksum:
    """The CRC over the subspace's state map: equal iff same basis order
    (reference analog: bsubspace checksums used by the cross-rank guard)."""

    def test_full(self):
        assert Full(L=6).get_checksum() == Full(L=6).get_checksum()
        assert Full(L=6).get_checksum() != Full(L=7).get_checksum()

    def test_parity_sectors_differ(self):
        assert (Parity(0, L=6).get_checksum()
                != Parity(1, L=6).get_checksum())

    def test_spinconserve_sectors_differ(self):
        assert (SpinConserve(6, 2).get_checksum()
                != SpinConserve(6, 3).get_checksum())

    def test_explicit_matches_equivalent(self):
        sc = SpinConserve(5, 2)
        ex = Explicit(sc.idx_to_state(np.arange(sc.get_dimension())), L=5)
        assert ex.get_checksum() == sc.get_checksum()

    def test_explicit_order_sensitivity(self):
        a = Explicit([1, 2, 4], L=3)
        b = Explicit([4, 2, 1], L=3)
        assert a.get_checksum() != b.get_checksum()


class TestLSemantics:
    def test_dimension_requires_L(self):
        with pytest.raises(ValueError):
            Full().get_dimension()

    def test_maps_require_L(self):
        with pytest.raises(ValueError):
            Parity('even').idx_to_state(0)

    def test_set_L_then_use(self):
        s = Full()
        s.L = 4
        assert s.get_dimension() == 16

    def test_L_is_write_once(self):
        s = Parity('odd')
        s.L = 4
        with pytest.raises(AttributeError):
            s.L = 5

    def test_spinconserve_L_fixed_at_init(self):
        s = SpinConserve(4, 2)
        with pytest.raises(AttributeError):
            s.L = 5

    def test_product_state_basis_flag(self):
        for s in (Full(L=4), Parity(0, L=4), SpinConserve(4, 2),
                  Explicit([0, 1], L=2)):
            assert s.product_state_basis
        assert not XParity(Full(L=4)).product_state_basis


class TestMappingEdges:
    def test_scalar_mapping(self):
        s = SpinConserve(4, 2)
        assert int(s.state_to_idx(0b0011)) == 0
        assert int(s.idx_to_state(0)) == 0b0011

    def test_invalid_idx_raises(self):
        for s in (Full(L=3), Parity(0, L=3), SpinConserve(4, 2)):
            with pytest.raises(ValueError):
                s.idx_to_state(s.get_dimension())
            with pytest.raises(ValueError):
                s.idx_to_state(-1)

    def test_invalid_state_gives_minus_one(self):
        s = SpinConserve(4, 2)
        got = s.state_to_idx(np.array([0b0011, 0b0111, 0b1100]))
        assert got[0] == 0 and got[1] == -1 and got[2] >= 0

    def test_full_is_identity_map(self):
        s = Full(L=6)
        idx = np.arange(64)
        assert np.array_equal(s.idx_to_state(idx), idx)

    def test_parity_exhaustive_L4(self):
        # the even sector of L=4, enumerated by brute force
        expected = [x for x in range(16) if bin(x).count('1') % 2 == 0]
        s = Parity('even', L=4)
        got = sorted(int(v) for v in s.idx_to_state(np.arange(8)))
        assert got == expected


def _xparity_embedding(sub):
    """Columns = (|s> + sector * |flip s>) / sqrt(2) over representative
    states s: the isometry from the XParity sector into the parent space."""
    parent = sub.parent
    L = sub.L
    dim = sub.get_dimension()
    pdim = parent.get_dimension()
    flip_all = (1 << L) - 1
    U = np.zeros((pdim, dim))
    reps = sub.idx_to_state(np.arange(dim))
    # representative states live on L-1 bits; embed into parent indices
    for j, r in enumerate(reps):
        s = int(r)
        U[int(parent.state_to_idx(s)), j] += 1 / np.sqrt(2)
        U[int(parent.state_to_idx(s ^ flip_all)), j] += sub.sector / np.sqrt(2)
    return U


class TestXParityReduceSpec:
    """reduce_msc against the U^dagger H U oracle: the reduced operator on
    the (L-1)-spin representative basis must equal the projection of the
    full operator onto the sector."""

    ops = [
        ('X_top', [(0b100, 0, 1.0)]),
        ('XX_pair', [(0b110, 0, 1.0)]),
        ('Z0Z2_even', [(0, 0b101, 1.0)]),
        ('ZZ_low', [(0, 0b011, 1.0)]),
        ('Y0Y2', [(0b101, 0b101, -1.0)]),
        ('XZ_mix', [(0b001, 0b010, 1.0)]),
        ('heis_like', [(0b011, 0, 0.5), (0b011, 0b011, 0.5),
                       (0, 0b011, 0.5), (0b110, 0, 0.5),
                       (0b110, 0b110, 0.5), (0, 0b110, 0.5)]),
    ]

    @pytest.mark.parametrize('name,msc', ops, ids=[o[0] for o in ops])
    @pytest.mark.parametrize('sector', ['+', '-'])
    def test_projection_oracle(self, name, msc, sector):
        from dynamite_tpu.ops.msc import msc_to_matrix, as_msc
        L = 3
        sub = XParity(Full(L=L), sector=sector)
        msc = as_msc(msc)
        H_full = msc_to_matrix(msc, (8, 8), sparse=False)
        commutes = np.allclose(H_full, np.eye(8)[::-1] @ H_full
                               @ np.eye(8)[::-1])

        reduced, conserved = sub.reduce_msc(msc, check_conserves=True)
        assert conserved == commutes

        dim = sub.get_dimension()
        H_red = msc_to_matrix(reduced, (dim, dim),
                              idx_to_state=sub.idx_to_state,
                              state_to_idx=sub.state_to_idx, sparse=False)
        U = _xparity_embedding(sub)
        expected = U.T @ H_full @ U
        if conserved:
            assert np.allclose(H_red, expected, atol=1e-12)

    def test_sign_flip_between_sectors(self):
        # a term that folds through the global flip changes sign with sector
        from dynamite_tpu.ops.msc import as_msc
        msc = as_msc([(0b100, 0, 2.0)])
        out_p = XParity(Full(L=3), sector='+').reduce_msc(msc)
        out_m = XParity(Full(L=3), sector='-').reduce_msc(msc)
        assert out_p['coeffs'][0] == -out_m['coeffs'][0]

    def test_cancellation(self):
        # X0X1X2 = sector * identity on the sector; minus the identity
        # cancels exactly in the + sector
        from dynamite_tpu.ops.msc import as_msc
        msc = as_msc([(0b111, 0, 1.0), (0, 0, -1.0)])
        out = XParity(Full(L=3), sector='+').reduce_msc(msc)
        assert out.size == 0


class TestAutoBFS:
    def test_connected_component_only(self):
        # an operator that only hops within a Sz sector: Auto finds exactly
        # the component of the seed state
        from dynamite_tpu.models import heisenberg
        H = heisenberg(4)
        auto = Auto(H, 'UUDD')
        from math import comb
        assert auto.get_dimension() == comb(4, 2)

    def test_diagonal_operator_single_state(self):
        from dynamite_tpu.operators import sigmaz, index_sum
        H = index_sum(sigmaz(), size=4)
        auto = Auto(H, 'UDUD')
        assert auto.get_dimension() == 1

    def test_string_and_int_seed_agree(self):
        from dynamite_tpu.models import heisenberg
        H = heisenberg(4)
        a = Auto(H, 'UDDU')
        b = Auto(H, 0b0110)
        assert a == b


class TestXParity:
    def test_dimension(self):
        s = XParity(Full(L=4))
        assert s.get_dimension() == 8

    def test_sector_validation(self):
        assert XParity(sector='+', L=4).sector == 1
        assert XParity(sector=-1, L=4).sector == -1
        with pytest.raises(ValueError):
            XParity(sector='x', L=4)

    def test_parent_validation(self):
        XParity(Parity('even', L=4))
        with pytest.raises(ValueError):
            XParity(Parity('even', L=5))
        XParity(SpinConserve(6, 3))
        with pytest.raises(ValueError):
            XParity(SpinConserve(6, 2))

    def test_reduce_msc_drops_noncommuting(self):
        from dynamite_tpu.ops.msc import as_msc
        s = XParity(Full(L=2))
        # single Z does not commute with XX
        out, conserved = s.reduce_msc(as_msc([(0, 1, 1)]),
                                      check_conserves=True)
        assert len(out) == 0
        assert not conserved

    def test_reduce_msc_folds(self):
        from dynamite_tpu.ops.msc import as_msc
        L = 3
        s_plus = XParity(Full(L=L), sector='+')
        s_minus = XParity(Full(L=L), sector='-')
        # X on the top spin folds to X on the bottom two spins
        msc = as_msc([(0b100, 0, 1.0)])
        out_p = s_plus.reduce_msc(msc)
        assert list(out_p['masks']) == [0b011]
        assert out_p['coeffs'][0] == 1.0
        out_m = s_minus.reduce_msc(msc)
        assert out_m['coeffs'][0] == -1.0
