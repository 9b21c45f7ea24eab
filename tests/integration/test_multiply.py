"""
Integration tests: the device matvec kernel against the numpy oracle, over
the model zoo x subspace matrix (modeled on the reference's
tests/integration/test_multiply.py).

These run on an 8-virtual-device CPU mesh (see tests/conftest.py), so
power-of-two Full/Parity dimensions exercise the distributed
(shard_map + ppermute) path.
"""

import numpy as np
import pytest

from dynamite_tpu import config
from dynamite_tpu.states import State
from dynamite_tpu.subspaces import (Full, Parity, SpinConserve, Explicit,
                                    Auto, XParity)
from dynamite_tpu import models

L = 6

MODELS = [
    ('ising', models.ising, True),
    ('long_range', models.long_range, False),
    ('localized', models.localized, True),
    ('syk', lambda L: models.syk(L // 2), False),  # syk uses 2L majoranas
]


@pytest.fixture(autouse=True)
def reset_config():
    config._L = None
    config._subspace = None
    yield
    config._L = None
    config._subspace = None


def subspace_cases(H_name):
    cases = [Full(L=L), Parity('even', L=L), Parity('odd', L=L)]
    if H_name == 'localized':
        cases.append(SpinConserve(L, L // 2))
        cases.append(SpinConserve(L, 2))
    return cases


def check_dot(H, sub, seed=7, rtol=1e-10):
    H = H.copy()
    H.allow_projection = True
    H.add_subspace(sub)
    s = State(state='random', seed=seed, subspace=sub)
    expected = H.to_numpy() @ s.to_numpy()
    got = H.dot(s).to_numpy()
    scale = max(np.max(np.abs(expected)), 1e-30)
    assert np.max(np.abs(got - expected)) / scale < rtol


@pytest.mark.parametrize('name,builder,real',
                         MODELS, ids=[m[0] for m in MODELS])
def test_models_subspaces(name, builder, real):
    H = builder(L)
    for sub in subspace_cases(name):
        check_dot(H, sub)


def test_explicit_shuffled():
    H = models.heisenberg(L)
    sc = SpinConserve(L, 3)
    states = sc.idx_to_state(np.arange(sc.get_dimension()))
    rng = np.random.RandomState(0)
    rng.shuffle(states)
    check_dot(H, Explicit(states, L=L))


def test_auto():
    H = models.heisenberg(L)
    check_dot(H, Auto(H, 'U' * 3 + 'D' * 3))


def test_xparity_full():
    H = models.ising(L)
    for sector in ('+', '-'):
        check_dot(H, XParity(Full(L=L), sector=sector))


def test_xparity_spinconserve():
    H = models.heisenberg(L)
    for sector in ('+', '-'):
        check_dot(H, XParity(SpinConserve(L, L // 2), sector=sector))


def test_projection_full_to_sub():
    """Multiplying from Full into a subspace projects (reference semantics:
    test_multiply.py:285-329)."""
    H = models.heisenberg(L)
    H.allow_projection = True
    sc = SpinConserve(L, L // 2)
    H.add_subspace(sc, Full(L=L))
    x = State(state='random', seed=3, subspace=Full(L=L))
    result = State(subspace=sc)
    got = H.dot(x, result=result).to_numpy()
    expected = H.to_numpy(subspaces=(sc, Full(L=L))) @ x.to_numpy()
    assert np.allclose(got, expected)


def test_sub_to_full_embedding():
    H = models.heisenberg(L)
    H.allow_projection = True
    sc = SpinConserve(L, L // 2)
    H.add_subspace(Full(L=L), sc)
    x = State(state='random', seed=3, subspace=sc)
    got = H.dot(x).to_numpy()
    expected = H.to_numpy(subspaces=(Full(L=L), sc)) @ x.to_numpy()
    assert np.allclose(got, expected)


def test_sharded_path_used():
    """On the 8-device test mesh, a power-of-two Full space state is sharded
    and the distributed path must agree with the oracle."""
    import jax
    H = models.localized(L)
    sub = Full(L=L)
    H.add_subspace(sub)
    s = State(state='random', seed=11, subspace=sub)
    kernel = H.get_mat()
    if jax.device_count() >= 2:
        assert kernel.should_shard(s.data), \
            'expected the sharded path on the multi-device test mesh'
    check_dot(H, sub)


def test_scan_path():
    """Force the scan path and compare against the oracle."""
    from dynamite_tpu.ops import apply as apply_mod
    orig_g, orig_t = (apply_mod.UNROLL_GROUP_LIMIT,
                      apply_mod.UNROLL_TERM_LIMIT)
    apply_mod.UNROLL_GROUP_LIMIT = 1
    apply_mod.UNROLL_TERM_LIMIT = 1
    try:
        H = models.localized(L)
        check_dot(H, Full(L=L))
        check_dot(H, SpinConserve(L, 2))
    finally:
        apply_mod.UNROLL_GROUP_LIMIT = orig_g
        apply_mod.UNROLL_TERM_LIMIT = orig_t


def test_chunked_path():
    """Force the row-chunked path and compare against the oracle, both for
    the XOR fast mode and the gather mode with a non-divisible dimension."""
    from dynamite_tpu.ops import apply as apply_mod
    orig = apply_mod.CHUNK_BITS
    apply_mod.CHUNK_BITS = 4
    try:
        H = models.localized(L)
        check_dot(H, Full(L=L))
        check_dot(H, Parity('odd', L=L))
        check_dot(H, SpinConserve(L, 2))   # dim 15: pad + trim
        check_dot(H, SpinConserve(L, 3))   # dim 20: pad + trim
    finally:
        apply_mod.CHUNK_BITS = orig


def test_expectation():
    H = models.ising(L)
    s = State(state='random', seed=5, subspace=Full(L=L))
    expected = np.vdot(s.to_numpy(), H.to_numpy() @ s.to_numpy()).real
    assert abs(H.expectation(s) - expected) < 1e-10


def test_sector_engine_mbl(monkeypatch):
    """The sector-blocked matmul engine must serve SpinConserve pairs and
    agree with the dense oracle (the hot path of the spinconserve bench
    stage)."""
    from dynamite_tpu.subspaces import SpinConserve

    L = 12
    H = models.localized(L)
    sub = SpinConserve(L, L // 2)   # C(12,6)=924
    H.add_subspace(sub)
    kernel = H.get_mat(subspaces=(sub, sub))
    fn = kernel.traceable(sharded=False)
    assert kernel.sector_plan is not None
    assert kernel.sector_plan.conserved is True

    rng = np.random.RandomState(5)
    dim = sub.get_dimension()
    x = rng.standard_normal((2, dim)).astype(np.float64)
    x /= np.linalg.norm(x)
    import jax
    import jax.numpy as jnp
    got = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    H_np = H.to_numpy(subspaces=(sub, sub))
    want = H_np @ (x[0] + 1j * x[1])
    err = np.max(np.abs((got[0] + 1j * got[1]) - want))
    assert err < 1e-10, err


def test_xor_dense_engine_syk(monkeypatch):
    """The XOR-blocked dense engine must serve many-mask XOR operators
    (SYK) and agree with the oracle, in Parity and Full subspaces."""
    from dynamite_tpu.subspaces import Parity, Full
    from dynamite_tpu.ops import xor_dense

    monkeypatch.setattr(xor_dense, 'MIN_DIM', 1 << 6)
    H = models.syk(7)
    for sub in (Parity('even', L=7), Parity('odd', L=7), Full(L=7)):
        H.add_subspace(sub)
        kernel = H.get_mat(subspaces=(sub, sub))
        fn = kernel.traceable(sharded=False)
        assert kernel.xor_dense_info is not None
        dim = sub.get_dimension()
        rng = np.random.RandomState(3)
        x = rng.standard_normal((2, dim))
        import jax
        got = np.asarray(jax.jit(fn)(x))
        want = H.to_numpy(subspaces=(sub, sub)) @ (x[0] + 1j * x[1])
        err = np.max(np.abs((got[0] + 1j * got[1]) - want))
        assert err < 1e-10, (sub, err)


def test_sector_engine_disabled_falls_back(monkeypatch):
    """With config.use_sector off, SpinConserve pairs take the ELL gather
    engine and still agree with the oracle."""
    from dynamite_tpu import config as cfg
    from dynamite_tpu.subspaces import SpinConserve

    monkeypatch.setattr(cfg, 'use_sector', False, raising=False)
    L = 8
    H = models.heisenberg(L)
    sub = SpinConserve(L, 3)
    H.add_subspace(sub)
    kernel = H.get_mat(subspaces=(sub, sub))
    fn = kernel.traceable(sharded=False)
    assert kernel.sector_plan is None

    rng = np.random.RandomState(5)
    dim = sub.get_dimension()
    x = rng.standard_normal((2, dim)).astype(np.float64)
    import jax
    got = np.asarray(jax.jit(fn)(x))
    want = H.to_numpy(subspaces=(sub, sub)) @ (x[0] + 1j * x[1])
    err = np.max(np.abs((got[0] + 1j * got[1]) - want))
    assert err < 1e-10, err
