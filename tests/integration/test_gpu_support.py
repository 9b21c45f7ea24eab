"""
What the GPU path relies on, checked on the CPU: the host reference apply
that chip_smoke.py compares the card against, GPU platform selection, the
compile-cache location, the engines' matmul precision, and the names of the
engines that serve each subspace pair.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
from jax import lax

from dynamite_tpu import config
from dynamite_tpu import models
from dynamite_tpu.subspaces import Full, Parity, SpinConserve
from dynamite_tpu.utils.compile_cache import REPO_ROOT, cache_dir

from chip_smoke import host_apply, host_rdm_low
from tests.integration.test_precision import run_snippet


@pytest.fixture(autouse=True)
def reset_config():
    config._L = None
    config._subspace = None
    yield
    config._L = None
    config._subspace = None


HOST_CASES = {
    'full_localized': lambda: (models.localized(8), Full(L=8)),
    'parity_heisenberg': lambda: (models.heisenberg(9), Parity('even', L=9)),
    'parity_odd_ising': lambda: (models.ising(8), Parity('odd', L=8)),
    'parity_syk': lambda: (models.syk(5), Parity('even', L=5)),
    'spinconserve_localized': lambda: (models.localized(8),
                                       SpinConserve(8, 3)),
}


@pytest.mark.parametrize('case', sorted(HOST_CASES))
def test_host_apply_matches_to_numpy(case):
    H, sub = HOST_CASES[case]()
    H.add_subspace(sub)
    dim = sub.get_dimension()
    rng = np.random.default_rng(7)
    x = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
    want = H.to_numpy(subspaces=(sub, sub)) @ x
    got = host_apply(H.msc, sub, sub, x)
    assert np.max(np.abs(got - want)) < 1e-12 * max(np.abs(want).max(), 1)


@pytest.mark.parametrize('sub', ['full', 'spinconserve'])
def test_host_rdm_matches_reduced_density_matrix(sub):
    """The host RDM chip_smoke.py checks the device one against."""
    from dynamite_tpu.computations import reduced_density_matrix
    from dynamite_tpu.states import State
    space = Full(L=8) if sub == 'full' else SpinConserve(8, 4)
    psi = State(L=8, subspace=space, state='random', seed=3)
    want = host_rdm_low(psi.to_numpy(), space, 4)
    got = reduced_density_matrix(psi, range(4))
    assert np.max(np.abs(got - want)) < 1e-12


def test_initialize_gpu_raises_without_gpu():
    out = run_snippet("""
        from dynamite_tpu import config
        try:
            config.initialize(gpu=True)
        except RuntimeError as e:
            print('raised', 'no' in str(e))
        else:
            print('initialized on', jax.devices())
    """)
    assert 'raised True' in out, out


def test_initialize_gpu_conflicting_platform():
    out = run_snippet("""
        from dynamite_tpu import config
        try:
            config.initialize(gpu=True, platform='cpu')
        except ValueError:
            print('refused')
        print('gpu backend:', config.gpu)
    """)
    assert 'refused' in out and 'gpu backend: False' in out, out


@pytest.mark.parametrize('env_dir', [None, 'from_env'])
def test_compile_cache_dir(env_dir, tmp_path):
    """A set JAX_COMPILATION_CACHE_DIR is the only cache directory;
    otherwise the cache is the checkout's .jax_cache."""
    want = (os.path.join(REPO_ROOT, '.jax_cache') if env_dir is None
            else str(tmp_path / env_dir))
    environ = {} if env_dir is None else {'JAX_COMPILATION_CACHE_DIR': want}
    assert cache_dir(environ) == want

    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    env.update(environ, JAX_PLATFORMS='cpu')
    prog = (f'import sys; sys.path.insert(0, {REPO_ROOT!r})\n'
            'from dynamite_tpu.utils.compile_cache import '
            'enable_compile_cache\n'
            'path = enable_compile_cache()\n'
            'import jax\n'
            'print(path, jax.config.jax_compilation_cache_dir)\n')
    proc = subprocess.run([sys.executable, '-c', prog], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [want, want], proc.stdout


def _dot_precisions(jaxpr):
    """The precision of every dot_general in a (closed) jaxpr, recursively."""
    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive is lax.dot_general_p:
                found.append(eqn.params['precision'])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    return found


HIGHEST = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)


def _sector_kernel():
    H = models.heisenberg(10)
    sub = SpinConserve(10, 5)
    H.add_subspace(sub)
    return H.get_mat(subspaces=(sub, sub)), sub.get_dimension()


def test_sector_engine_matmuls_run_at_highest():
    kernel, dim = _sector_kernel()
    fn = kernel.traceable(sharded=False)
    assert kernel.engine == 'sector'
    precs = _dot_precisions(jax.make_jaxpr(fn)(
        jax.ShapeDtypeStruct((2, dim), config.real_dtype)))
    assert precs and all(p == HIGHEST for p in precs), precs


def test_sector_ring_matmuls_run_at_highest():
    from dynamite_tpu.parallel.mesh import storage_dim
    kernel, dim = _sector_kernel()
    fn = kernel.traceable(sharded=True)
    assert kernel.sharded_engine == 'sector_ring'
    sdim = storage_dim(dim, kernel.mesh)
    precs = _dot_precisions(jax.make_jaxpr(fn)(
        jax.ShapeDtypeStruct((2, sdim), config.real_dtype)))
    assert precs and all(p == HIGHEST for p in precs), precs


def _syk_plan():
    from dynamite_tpu.ops.apply import _Plan
    H = models.syk(7)   # over UNROLL_TERM_LIMIT terms: the scan regime
    sub = Parity('even', L=7)
    H.add_subspace(sub)
    return H, sub, _Plan(H.msc, sub, sub)


def _spec(*shape, dtype=None):
    return jax.ShapeDtypeStruct(shape, dtype or config.real_dtype)


def test_xor_dense_matmuls_run_at_highest(monkeypatch):
    from dynamite_tpu.ops import xor_dense
    monkeypatch.setattr(xor_dense, 'MIN_DIM', 1)
    _H, sub, plan = _syk_plan()
    fn, info = xor_dense.build_xor_dense(plan, sub, sub)
    assert fn is not None and info['channels'] > 0
    precs = _dot_precisions(jax.make_jaxpr(fn)(_spec(2, sub.get_dimension())))
    assert precs and all(p == HIGHEST for p in precs), precs


def test_sector_precision_override(monkeypatch):
    from dynamite_tpu.ops.sector_apply import matmul_precision
    assert matmul_precision() == lax.Precision.HIGHEST
    monkeypatch.setattr(config, 'sector_precision', 'default',
                        raising=False)
    assert matmul_precision() == lax.Precision.DEFAULT


def test_krylov_dots_run_at_highest():
    from dynamite_tpu.solvers import krylov
    V = jax.ShapeDtypeStruct((4, 2, 64), config.real_dtype)
    w = jax.ShapeDtypeStruct((2, 64), config.real_dtype)
    mask = jax.ShapeDtypeStruct((4,), config.real_dtype)
    precs = _dot_precisions(jax.make_jaxpr(krylov._basis_dots)(V, w, mask))
    precs += _dot_precisions(jax.make_jaxpr(krylov._basis_combine)(
        V, mask, mask))
    assert precs and all(p == HIGHEST for p in precs), precs


def test_ell_table_build_runs_at_highest():
    from dynamite_tpu.ops import ell
    _H, sub, plan = _syk_plan()
    dim = sub.get_dimension()
    precs = _dot_precisions(jax.make_jaxpr(
        lambda: ell.build_tables(plan, dim, config.real_dtype))())
    assert precs and all(p == HIGHEST for p in precs), precs


@pytest.mark.parametrize('has_fi', [False, True])
def test_ell_apply_runs_at_highest(has_fi):
    from dynamite_tpu.ops import ell
    rows, S, KB = 64, 3, 4
    args = [_spec(2, rows), _spec(S, KB, rows, dtype=np.int32),
            _spec(S, KB, rows)] + ([_spec(S, KB, rows)] if has_fi else [])
    precs = _dot_precisions(jax.make_jaxpr(
        ell.make_apply(rows, has_fi))(*args))
    assert precs and all(p == HIGHEST for p in precs), precs


def test_scan_sweep_runs_at_highest():
    H, sub, _plan = _syk_plan()
    name, sweep = H.get_mat(subspaces=(sub, sub)).sweep_callable()
    assert name == 'sweep_scan'
    precs = _dot_precisions(jax.make_jaxpr(sweep)(
        _spec(2, sub.get_dimension())))
    assert precs and all(p == HIGHEST for p in precs), precs


def test_infinity_norm_runs_at_highest():
    from dynamite_tpu.ops import reductions
    H, sub, _plan = _syk_plan()
    fn = reductions.build_infinity_norm(H.msc, sub, sub, config.real_dtype,
                                        np.int32)
    precs = _dot_precisions(jax.make_jaxpr(fn.__wrapped__)())
    assert precs and all(p == HIGHEST for p in precs), precs


@pytest.mark.parametrize('subspace', ['full', 'spinconserve'])
def test_rdm_matmuls_run_at_highest(subspace):
    from dynamite_tpu.ops import rdm
    if subspace == 'full':
        sub = Full(L=8)
        fn = rdm._build_rdm_device(sub, (0, 1, 2), np.int32)
    else:
        sub = SpinConserve(8, 4)
        fn, _gs = rdm._build_rdm_spinconserve(sub, (0, 1, 2), np.int32)
    precs = _dot_precisions(jax.make_jaxpr(fn.__wrapped__)(
        _spec(2, sub.get_dimension())))
    assert precs and all(p == HIGHEST for p in precs), precs


ENGINE_CASES = {
    'full': (lambda: (models.localized(8), Full(L=8)), 'sweep'),
    'spinconserve': (lambda: (models.heisenberg(8), SpinConserve(8, 4)),
                     'sector'),
    'syk': (lambda: (models.syk(7), Parity('even', L=7)), 'ell'),
}


@pytest.mark.parametrize('case', sorted(ENGINE_CASES))
def test_engine_names(case):
    make, want = ENGINE_CASES[case]
    H, sub = make()
    H.add_subspace(sub)
    kernel = H.get_mat(subspaces=(sub, sub))
    assert kernel.engine is None
    kernel.traceable(sharded=False)
    assert kernel.engine == want


def test_xor_dense_split_minimizes_streamed_bytes():
    """La is the split whose tables plus gathered rows stream the fewest
    bytes, within the table budget; no device rate enters the choice."""
    from dynamite_tpu.ops import xor_dense
    from dynamite_tpu.ops.apply import _Plan
    from dynamite_tpu.ops.index_maps import effective_sign_mask
    H = models.syk(7)
    sub = Parity('even', L=7)
    H.add_subspace(sub)
    plan = _Plan(H.msc, sub, sub)
    eff = [[effective_sign_mask(int(s), int(m), sub, sub) for s in signs]
           for m, _pm, signs, _c in plan.groups]
    nbits = sub.get_dimension().bit_length() - 1
    streamed, La, _C, table = xor_dense.pick_split(plan.groups, eff, nbits,
                                                   1 << 40, 4)
    for la in xor_dense.split_range(nbits):
        c = len(xor_dense._typed_channels_at(plan.groups, eff, la))
        na, nh = 1 << la, 1 << (nbits - la)
        assert streamed <= c * na * na * 4 + c * 2 * nh * na * 4
    tight = xor_dense.pick_split(plan.groups, eff, nbits, table - 1, 4)
    assert tight is None or tight[3] < table
