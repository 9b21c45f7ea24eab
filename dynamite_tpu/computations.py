"""
High-level computations: time evolution, eigensolving, reduced density
matrices and entropies.

Reference analog: src/dynamite/computations.py (there, thin wrappers over
SLEPc MFN/EPS and the C RDM kernel; here, wrappers over the JAX Krylov
solvers in dynamite_tpu.solvers and a reshape/matmul RDM).
"""

import time
from contextlib import contextmanager

import numpy as np

from . import config
from .solvers.expmv import expmv, ConvergenceError, MaxIterationsError
from .solvers.eigs import eigsolve_trlanczos, ritz_vectors

DEFAULT_NCV_EVOLVE = 30

#: Per-phase timing and iteration counters of the most recent evolve() /
#: eigsolve() call — the analog of the reference's PETSc `-log_view`
#: diagnostics (reference: docs/FAQ.rst:104-121). Keys: phase wall times
#: (``*_s``), solver counters (substeps, matvecs, host_syncs, restarts).
last_solve_stats = {}


@contextmanager
def _maybe_profile(name):
    """Wrap a solve in a jax.profiler trace when config.profile_dir is set
    (written as a TensorBoard-loadable trace directory)."""
    profile_dir = getattr(config, 'profile_dir', None)
    if profile_dir:
        import jax
        with jax.profiler.trace(profile_dir):
            yield
    else:
        yield


@contextmanager
def _phase(stats, key):
    t0 = time.perf_counter()
    yield
    stats[key] = stats.get(key, 0.0) + time.perf_counter() - t0


def _state_sharding(dim, sharded):
    """The canonical mesh sharding for solver-internal state vectors (or
    None when running replicated)."""
    if not sharded:
        return None
    from .parallel import mesh as mesh_mod
    return mesh_mod.shard_spec(config.mesh, dim)


def _storage_dim(dim, sharded):
    """Physical vector length for solver-internal state vectors (padded on
    multi-device meshes; see parallel.mesh.storage_dim)."""
    if not sharded:
        return dim
    from .parallel import mesh as mesh_mod
    return mesh_mod.storage_dim(dim, config.mesh)


def evolve(H, state, t, result=None, tol=None, ncv=None, algo=None,
           max_its=None):
    r"""Evolve a state under the Schrodinger equation:
    :math:`\Psi_t = e^{-iHt}\Psi_0`.

    Parameters mirror the reference's evolve (computations.py:10-126);
    ``algo`` is accepted for compatibility (the Krylov/Expokit stepping
    scheme is always used). ``t`` may be complex for imaginary-time
    evolution.
    """
    state.assert_initialized()
    config._initialize()

    H.establish_L()

    if not H.has_subspace(state.subspace, state.subspace):
        raise ValueError('Hamiltonian and state are defined on different '
                         'subspaces.')

    from .states import State
    if result is None:
        result = State(L=H.L, subspace=state.subspace)
    elif state.subspace != result.subspace:
        raise ValueError('input and result states are on different '
                         'subspaces.')

    if t == 0.0:
        state.copy(result)
        return result

    if ncv is None:
        ncv = DEFAULT_NCV_EVOLVE
    if tol is None:
        tol = 1e-7

    stats = {}
    with _phase(stats, 'build_s'):
        kernel = H.get_mat(subspaces=(state.subspace, state.subspace))
    sharded = kernel.should_shard(state.data)
    from .solvers.krylov import check_workspace_fits
    from .parallel.mesh import n_devices
    check_workspace_fits(len(state), min(ncv, len(state)),
                         n_devices() if sharded else 1, 'evolve')
    kops = kernel.krylov_ops(min(ncv, len(state)), sharded=sharded)

    # the matrix infinity norm (computed on device, cached on the operator)
    # for the Expokit stepping heuristic — a much tighter bound than
    # sum_t |c_t|, which overestimates ||H|| by up to the term count and
    # shrinks the initial substeps accordingly
    with _phase(stats, 'norm_s'):
        anorm = H.infinity_norm(subspaces=(state.subspace, state.subspace))

    scale = -1j * t

    with _maybe_profile('evolve'), _phase(stats, 'solve_s'):
        result.data = expmv(kops, state.data, scale, anorm, ncv=ncv,
                            tol=tol, max_its=max_its, stats=stats)
    result.set_initialized()
    global last_solve_stats
    last_solve_stats = stats
    return result


def eigsolve(H, getvecs=False, nev=1, which='lowest', target=None, tol=None,
             subspace=None, max_its=None, ncv=None, target_method=None,
             inner_its=None, inner_tol=None):
    r"""Solve for a subset of the Hamiltonian's eigenpairs.

    Parameters mirror the reference (computations.py:128-292). ``which`` is
    one of 'lowest', 'highest', 'exterior', or 'target' (with ``target``
    set).

    For interior eigenvalues (``target=``), ``target_method`` selects the
    matrix-free shift-invert strategy: 'shift_invert' (default — Lanczos on
    (H-target)^{-1} applied by an inner MINRES solve; converges in O(10)
    outer iterations like the reference's MUMPS-based ST.SINVERT) or 'fold'
    (Lanczos on (H-target)^2 — no inner solve but squares the condition
    number). ``inner_its``/``inner_tol`` bound the MINRES inner solve.
    """
    H.establish_L()

    if subspace is None:
        subspace = H.subspace
    elif not H.has_subspace(subspace):
        raise ValueError('Requested subspace has not been added to operator.')

    config._initialize()

    if which in ('smallest', 'largest'):
        import warnings
        warnings.warn('values "smallest" and "largest" for eigsolve '
                      'parameter "which" are deprecated, and have been '
                      'replaced by "lowest" and "highest" respectively.',
                      DeprecationWarning, stacklevel=2)
        which = {'smallest': 'lowest', 'largest': 'highest'}[which]

    if target is not None:
        which = 'target'
    elif which == 'target':
        raise ValueError("which='target' requires the target "
                         'parameter')

    kernel = H.get_mat(subspaces=(subspace, subspace))
    dim = subspace.get_dimension()

    if which == 'target':
        return _eigsolve_target(H, kernel, dim, nev, target, tol, getvecs,
                                max_its, ncv, subspace,
                                method=target_method, inner_its=inner_its,
                                inner_tol=inner_tol)

    if ncv is None:
        ncv = min(dim - 1 if dim > 2 else dim, max(2 * nev + 10, 20))
    ncv = min(ncv, dim)

    dtype = config.real_dtype
    sharded = kernel.sharded_default()
    from .solvers.krylov import check_workspace_fits
    from .parallel.mesh import n_devices
    check_workspace_fits(dim, ncv, n_devices() if sharded else 1, 'eigsolve')
    kops = kernel.krylov_ops(ncv, sharded=sharded)

    stats = {}
    with _maybe_profile('eigsolve'), _phase(stats, 'solve_s'):
        evals, S, V = eigsolve_trlanczos(
            kops, dim, dtype, nev=nev, which=which, tol=tol,
            max_restarts=max_its, sharding=_state_sharding(dim, sharded),
            storage_dim=_storage_dim(dim, sharded), stats=stats)
    global last_solve_stats
    last_solve_stats = stats

    if not getvecs:
        return np.asarray(evals, dtype=float)

    from .states import State
    evecs = []
    for i, vec in enumerate(ritz_vectors(S, V, dtype)):
        v = State(L=H.L, subspace=subspace)
        v.data = vec
        v.set_initialized()
        evecs.append(v)
    return np.asarray(evals, dtype=float), evecs


def _eigsolve_target(H, kernel, dim, nev, target, tol, getvecs, max_its,
                     ncv, subspace, method=None, inner_its=None,
                     inner_tol=None):
    """Interior eigenvalues near ``target``.

    The reference does this with SLEPc shift-invert + a MUMPS direct solve,
    which it refuses for matrix-free (shell) operators
    (computations.py:211-220). Here every operator is matrix-free, so the
    inverse is applied iteratively (method='shift_invert': outer Lanczos on
    (H-target)^{-1}, each apply an inner MINRES solve fused into the same
    device program), or avoided entirely (method='fold': Lanczos on
    (H-target)^2, whose lowest eigenvalues are the ones closest to the
    target — robust but squares the condition number, so it needs far more
    iterations on dense mid-spectrum problems).

    Both methods produce a candidate subspace; the eigenpairs are extracted
    by a Rayleigh-Ritz step on H itself, so the returned eigenvalues are
    accurate even when the inner solves are loose.
    """
    if method is None:
        method = 'shift_invert'

    nev_f = min(dim, nev + 4)
    if ncv is None:
        if method == 'fold':
            ncv = min(dim - 1 if dim > 2 else dim, max(2 * nev_f + 25, 40))
        else:
            ncv = min(dim - 1 if dim > 2 else dim, max(2 * nev_f + 10, 20))
    ncv = min(ncv, dim)
    dtype = config.real_dtype

    if method == 'shift_invert':
        states = _target_candidates_shift_invert(
            H, kernel, dim, nev_f, target, tol, max_its, ncv, subspace,
            dtype, inner_its, inner_tol)
    elif method == 'fold':
        states = _target_candidates_fold(
            H, dim, nev_f, target, tol, max_its, ncv, subspace, dtype)
    else:
        raise ValueError("target_method must be 'shift_invert' or 'fold' "
                         f"(got {method!r})")

    return _rayleigh_ritz_extract(H, states, target, nev, getvecs)


def _target_candidates_shift_invert(H, kernel, dim, nev_f, target, tol,
                                    max_its, ncv, subspace, dtype,
                                    inner_its, inner_tol):
    """Candidate subspace from Lanczos on (H - target)^{-1}: the largest-
    magnitude eigenvalues of the inverse are the ones closest to the
    target, so O(10) outer iterations suffice (the behavior of the
    reference's direct-solve shift-invert), at the price of an inner
    MINRES solve per outer matvec."""
    from .solvers.minres import minres_solver
    from .solvers.krylov import KrylovOps

    if inner_its is None:
        # the iteration count MINRES needs scales with ||H|| / (distance of
        # target to the spectrum edge of the gap); a low cap silently
        # returns an inexact inverse and the outer Lanczos then converges
        # to the wrong interior eigenvalues. MINRES exits early on its
        # residual test, so a generous cap only costs on hard targets.
        inner_its = min(2 * dim, 2000)
    if inner_tol is None:
        inner_tol = 1e-10 if np.dtype(dtype) == np.float64 else 1e-5
    # the outer residual tolerance lives on the (H-target)^{-1} eigenvalue
    # scale; the final accuracy comes from the Rayleigh-Ritz step on H
    outer_tol = tol if tol is not None else \
        (1e-8 if np.dtype(dtype) == np.float64 else 1e-5)

    sharded = kernel.sharded_default()
    inverse_apply = minres_solver(kernel.traceable(sharded),
                                  shift=float(target),
                                  maxiter=inner_its, rtol=inner_tol)
    kops = KrylovOps(inverse_apply, ncv)

    _theta, S, V = eigsolve_trlanczos(
        kops, dim, dtype, nev=nev_f, which='exterior', tol=outer_tol,
        max_restarts=max_its, sharding=_state_sharding(dim, sharded),
        storage_dim=_storage_dim(dim, sharded))
    return _ritz_states(H, subspace, S, V, dtype)


def _target_candidates_fold(H, dim, nev_f, target, tol, max_its, ncv,
                            subspace, dtype):
    """Candidate subspace from Lanczos on the folded operator
    (H - target)^2, built symbolically with the MSC algebra."""
    from .ops import msc as msc_tools
    from .operators import Operator

    H.reduce_msc()
    shifted = msc_tools.msc_sum(
        [H.msc, msc_tools.msc_from_arrays([0], [0], [-target])])
    folded_msc = msc_tools.combine_terms(
        msc_tools.msc_product([shifted, shifted]))
    # squaring produces exact symbolic cancellations that survive as ~1e-17
    # float residue; drop them so the conservation check still sees the
    # symmetry of H
    if len(folded_msc):
        folded_msc = msc_tools.truncate(
            folded_msc, 1e-12 * float(np.abs(folded_msc['coeffs']).max()))
    folded = Operator(msc=folded_msc)
    folded._subspaces = [(l, r) for (l, r) in H.get_subspace_list()]
    folded.allow_projection = H.allow_projection

    fkernel = folded.get_mat(subspaces=(subspace, subspace))
    sharded = fkernel.sharded_default()
    kops = fkernel.krylov_ops(ncv, sharded=sharded)

    # folding squares the condition number, so tight residuals on
    # (H-target)^2 are unreachable; a loose outer tolerance is enough
    # because the Rayleigh-Ritz step on H itself recovers the accuracy
    fold_tol = tol if tol is not None else \
        (1e-6 if np.dtype(dtype) == np.float64 else 1e-4)

    scale = float(np.sum(np.abs(folded_msc['coeffs']))) \
        if len(folded_msc) else 1.0

    _evals_sq, S, V = eigsolve_trlanczos(
        kops, dim, dtype, nev=nev_f, which='lowest', tol=fold_tol,
        max_restarts=max_its, sharding=_state_sharding(dim, sharded),
        storage_dim=_storage_dim(dim, sharded), tol_scale=scale)
    return _ritz_states(H, subspace, S, V, dtype)


def _ritz_states(H, subspace, S, V, dtype):
    from .states import State
    states = []
    for vec in ritz_vectors(S, V, dtype):
        v = State(L=H.L, subspace=subspace)
        v.data = vec
        v.set_initialized()
        states.append(v)
    return states


def _rayleigh_ritz_extract(H, states, target, nev, getvecs):
    """Rayleigh-Ritz of H within span{v_i, H v_i} of the candidate states;
    returns the nev eigenvalues closest to the target (+ vectors if
    requested).

    The basis is enriched with H v_i because the shift-invert/folded
    operators have *degenerate* wanted eigenvalues whenever the target sits
    mid-gap (the pair equidistant from it folds onto one eigenvalue), and a
    single Lanczos sequence returns only one mixed vector per degenerate
    level; H separates the mixture, so the enriched span contains both
    true eigenvectors.

    The projected matrices are computed as stacked-basis matmuls in one
    jitted program — a single device round-trip for the whole candidate
    set, not O(n^2) synchronized dots. Rank-deficiency of the enriched
    basis is handled by a canonical-orthogonalization truncation.
    """
    import jax
    import jax.numpy as jnp

    hstates = [H.dot(v) for v in states]
    h2states = [H.dot(w) for w in hstates]

    @jax.jit
    def _grams(vs, ws):
        # complex Gram matrices over stacked-real bases: lists of (2, dim).
        # The stack happens inside the traced program (an eager jnp.stack
        # here intermittently aborted the XLA CPU client in full-suite
        # runs), and the contraction runs over the LAST axis of both
        # operands — the layout-safe form (see solvers/krylov._basis_dots).
        V = jnp.stack(vs)
        W = jnp.stack(ws)

        def gram(X, Y):
            from jax import lax
            G = jnp.einsum('kpd,lqd->kplq', X, Y,
                           precision=lax.Precision.HIGHEST)
            return (G[:, 0, :, 0] + G[:, 1, :, 1],
                    G[:, 0, :, 1] - G[:, 1, :, 0])
        return gram(V, W), gram(V, V)

    basis = states + hstates
    hbasis = hstates + h2states
    n = len(basis)
    (Are, Aim), (Bre, Bim) = jax.device_get(
        _grams([v.data for v in basis], [h.data for h in hbasis]))
    A = np.asarray(Are, dtype=np.float64) + 1j * np.asarray(Aim, np.float64)
    B = np.asarray(Bre, dtype=np.float64) + 1j * np.asarray(Bim, np.float64)

    # canonical orthogonalization: drop the near-null directions of the
    # (generally rank-deficient) enriched basis, then a standard Hermitian
    # eigenproblem in the reduced space
    s, U = np.linalg.eigh((B + B.conj().T) / 2)
    keep = s > max(1e-10 * s.max(), 0)
    T = U[:, keep] / np.sqrt(s[keep])
    A_r = T.conj().T @ ((A + A.conj().T) / 2) @ T
    theta, C_r = np.linalg.eigh((A_r + A_r.conj().T) / 2)
    C = T @ C_r

    order = np.argsort(np.abs(theta - target))[:nev]
    evals = np.asarray(theta[order], dtype=float)

    if not getvecs:
        return evals

    evecs = []
    for idx in order:
        out = basis[0].copy()
        out.scale(complex(C[0, idx]))
        for i in range(1, n):
            out.axpy(complex(C[i, idx]), basis[i])
        out.normalize()
        evecs.append(out)
    return evals, evecs


def reduced_density_matrix(state, keep):
    """Trace out all spins except those in ``keep`` (a strictly increasing
    list of spin indices); returns the 2**len(keep) density matrix as a
    host numpy array.

    The state, viewed as a [2]*L tensor, is transposed so the kept spins
    lead, reshaped to (2^k, 2^(L-k)), and contracted rho = V V^dagger — one
    matmul instead of the reference's
    gather-to-rank-0 outer-product loop (bpetsc_template_1.c:87-165, a
    known scalability bottleneck acknowledged in docs/FAQ.rst:35).
    """
    state.assert_initialized()
    config._initialize()

    if not state.subspace.product_state_basis:
        raise ValueError('reduced density matrices currently only supported '
                         'for product state basis subspace types.')

    keep = np.asarray(keep, dtype=np.int64).reshape(-1)
    if keep.size == 0:
        return np.array([[1]], dtype=np.complex128)
    if np.any(keep[1:] <= keep[:-1]):
        raise ValueError('keep array must be strictly increasing')
    if np.any(keep < 0):
        raise ValueError(f'spin index less than zero. keep: {keep}')
    L = state.L
    if np.any(keep >= L):
        raise ValueError('spin index greater than spin chain length minus '
                         f'one. keep: {keep}')

    from .ops.rdm import rdm_device
    return rdm_device(state, keep)


def entanglement_entropy(state, keep):
    """Bipartite Von Neumann entanglement entropy across the cut defined by
    ``keep``."""
    reduced = reduced_density_matrix(state, keep)
    return dm_entanglement_entropy(reduced)


def dm_entanglement_entropy(dm):
    """Von Neumann entropy of a density matrix."""
    w = np.linalg.eigvalsh(dm)
    log = np.zeros(w.shape)
    np.log(w, where=w > 0, out=log)
    return -np.sum(w * log)


def renyi_entropy(state, keep, alpha, method='eigsolve'):
    """Renyi entropy of the reduced density matrix on ``keep``."""
    reduced = reduced_density_matrix(state, keep)
    return dm_renyi_entropy(reduced, alpha, method)


def dm_renyi_entropy(dm, alpha, method='eigsolve'):
    """Renyi entropy H_alpha = log(Tr rho^alpha) / (1 - alpha), with the
    alpha in {0, 1, 'inf'} limits handled."""
    if alpha == 0:
        eps = 1e-10
        eigs = np.linalg.eigvalsh(dm)
        return np.log(np.sum(eigs > eps))
    if alpha == 1:
        return dm_entanglement_entropy(dm)
    if alpha == 'inf':
        eigs = np.linalg.eigvalsh(dm)
        return -np.log(np.max(eigs))

    if method == 'matrix_power':
        if alpha != int(alpha):
            raise TypeError('alpha must be an integer for matrix_power '
                            'method.')
        trace = np.trace(np.linalg.matrix_power(dm, int(alpha))).real
    elif method == 'eigsolve':
        w = np.linalg.eigvalsh(dm)
        trace = np.sum(w ** alpha)
    else:
        raise ValueError('Valid methods are "eigsolve" and "matrix_power"')

    return 1 / (1 - alpha) * np.log(trace)


def get_tstep(ncv, nrm, tol=1e-7):
    """Length of an Expokit substep (reference: computations.py:511-519)."""
    from .solvers.expmv import initial_tstep
    return initial_tstep(ncv, nrm, tol)


def estimate_compute_time(t, ncv, nrm, tol=1e-7):
    """Estimated cost of an expmv solve in units of matvecs."""
    tstep = get_tstep(ncv, nrm, tol)
    return ncv * np.ceil(t / tstep)
