"""
Lanczos factorization — the shared core of both the eigensolver and the
Krylov exponential.

Builds V_{m+1}, alpha_{1..m}, beta_{1..m} with

    A V_m = V_m T_m + beta_m v_{m+1} e_m^T

for a Hermitian matrix-free ``matvec``, with full (two-pass classical
Gram-Schmidt) reorthogonalization — the numerical strategy needed to match
SLEPc's Krylov accuracy (reference north star: eigenvalues to 1e-10).

Everything runs as one traced program: the Krylov basis V lives on device as
a (m+1, 2, dim) stacked-real array (sharded over dim under GSPMD), inner
products are matmuls against the basis, and the iteration is
a lax.fori_loop — no host round-trips inside the factorization.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def workspace_bytes(dim, ncv, real_bytes=None):
    """Mesh-wide bytes the Lanczos iteration keeps resident: the
    (ncv+1, 2, dim) basis plus two work vectors."""
    if real_bytes is None:
        from .. import config
        import numpy as np
        real_bytes = np.dtype(config.real_dtype).itemsize
    return (ncv + 3) * 2 * dim * real_bytes


def check_workspace_fits(dim, ncv, n_devices, context):
    """Warn when the Krylov basis will not fit in device memory, with the
    ncv-vs-memory tradeoff spelled out (the basis is sharded, so the check
    is per device)."""
    import jax
    try:
        stats = jax.devices()[0].memory_stats()
        limit = stats.get('bytes_limit')
    except Exception:
        limit = None
    if not limit:
        return
    per_device = workspace_bytes(dim, ncv) / max(n_devices, 1)
    if per_device > 0.9 * limit:
        import warnings
        warnings.warn(
            f'{context}: the ncv={ncv} Krylov basis needs '
            f'{per_device / 1e9:.1f} GB per device but only '
            f'{limit / 1e9:.1f} GB is available — reduce ncv (more, '
            f'shorter restarts) or spread the state over more devices',
            RuntimeWarning, stacklevel=3)


def _basis_dots(V, w, upto_mask):
    """Complex inner products <V_k | w> for all k, masked beyond the active
    basis size. V: (m, 2, dim); w: (2, dim). Returns (re, im) of shape (m,).

    Both operands contract on their LAST axis, as one (2m, dim) x (2, dim)
    product: no (dim, 1)-shaped operand or reshaped copy of the basis is
    formed."""
    m = V.shape[0]
    Vv = V.reshape(m * 2, V.shape[-1])
    # HIGHEST: below it a GPU may take f32 products in TF32 (~1e-3
    # relative), and orthogonalization against such a projection visibly
    # drifts the evolved state's norm
    D = lax.dot_general(Vv, w, (((1,), (1,)), ((), ())),
                        precision=lax.Precision.HIGHEST)
    D = D.reshape(m, 2, 2)
    re = D[:, 0, 0] + D[:, 1, 1]
    im = D[:, 0, 1] - D[:, 1, 0]
    return re * upto_mask, im * upto_mask


def _basis_combine(V, cr, ci):
    """sum_k (cr_k + i ci_k) V_k. Returns (2, dim).

    The (2, 2, m) coefficient tensor contracts over (q, k) while the basis
    keeps its native (m, 2, dim) layout — no in-program reshape of V, which
    could materialize a copy of the whole basis."""
    C = jnp.stack([jnp.stack([cr, -ci]), jnp.stack([ci, cr])])
    return jnp.einsum('pqk,kqd->pd', C, V,
                      precision=lax.Precision.HIGHEST)


def _orthogonalize(V, w, upto_mask):
    """One pass of classical Gram-Schmidt of w against the masked basis.
    Returns (w_orth, (re, im) coefficients)."""
    re, im = _basis_dots(V, w, upto_mask)
    w = w - _basis_combine(V, re, im)
    return w, (re, im)


def _norm(w):
    return jnp.sqrt(jnp.sum(w * w))


def lanczos(matvec, v0, m, v_prev_basis=None):
    """Run m Lanczos steps from the normalized start vector v0.

    Parameters
    ----------
    matvec : callable
        (2, dim) -> (2, dim), the Hermitian operator apply (traceable).
    v0 : (2, dim) array
        Starting vector, assumed normalized.
    m : int (static)
        Number of steps.

    Returns
    -------
    V : (m+1, 2, dim)  — orthonormal Krylov basis
    alpha : (m,)       — tridiagonal diagonal
    beta : (m,)        — tridiagonal off-diagonal; beta[m-1] is the residual
                         norm (A V relation above)
    """
    dim = v0.shape[-1]
    dtype = v0.dtype

    V0 = jnp.zeros((m + 1, 2, dim), dtype).at[0].set(v0)
    alpha0 = jnp.zeros(m, dtype)
    beta0 = jnp.zeros(m, dtype)

    ks = lax.broadcasted_iota(jnp.int32, (m + 1,), 0)

    def step(j, carry):
        V, alpha, beta = carry
        vj = V[j]
        w = matvec(vj)

        # two-pass CGS against the full active basis {v_0..v_j}: the first
        # pass extracts alpha_j (the <v_j|w> component is real for a
        # Hermitian matvec), the second cleans up roundoff
        mask = (ks <= j).astype(dtype)
        w, (re1, _) = _orthogonalize(V, w, mask)
        w, _ = _orthogonalize(V, w, mask)

        a_j = re1[j]
        b_j = _norm(w)
        v_next = w / jnp.where(b_j > 0, b_j, 1)

        V = V.at[j + 1].set(v_next)
        alpha = alpha.at[j].set(a_j)
        beta = beta.at[j].set(b_j)
        return V, alpha, beta

    V, alpha, beta = lax.fori_loop(0, m, step, (V0, alpha0, beta0))
    return V, alpha, beta


def lanczos_restarted(matvec, V_init, n_locked, m):
    """Continue a Lanczos factorization after a thick restart.

    V_init: (m+1, 2, dim) whose rows 0..n_locked hold the retained Ritz
    vectors plus the residual direction at row n_locked. Runs steps
    n_locked..m-1, orthogonalizing against everything retained.

    Returns the same (V, alpha, beta) triple as :func:`lanczos`, with
    alpha/beta only valid in [n_locked, m).
    """
    dim = V_init.shape[-1]
    dtype = V_init.dtype
    alpha0 = jnp.zeros(m, dtype)
    beta0 = jnp.zeros(m, dtype)
    ks = lax.broadcasted_iota(jnp.int32, (m + 1,), 0)

    def step(j, carry):
        V, alpha, beta = carry
        vj = V[j]
        w = matvec(vj)
        mask = (ks <= j).astype(dtype)
        w, (re1, _) = _orthogonalize(V, w, mask)
        w, _ = _orthogonalize(V, w, mask)
        a_j = re1[j]
        b_j = _norm(w)
        v_next = w / jnp.where(b_j > 0, b_j, 1)
        V = V.at[j + 1].set(v_next)
        alpha = alpha.at[j].set(a_j)
        beta = beta.at[j].set(b_j)
        return V, alpha, beta

    return lax.fori_loop(n_locked, m, step, (V_init, alpha0, beta0))


# module-level jitted helpers (shape-polymorphic via the jit cache)

combine = jax.jit(_basis_combine)
norm = jax.jit(_norm)


@jax.jit
def recombine_basis(V, C):
    """New basis rows Y_p = sum_k C[p, k] V[k] (real coefficients, e.g. the
    eigenvectors of the tridiagonal projection in a thick restart).

    Contracts k against the basis's native (m, 2, dim) layout, so no
    flattened copy of the basis is formed."""
    return jnp.einsum('pk,kqd->pqd', C, V,
                      precision=lax.Precision.HIGHEST)


@jax.jit
def orthonormalize_against(V, w, mask):
    """Two-pass Gram-Schmidt of w against the masked basis rows, then
    normalize — used to inject a fresh random direction into a restart
    (degenerate-spectrum verification, solvers/eigs.py)."""
    w, _ = _orthogonalize(V, w, mask)
    w, _ = _orthogonalize(V, w, mask)
    n = _norm(w)
    return w / jnp.where(n > 0, n, 1)


def lanczos_step(matvec, w, m):
    """One fused expmv substep worth of device work: normalize w, run the
    m-step Lanczos factorization, and compute ||A v_m|| for the Expokit
    second-order error term — everything the host needs in ONE round trip
    (the split version cost three device syncs per substep)."""
    beta0 = _norm(w)
    v0 = w / jnp.where(beta0 > 0, beta0, 1)
    V, alpha, beta = lanczos(matvec, v0, m)
    avnorm = _norm(matvec(V[m]))
    return V, alpha, beta, beta0, avnorm


class KrylovOps:
    """Compiled Krylov building blocks bound to one matvec and one subspace
    dimension m. Cached on the OperatorKernel so repeated solves reuse the
    same executables."""

    def __init__(self, matvec, m):
        from ..utils.hoist import hjit
        self.m = m
        self.matvec = matvec
        # hjit, not jit: the matvec may capture large device tables (ELL
        # engine, Explicit subspace maps) that must become runtime
        # arguments rather than inlined MLIR constants
        self.lanczos = hjit(lambda v: lanczos(matvec, v, m))
        self.lanczos_restarted = hjit(
            lambda V, p: lanczos_restarted(matvec, V, p, m))
        self.matvec_norm = hjit(lambda v: _norm(matvec(v)))
        self.lanczos_step = hjit(lambda w: lanczos_step(matvec, w, m))
