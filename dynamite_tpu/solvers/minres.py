"""
MINRES for shifted Hermitian systems (A - sigma) x = b — the inner solve of
the shift-invert ``target=`` eigensolver.

The reference implements shift-invert with a MUMPS sparse LU through SLEPc's
ST.SINVERT (reference: computations.py:211-224) and *refuses* it for
matrix-free operators. Everything here is matrix-free, so the inverse is
applied iteratively: MINRES needs only matvecs, handles the indefinite
operator (sigma sits inside the spectrum), and runs as one fused device
program (lax.while_loop with an early-exit residual test — no host
round-trips between iterations).

In the stacked-real representation a Hermitian complex operator is a real
symmetric operator on the (2, dim) array viewed as a real vector of length
2*dim, so the classical real-arithmetic MINRES recurrence (Paige & Saunders
1975) applies verbatim with plain elementwise inner products.
"""

import numpy as np
import jax.numpy as jnp
from jax import lax


def minres_solver(matvec, shift=0.0, maxiter=None, rtol=None):
    """Build a traceable ``solve(b) ~= (A - shift)^{-1} b``.

    Parameters
    ----------
    matvec : callable
        (2, dim) -> (2, dim) traceable Hermitian apply.
    shift : float
        The real shift sigma.
    maxiter : int, optional
        Iteration cap (the loop exits earlier once the residual test
        passes). Default 300.
    rtol : float, optional
        Relative residual target ||b - (A-sigma)x|| <= rtol * ||b||.

    Returns
    -------
    callable mapping (2, dim) -> (2, dim), traceable (jit/scan-safe).
    """
    if maxiter is None:
        maxiter = 300
    if rtol is None:
        rtol = 1e-10

    def solve(b):
        dtype = b.dtype
        sigma = jnp.asarray(shift, dtype)
        eps = jnp.asarray(np.finfo(np.dtype(dtype)).eps, dtype)

        def op(v):
            return matvec(v) - sigma * v

        def rdot(x, y):
            return jnp.sum(x * y)

        beta1 = jnp.sqrt(rdot(b, b))
        zero_vec = jnp.zeros_like(b)
        zero = jnp.asarray(0, dtype)

        def cond(carry):
            itn, _x, _r1, _r2, _w, _w2, beta, _oldb, _dbar, _eps_k, \
                phibar, _cs, _sn = carry
            return ((itn < maxiter) & (phibar > rtol * beta1)
                    & (beta > eps * beta1))

        def body(carry):
            itn, x, r1, r2, w, w2, beta, oldb, dbar, eps_k, phibar, cs, sn \
                = carry

            # Lanczos step on the shifted operator
            v = r2 / beta
            y = op(v)
            y = y - jnp.where(itn >= 1,
                              beta / jnp.where(oldb > 0, oldb, 1), zero) * r1
            alfa = rdot(v, y)
            y = y - (alfa / beta) * r2
            beta_next = jnp.sqrt(rdot(y, y))

            # fold the new tridiagonal column through the previous Givens
            # rotation, then compute the next one
            oldeps = eps_k
            delta = cs * dbar + sn * alfa
            gbar = sn * dbar - cs * alfa
            eps_next = sn * beta_next
            dbar_next = -cs * beta_next
            gamma = jnp.sqrt(gbar * gbar + beta_next * beta_next)
            gamma = jnp.maximum(gamma, eps * jnp.maximum(beta1, 1))
            cs_next = gbar / gamma
            sn_next = beta_next / gamma
            phi = cs_next * phibar
            phibar_next = sn_next * phibar

            # search-direction and solution updates
            w_next = (v - oldeps * w2 - delta * w) / gamma
            x = x + phi * w_next

            return (itn + 1, x, r2, y, w_next, w, beta_next, beta,
                    dbar_next, eps_next, phibar_next, cs_next, sn_next)

        init = (jnp.asarray(0, jnp.int32), zero_vec, b, b, zero_vec,
                zero_vec, beta1, zero, zero, zero, beta1,
                jnp.asarray(-1, dtype), zero)
        final = lax.while_loop(cond, body, init)
        return final[1]

    return solve
