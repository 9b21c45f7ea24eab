"""
Complex vector arithmetic over stacked-real arrays.

A complex vector of dimension N is stored as a real array of shape (2, N):
row 0 = real part, row 1 = imaginary part. Every engine works on real
planes (the sector and XOR-dense engines run real matmuls on them), so
this explicit representation is the native one; XLA fuses these
elementwise kernels with their neighbors.

All functions are jitted and work on sharded arrays (GSPMD inserts the psum
for reductions over a sharded axis automatically).
"""

from functools import partial

import jax
import jax.numpy as jnp


@jax.jit
def vdot(x, y):
    """<x|y> with x conjugated. Returns (re, im) device scalars."""
    xr, xi = x[0], x[1]
    yr, yi = y[0], y[1]
    re = jnp.sum(xr * yr) + jnp.sum(xi * yi)
    im = jnp.sum(xr * yi) - jnp.sum(xi * yr)
    return re, im


@jax.jit
def norm_squared(x):
    return jnp.sum(x * x)


@jax.jit
def norm(x):
    return jnp.sqrt(jnp.sum(x * x))


@jax.jit
def scale_real(x, a):
    a = jnp.asarray(a, dtype=x.dtype)
    return x * a


@jax.jit
def scale_complex(x, ar, ai):
    ar = jnp.asarray(ar, dtype=x.dtype)
    ai = jnp.asarray(ai, dtype=x.dtype)
    xr, xi = x[0], x[1]
    return jnp.stack([ar * xr - ai * xi, ar * xi + ai * xr])


@jax.jit
def axpby(ar, ai, x, br, bi, y):
    """alpha*x + beta*y with complex scalars alpha=(ar,ai), beta=(br,bi)."""
    dt = x.dtype
    ar, ai, br, bi = (jnp.asarray(v, dtype=dt) for v in (ar, ai, br, bi))
    xr, xi = x[0], x[1]
    yr, yi = y[0], y[1]
    return jnp.stack([ar * xr - ai * xi + br * yr - bi * yi,
                      ar * xi + ai * xr + br * yi + bi * yr])


@jax.jit
def add(x, y):
    return x + y


@jax.jit
def sub(x, y):
    return x - y


@jax.jit
def shift(x, cr, ci):
    """Add the complex scalar (cr, ci) to every element."""
    dt = x.dtype
    return x + jnp.stack([jnp.full_like(x[0], jnp.asarray(cr, dt)),
                          jnp.full_like(x[1], jnp.asarray(ci, dt))])


@partial(jax.jit, static_argnums=3)
def shift_n(x, cr, ci, n):
    """Add the complex scalar (cr, ci) to the first ``n`` elements only
    (the rest is state-storage padding, which must stay zero)."""
    if n == x.shape[-1]:
        return shift(x, cr, ci)
    dt = x.dtype
    keep = (jax.lax.broadcasted_iota(jnp.int32, (x.shape[-1],), 0)
            < n).astype(dt)
    return x + jnp.stack([keep * jnp.asarray(cr, dt),
                          keep * jnp.asarray(ci, dt)])


@jax.jit
def mul_elementwise(x, y):
    xr, xi = x[0], x[1]
    yr, yi = y[0], y[1]
    return jnp.stack([xr * yr - xi * yi, xr * yi + xi * yr])


@jax.jit
def mask_rows(x, keep):
    """Zero the elements where ``keep`` is 0 (real mask broadcast over
    re/im)."""
    return x * keep[None, :].astype(x.dtype)


def from_numpy(vec, dtype):
    """Host complex array -> (2, N) stacked real."""
    import numpy as np
    vec = np.asarray(vec)
    return np.stack([vec.real, vec.imag]).astype(dtype)
