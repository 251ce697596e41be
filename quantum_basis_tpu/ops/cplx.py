"""Split-complex vector helpers.

All device numerics carry (re, im) pairs of float64 arrays, with
``im=None`` for real sectors (real symmetric H), so real sectors pay no
complex arithmetic. These helpers keep solver code readable. A "cvec" is
the tuple (re, im_or_None).

f64 dot products use ``jnp.vdot`` (exact on native-f64 backends), or
elementwise-multiply + reduce when ``config.f64_reduce_dots`` is set (for
a backend whose f64 dot_general is not exact). f32 dots run at
Precision.HIGHEST.
"""

from __future__ import annotations

import jax.numpy as jnp


def _dot(a, b):
    """Sum(a*b) with precision-safe lowering (see module docstring).

    f32 dots force Precision.HIGHEST: a reduced-precision default (bf16 or
    TF32 inputs, ~1e-3 relative error) flips small curvature values
    (pAp ~ spectral-gap scale) negative inside the RQI inner CG, and the
    solve silently returns a zero correction.
    """
    import jax

    if a.dtype == jnp.float64:
        from quantum_basis_tpu import config

        if config.f64_reduce_dots:
            return jnp.sum(a * b)
        return jnp.vdot(a, b)
    return jnp.vdot(a, b, precision=jax.lax.Precision.HIGHEST)


def is_real(x):
    return x[1] is None


def zeros_like(x):
    re, im = x
    return (jnp.zeros_like(re), None if im is None else jnp.zeros_like(im))


def add(x, y):
    xr, xi = x
    yr, yi = y
    im = None
    if xi is not None or yi is not None:
        im = (xi if xi is not None else 0.0) + (yi if yi is not None else 0.0)
    return (xr + yr, im)


def sub(x, y):
    xr, xi = x
    yr, yi = y
    im = None
    if xi is not None or yi is not None:
        im = (xi if xi is not None else 0.0) - (yi if yi is not None else 0.0)
    return (xr - yr, im)


def scale(x, s):
    """Scale by a real scalar."""
    re, im = x
    return (re * s, None if im is None else im * s)


def axpy(a, x, y):
    """y + a*x with real scalar a."""
    xr, xi = x
    yr, yi = y
    im = None
    if xi is not None or yi is not None:
        im = (yi if yi is not None else 0.0) + a * (xi if xi is not None else 0.0)
    return (yr + a * xr, im)


def caxpy(a, x, y):
    """y + a*x with split-complex scalar a = (ar, ai_or_None)."""
    ar, ai = a
    xr, xi = x
    yr, yi = y
    rr = yr + ar * xr
    ri = yi
    if ai is not None:
        rr = rr - ai * (xi if xi is not None else 0.0)
    if xi is not None or ai is not None or yi is not None:
        ri = (yi if yi is not None else 0.0) \
            + ar * (xi if xi is not None else 0.0)
        if ai is not None:
            ri = ri + ai * xr
    return (rr, ri)


def project_out_one(d, x):
    """x - <d, x> d (one-direction Gram-Schmidt, split-complex)."""
    cr, ci = vdot(d, x)
    return caxpy((-cr, None if ci is None else -ci), d, x)


def vdot_re(x, y):
    """Re <x, y> (conjugate-linear in x)."""
    xr, xi = x
    yr, yi = y
    out = _dot(xr, yr)
    if xi is not None and yi is not None:
        out = out + _dot(xi, yi)
    return out


def vdot(x, y):
    """<x, y> = (re, im) with im possibly None."""
    xr, xi = x
    yr, yi = y
    re = _dot(xr, yr)
    im = None
    if xi is not None or yi is not None:
        xi_ = jnp.zeros_like(xr) if xi is None else xi
        yi_ = jnp.zeros_like(yr) if yi is None else yi
        re = re + _dot(xi_, yi_)
        im = _dot(xr, yi_) - _dot(xi_, yr)
    return re, im


def norm(x):
    return jnp.sqrt(vdot_re(x, x))


def to_numpy_complex(x):
    import numpy as np

    re, im = x
    if im is None:
        return np.asarray(re)
    return np.asarray(re) + 1j * np.asarray(im)
