"""Chebyshev machinery: KPM moments and filtered interior eigensolving.

Two capabilities built on the same rescaled-H Chebyshev recurrence:

- :func:`kpm_moments` — kernel polynomial method moments mu_n for spectral
  densities. The reference only implements the spectral-bounds step
  (``energy_scale``, src/kpm.cc:45-99) with no moment loop; this completes
  it (the BASELINE.json north star names fused Chebyshev SpMV chains).
- :func:`eigs_window` — interior eigenpairs in [E_lo, E_hi], replacing the
  reference's MKL FEAST dependency (``call_feast``, src/lanczos.cc:605-652).
  No shift-invert solves: instead each subspace iteration applies a
  Chebyshev bandpass filter polynomial of H (all SpMVs), then
  Rayleigh-Ritz in the filtered subspace — the standard filtered subspace
  iteration [Zhou & Saad].

The recurrence runs as one ``lax.scan`` over coefficient arrays so a whole
filter application is a single device dispatch.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu.ops import cplx as cx
from quantum_basis_tpu.solvers.lanczos import _mv_protocol, energy_scale


def _rescale(e_min, e_max):
    """H -> Hs = (H - c)/d with spectrum in [-1, 1]."""
    c = 0.5 * (e_max + e_min)
    d = 0.5 * (e_max - e_min)
    return c, d


def _make_cheb_apply(matvec, c, d, n_coeff):
    """jit y = sum_n coeff_n T_n(Hs) x via the three-term recurrence."""
    import jax
    import jax.numpy as jnp

    mv_apply, _ = _mv_protocol(matvec)
    inv_d = 1.0 / d

    def hs(params, x):
        y = mv_apply(params, x)
        return cx.scale(cx.axpy(-c, x, y), inv_d)

    def run(params, x, coeff):
        t_prev = x                      # T_0 x
        t_cur = hs(params, x)           # T_1 x
        y = cx.add(cx.scale(t_prev, coeff[0]), cx.scale(t_cur, coeff[1]))

        def body(carry, cn):
            t_prev, t_cur, y = carry
            t_next = cx.sub(cx.scale(hs(params, t_cur), 2.0), t_prev)
            y = cx.axpy(cn, t_next, y)
            return (t_cur, t_next, y), None

        (_, _, y), _ = jax.lax.scan(body, (t_prev, t_cur, y), coeff[2:])
        return y

    return jax.jit(run)


def kpm_moments(matvec, v0, n_moments: int, bounds=None, slack: float = 0.05,
                chunk: int | None = None):
    """KPM moments mu_n = <v0| T_n(Hs) |v0> for n < n_moments.

    ``bounds`` = (e_min, e_max) or None (estimated via energy_scale).
    Returns (mu (n_moments,), e_min, e_max). Use with a Jackson kernel to
    reconstruct spectral densities.

    ``chunk``: run the recurrence as ceil((n-2)/chunk) jitted programs of
    <= chunk scan steps with a device-resident carry instead of one fused
    program. Keeps each program's temporaries bounded at full-space scale
    on a 16 GB device; the moments are bit-identical.
    """
    import jax
    import jax.numpy as jnp

    if bounds is None:
        e_min, e_max = energy_scale(matvec, v0, slack=slack)
    else:
        e_min, e_max = bounds
    c, d = _rescale(e_min, e_max)
    mv_apply, mv_params = _mv_protocol(matvec)
    inv_d = 1.0 / d
    v0 = cx.scale(v0, 1.0 / float(cx.norm(v0)))

    def hs(params, x):
        y = mv_apply(params, x)
        return cx.scale(cx.axpy(-c, x, y), inv_d)

    def body_from(params, x):
        # params/x arrive as jit ARGUMENTS of the enclosing program —
        # closing over device arrays would bake them into the HLO as
        # literals (hundreds of MB past the remote compiler's limit)
        def body(carry, _):
            t_prev, t_cur = carry
            t_next = cx.sub(cx.scale(hs(params, t_cur), 2.0), t_prev)
            mu = cx.vdot_re(x, t_next)
            return (t_cur, t_next), mu
        return body

    if chunk is None:
        def run(params, x):
            t_prev = x
            t_cur = hs(params, x)
            mu0 = cx.vdot_re(x, t_prev)
            mu1 = cx.vdot_re(x, t_cur)

            def body(carry, _):
                t_prev, t_cur = carry
                t_next = cx.sub(cx.scale(hs(params, t_cur), 2.0), t_prev)
                mu = cx.vdot_re(x, t_next)
                return (t_cur, t_next), mu

            _, mus = jax.lax.scan(body, (t_prev, t_cur), None,
                                  length=n_moments - 2)
            return mu0, mu1, mus

        mu0, mu1, mus = jax.jit(run)(mv_params, v0)
        mu = np.concatenate([[float(mu0), float(mu1)], np.asarray(mus)])
        return mu, e_min, e_max

    @jax.jit
    def init(params, x):
        t_cur = hs(params, x)
        return t_cur, cx.vdot_re(x, x), cx.vdot_re(x, t_cur)

    # every chunk runs the SAME length (one compiled program total): the
    # final partial chunk computes a few moments past n_moments and the
    # surplus is truncated — compute is trivial next to a second compile
    # of a distinct-length program
    @jax.jit
    def prog(params, xx, tp, tc):
        (tp, tc), mus = jax.lax.scan(
            body_from(params, xx), (tp, tc), None, length=chunk)
        return tp, tc, mus

    t_cur, mu0, mu1 = init(mv_params, v0)
    mu = [float(mu0), float(mu1)]
    t_prev = v0
    while len(mu) < n_moments:
        t_prev, t_cur, mus = prog(mv_params, v0, t_prev, t_cur)
        mu.extend(np.asarray(mus).tolist())
    return np.asarray(mu[:n_moments], dtype=np.float64), e_min, e_max


def jackson_kernel(n_moments: int) -> np.ndarray:
    """Jackson damping factors g_n (standard KPM kernel)."""
    n = np.arange(n_moments)
    N = n_moments + 1
    return ((N - n) * np.cos(np.pi * n / N)
            + np.sin(np.pi * n / N) / np.tan(np.pi / N)) / N


def kpm_density(mu: np.ndarray, e_min: float, e_max: float,
                energies: np.ndarray) -> np.ndarray:
    """Reconstruct the spectral density from KPM moments (Jackson kernel)."""
    c, d = _rescale(e_min, e_max)
    x = np.clip((np.asarray(energies) - c) / d, -1 + 1e-12, 1 - 1e-12)
    g = jackson_kernel(mu.size)
    theta = np.arccos(x)
    out = g[0] * mu[0] * np.ones_like(x)
    for n in range(1, mu.size):
        out += 2.0 * g[n] * mu[n] * np.cos(n * theta)
    return out / (np.pi * np.sqrt(1.0 - x * x) * d)


def _window_filter_coeffs(a, b, degree, e_min, e_max):
    """Chebyshev expansion of the indicator of [a, b] (Jackson-damped)."""
    c, d = _rescale(e_min, e_max)
    lo, hi = (a - c) / d, (b - c) / d
    lo, hi = max(lo, -1.0), min(hi, 1.0)
    n = np.arange(degree)
    coeff = np.empty(degree)
    coeff[0] = (np.arccos(lo) - np.arccos(hi)) / np.pi
    tl, th = np.arccos(lo), np.arccos(hi)
    for k in range(1, degree):
        coeff[k] = 2.0 * (np.sin(k * tl) - np.sin(k * th)) / (np.pi * k)
    return coeff * jackson_kernel(degree)


def eigs_window(matvec, n, e_lo, e_hi, nev_max=10, degree=200, n_iter=30,
                tol=1e-9, seed=7, complex_vec=False, bounds=None):
    """Interior eigenpairs with eigenvalues in [e_lo, e_hi].

    Chebyshev-filtered subspace iteration — the FEAST replacement
    (reference: call_feast, src/lanczos.cc:605-652; locate_Es_feast,
    src/model.cc:1424-1466). Returns (evals list, evecs list of cvecs),
    only those inside the window, ascending.
    """
    import jax.numpy as jnp

    from quantum_basis_tpu.utils.rng import vec_randomize

    if bounds is None:
        re, im = vec_randomize(n, seed=seed + 1, complex_valued=complex_vec)
        v = (jnp.asarray(re), jnp.asarray(im) if im is not None else None)
        e_min, e_max = energy_scale(matvec, v, slack=0.1)
    else:
        e_min, e_max = bounds
    c, d = _rescale(e_min, e_max)
    coeff = _window_filter_coeffs(e_lo, e_hi, degree, e_min, e_max)
    cheb = _make_cheb_apply(matvec, c, d, degree)
    mv_apply, mv_params = _mv_protocol(matvec)
    coeff_d = jnp.asarray(coeff)

    # stochastic estimate of the eigenvalue count in the window (the same
    # idea FEAST uses to size its subspace): E[<z|f(H)|z>] = tr f(H) / n
    # for unit random z; tr f(H) ~ #eigenvalues inside.
    est = 0.0
    n_probe = 4
    for i in range(n_probe):
        re, im = vec_randomize(n, seed=seed + 977 * (i + 1),
                               complex_valued=complex_vec)
        z = (jnp.asarray(re), jnp.asarray(im) if im is not None else None)
        fz = cheb(mv_params, z, coeff_d)
        est += float(cx.vdot_re(z, fz)) * n / n_probe
    if est > 1.3 * nev_max + 2:
        raise ValueError(
            f"window [{e_lo}, {e_hi}] holds ~{est:.0f} eigenvalues; raise "
            f"nev_max (= {nev_max}) or shrink the window")

    m_sub = int(min(max(2 * nev_max, nev_max + 4), n))
    basis = []
    for i in range(m_sub):
        re, im = vec_randomize(n, seed=seed + 10 * i + 3,
                               complex_valued=complex_vec)
        basis.append((jnp.asarray(re),
                      jnp.asarray(im) if im is not None else None))

    prev = None
    for _ in range(n_iter):
        # filter
        basis = [cheb(mv_params, v, coeff_d) for v in basis]
        # orthonormalize (modified Gram-Schmidt on host-controlled loop)
        ortho = []
        for v in basis:
            for u in ortho:
                pr, pi = cx.vdot(u, v)
                v = _axpy_c(-pr, 0.0 if pi is None else -pi, u, v)
            nrm = float(cx.norm(v))
            if nrm > 1e-12:
                ortho.append(cx.scale(v, 1.0 / nrm))
        basis = ortho
        m = len(basis)
        if m == 0:
            return [], []
        # Rayleigh-Ritz with H
        hb = [mv_apply(mv_params, v) for v in basis]
        A = np.zeros((m, m), dtype=np.complex128)
        for i in range(m):
            for j in range(m):
                re_, im_ = cx.vdot(basis[i], hb[j])
                A[i, j] = float(re_) + 1j * (0.0 if im_ is None else float(im_))
        theta, S = np.linalg.eigh((A + A.conj().T) / 2)
        # rotate basis to Ritz vectors
        basis = _rotate(basis, S, complex_vec)
        inside = [(t, i) for i, t in enumerate(theta)
                  if e_lo - 1e-9 <= t <= e_hi + 1e-9]
        if prev is not None and len(inside) == len(prev):
            deltas = [abs(t - p) for (t, _), p in zip(inside, prev)]
            if deltas and max(deltas) < tol:
                # converged: residual check on the inside set
                out_vals, out_vecs = [], []
                for t, i in inside[:nev_max]:
                    v = basis[i]
                    r = cx.axpy(-t, v, mv_apply(mv_params, v))
                    if float(cx.norm(r)) < max(1e-6, 1e3 * tol):
                        out_vals.append(float(t))
                        out_vecs.append(v)
                return out_vals, out_vecs
        prev = [t for t, _ in inside]
    raise RuntimeError("Chebyshev-filtered subspace iteration did not converge")


def _axpy_c(ar, ai, x, y):
    """y + (ar + i ai) * x in split-complex."""
    import jax.numpy as jnp

    xr, xi = x
    yr, yi = y
    nr = yr + ar * xr - (ai * xi if xi is not None else 0.0)
    if yi is None and xi is None and abs_nonzero(ai):
        yi = jnp.zeros_like(yr)
    if yi is not None or xi is not None or abs_nonzero(ai):
        yi0 = yi if yi is not None else 0.0
        ni = yi0 + ar * (xi if xi is not None else 0.0) + ai * xr
    else:
        ni = None
    return (nr, ni)


def abs_nonzero(v) -> bool:
    try:
        return abs(float(v)) > 0.0
    except Exception:
        return True


def _rotate(basis, S, complex_vec):
    """basis @ S columns -> new list of cvecs (small m, host loop)."""
    m = len(basis)
    out = []
    for k in range(m):
        acc = None
        for i in range(m):
            s = S[i, k]
            term = _axpy_c(float(np.real(s)), float(np.imag(s)), basis[i],
                           acc if acc is not None else cx.zeros_like(basis[i]))
            acc = term
        out.append(acc)
    return out
