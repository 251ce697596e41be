"""Kernel polynomial method (solvers/kpm.py)."""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu.ops.dense import dense_matrix
from quantum_basis_tpu.solvers.kpm import jackson_kernel, kpm_dos, kpm_moments
from tests.models_zoo import heisenberg_chain


def _setup(L=8):
    m, c = heisenberg_chain(L, "1/2")
    m.enumerate_basis_full([c["Sz"]], [0.0])
    s = m.sec_full[0]
    H = dense_matrix(m.compiled_Ham, s.labels).real
    evals = np.linalg.eigvalsh(H)
    return m, s, evals


def test_moments_match_exact_trace():
    """Stochastic moments converge to the exact Chebyshev trace; with many
    random vectors the estimate is within stochastic-noise tolerance."""
    m, s, evals = _setup(8)
    lo, hi = evals[0] - 0.1, evals[-1] + 0.1
    a, b = (hi - lo) / 2, (hi + lo) / 2
    x = (evals - b) / a
    N = 16
    exact = np.array([np.mean(np.cos(k * np.arccos(np.clip(x, -1, 1))))
                      for k in range(N)])
    mu = kpm_moments(s.matvec, s.dim, N, (lo, hi), n_random=64, seed=5)
    np.testing.assert_allclose(mu, exact, atol=0.08)


def test_dos_integrates_to_one_and_finds_spectrum():
    m, s, evals = _setup(8)
    lo, hi = evals[0] - 0.2, evals[-1] + 0.2
    mu = kpm_moments(s.matvec, s.dim, 64, (lo, hi), n_random=32, seed=1)
    E = np.linspace(lo + 1e-3, hi - 1e-3, 800)
    rho = kpm_dos(mu, E, (lo, hi))
    total = np.trapezoid(rho, E)
    assert abs(total - 1.0) < 0.05, total
    assert np.all(rho > -0.02)  # Jackson kernel keeps the DOS ~positive
    # essentially no weight outside the true spectrum
    outside = (E < evals[0] - 0.15) | (E > evals[-1] + 0.15)
    if outside.any():
        assert np.max(np.abs(rho[outside])) < 0.05


def test_jackson_kernel_normalization():
    g = jackson_kernel(32)
    assert abs(g[0] - 1.0) < 1e-12
    assert np.all(np.diff(g) < 1e-12)  # monotone damping


# ---------------------------------------------------------------------------
# Operator-resolved KPM: dynamical structure factor S(q, w)
# ---------------------------------------------------------------------------


def _sz_q(L, q):
    from quantum_basis_tpu import Mopr, Opr
    from tests.models_zoo import SP_HALF

    out = Mopr()
    for x in range(L):
        out += (np.exp(-1j * 2 * np.pi * q * x / L) / np.sqrt(L)) * Opr(
            x, 0, False, SP_HALF["Sz"])
    return out


def test_sqw_kpm_moments_match_exact():
    """Operator-resolved moments mu_m = <phi|T_m(Hs)|phi>/||phi||^2 against
    the dense-diagonalization oracle at solver accuracy."""
    from tests.oracles import mopr_dense, restrict

    L = 8
    q = 2
    m, s, evals = _setup(L)
    m.locate_E0_lanczos(nev=1, ncv=1)
    E0 = m.eigenvals_full[0]
    Aq = _sz_q(L, q)

    # exact: phi = A |gs> in the dense sector basis
    sec = m.sec_full[0]
    H = dense_matrix(m.compiled_Ham, sec.labels).real
    w, V = np.linalg.eigh(H)
    gs = V[:, 0]
    A = restrict(mopr_dense(m.space, Aq), sec.labels)
    phi = A @ gs
    nrm_exact = np.linalg.norm(phi)
    lo, hi = w[0] - 0.3, w[-1] + 0.3
    c, d = (hi + lo) / 2, (hi - lo) / 2
    xk = np.clip((w - c) / d, -1, 1)
    ck2 = np.abs(V.conj().T @ phi) ** 2 / nrm_exact**2
    n_mom = 24
    mu_exact = np.array([np.sum(ck2 * np.cos(k * np.arccos(xk)))
                         for k in range(n_mom)])

    nrm, mu, e_min, e_max = m.measure_full_dynamic_kpm(
        Aq, 0, 0, n_mom, bounds=(lo, hi))
    assert abs(nrm - nrm_exact) < 1e-8
    assert (e_min, e_max) == (lo, hi)
    np.testing.assert_allclose(mu, mu_exact, atol=1e-7)


def test_sqw_kpm_sum_rule_and_contfrac_crosscheck():
    """Reconstructed S(q,w): integral = ||A|gs>||^2 (sum rule); cumulative
    weight agrees with the exact spectrum and the continued-fraction S(q,w)
    at gap midpoints (where any symmetric broadening has fully risen —
    comparing mid-peak would measure kernel shape, not physics)."""
    from tests.oracles import mopr_dense, restrict

    from quantum_basis_tpu.postprocess import spectral_function, sqw_kpm

    L = 8
    q = 3
    m, s, evals = _setup(L)
    m.locate_E0_lanczos(nev=1, ncv=1)
    E0 = float(m.eigenvals_full[0])
    Aq = _sz_q(L, q)

    nrm, mu, e_min, e_max = m.measure_full_dynamic_kpm(Aq, 0, 0, 192)
    omegas = np.linspace(e_min - E0 + 1e-3, e_max - E0 - 1e-3, 4000)
    S = sqw_kpm(omegas, nrm, mu, e_min, e_max, E0)
    dw = omegas[1] - omegas[0]
    total = np.trapezoid(S, omegas)
    assert abs(total - nrm**2) < 0.02 * nrm**2, (total, nrm**2)

    # exact cumulative weight from the dense oracle
    sec = m.sec_full[0]
    H = dense_matrix(m.compiled_Ham, sec.labels).real
    w, V = np.linalg.eigh(H)
    A = restrict(mopr_dense(m.space, Aq), sec.labels)
    wts = np.abs(V.conj().T @ (A @ V[:, 0])) ** 2
    keep = wts > 1e-6 * wts.sum()
    wn = w[keep] - E0
    # checkpoints midway between well-separated excitation clusters
    order = np.argsort(wn)
    wn_s = wn[order]
    gaps = np.nonzero(np.diff(wn_s) > 0.8)[0]
    checks = [(wn_s[i] + wn_s[i + 1]) / 2 for i in gaps]
    assert len(checks) >= 2

    def cum_exact(x):
        return float(wts[keep][wn <= x].sum())

    cum = np.cumsum(S) * dw
    nrm_cf, a, b = m.measure_full_dynamic(Aq, 0, 0, 30)
    S_cf = spectral_function(omegas, nrm_cf, a, b, E0, eta=0.05)
    cum_cf = np.cumsum(S_cf) * dw
    for x in checks:
        i = int(np.searchsorted(omegas, x))
        assert abs(cum[i] - cum_exact(x)) < 0.03 * nrm**2, (x, cum[i])
        assert abs(cum_cf[i] - cum_exact(x)) < 0.05 * nrm**2, (x, cum_cf[i])


def test_repr_kpm_fast_path_matches_repr_kernel(monkeypatch):
    """measure_repr_dynamic_kpm through the projected full-space engine
    (the flagship momentum machinery) must produce the same Chebyshev
    moments as the sector-dimension fallback — the repr basis embeds
    isometrically in the full space (dual-path discipline, SURVEY §4.3)."""
    import numpy as np

    from models_zoo import SP_HALF, heisenberg_chain
    from test_dynamics import _aq

    L, q = 10, 3
    bounds = (-8.0, 8.0)

    def run(fast):
        m, ops = heisenberg_chain(L)
        if not fast:
            from quantum_basis_tpu.models.model import Model

            monkeypatch.setattr(Model, "_fullspace_repr_op",
                                lambda self, sector, dtype=None: None)
        k_gs = L // 2
        m.enumerate_basis_repr([k_gs], [ops["Sz"]], [0.0], sec=0)
        m.locate_E0_lanczos("repr", nev=1, sec=0)
        m.enumerate_basis_repr([(k_gs - q) % L], [ops["Sz"]], [0.0], sec=1)
        Aq = _aq(L, q, SP_HALF["Sz"])
        nrm, mu, e0, e1 = m.measure_repr_dynamic_kpm(
            Aq, 0, 1, 24, bounds=bounds)
        monkeypatch.undo()
        return nrm, np.asarray(mu)

    nrm_fast, mu_fast = run(True)
    nrm_slow, mu_slow = run(False)
    assert abs(nrm_fast - nrm_slow) < 1e-8
    np.testing.assert_allclose(mu_fast, mu_slow, atol=1e-8)


def test_repr_kpm_fallback_runs_on_sector_ell(monkeypatch):
    """Above config.kpm_fullspace_max_N the moments run on the
    sector-dimension ELL (the explicit engine the repr solves use) and
    match the projected full-space moments."""
    import numpy as np

    from models_zoo import SP_HALF, heisenberg_chain
    from test_dynamics import _aq
    from quantum_basis_tpu import config
    from quantum_basis_tpu.ops.sparse import EllMatrix

    L, q = 10, 3
    bounds = (-8.0, 8.0)

    def run(max_n):
        monkeypatch.setattr(config, "kpm_fullspace_max_N", max_n)
        m, ops = heisenberg_chain(L)
        k_gs = L // 2
        m.enumerate_basis_repr([k_gs], [ops["Sz"]], [0.0], sec=0)
        m.locate_E0_lanczos("repr", nev=1, sec=0)
        m.enumerate_basis_repr([(k_gs - q) % L], [ops["Sz"]], [0.0], sec=1)
        nrm, mu, e0, e1 = m.measure_repr_dynamic_kpm(
            _aq(L, q, SP_HALF["Sz"]), 0, 1, 24, bounds=bounds)
        return m.sec_repr[1], nrm, np.asarray(mu)

    dst, nrm_ell, mu_ell = run(1)
    assert isinstance(getattr(dst, "_ell", None), EllMatrix)
    dst, nrm_fs, mu_fs = run(1 << 23)
    assert getattr(dst, "_ell", None) is None  # the fast path built no ELL
    assert abs(nrm_ell - nrm_fs) < 1e-8
    np.testing.assert_allclose(mu_ell, mu_fs, atol=1e-8)
