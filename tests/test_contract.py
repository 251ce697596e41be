"""Window-contraction full-space engine (ops/apply_contract.py).

Engine agreement with the matrix-free row kernel and the roll engine,
coverage beyond the roll engine's popcount constraint (t-J, d=3), f32
accuracy at HIGHEST matmul precision, and the mixed-precision solve path.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.models_zoo import (bose_hubbard_square, heisenberg_chain,
                              kagome_heisenberg, spinless_fermion_honeycomb)


def _contract_vs_matvecfull(m, cons, vals, tol=1e-11):
    import jax.numpy as jnp

    from quantum_basis_tpu.ops.apply_contract import ContractOp

    m.enumerate_basis_full(cons, vals)
    labels = m.sec_full[0].labels
    cop = ContractOp(m.compiled_Ham, labels, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    x = np.zeros(cop.N)
    x[labels] = rng.normal(size=labels.size)
    yc = cop((jnp.asarray(x), None))
    mv = m.sec_full[0].matvec
    ys = mv((jnp.asarray(x[labels]), None))
    err = float(np.max(np.abs(np.asarray(yc[0])[labels] - np.asarray(ys[0]))))
    assert err < tol, err
    if yc[1] is not None:
        b = np.asarray(ys[1]) if ys[1] is not None else 0.0
        assert float(np.max(np.abs(np.asarray(yc[1])[labels] - b))) < tol
    return cop


def test_contract_chain_spin_half():
    m, c = heisenberg_chain(12, "1/2")
    cop = _contract_vs_matvecfull(m, [c["Sz"]], [0.0])
    assert not cop.plan.roll_terms  # PBC bond absorbed by a rotated frame


def test_contract_chain_spin_one_mixed_radix():
    m, c = heisenberg_chain(8, "1")
    _contract_vs_matvecfull(m, [c["Sz"]], [0.0])


def test_contract_fermionic_jw():
    m, ops = spinless_fermion_honeycomb(3, 2)
    _contract_vs_matvecfull(m, [ops["N"]], [4.0])


def test_contract_kagome():
    m, c = kagome_heisenberg(2, 2)
    _contract_vs_matvecfull(m, [c["Sz"]], [0.0])


def test_contract_boson():
    m, ops = bose_hubbard_square(2, 2, 2)
    _contract_vs_matvecfull(m, [ops["N"]], [4.0])


def test_contract_covers_tj_beyond_roll_engine():
    """d=3 fermionic t-J: the roll engine's popcount-JW constraint fails,
    but exact joint matrices make the window engine applicable."""
    from tests.test_golden_chain import build_tj_chain

    from quantum_basis_tpu.ops.apply_contract import supports_contract
    from quantum_basis_tpu.ops.apply_fullspace import supports_fullspace

    m, Sz_total, N_total = build_tj_chain(10)
    assert not supports_fullspace(m.compiled_Ham)
    assert supports_contract(m.compiled_Ham)
    _contract_vs_matvecfull(m, [Sz_total, N_total], [0.0, 6.0])


def test_contract_f32_accuracy():
    """HIGHEST-precision f32 contraction tracks f64 to ~1e-6 relative
    (reduced-precision bf16/TF32 dots would be ~1e-3 — the engine must not
    use them)."""
    import jax.numpy as jnp

    from quantum_basis_tpu.ops.apply_contract import ContractOp

    m, c = heisenberg_chain(12, "1/2")
    m.enumerate_basis_full([c["Sz"]], [0.0])
    labels = m.sec_full[0].labels
    c64 = ContractOp(m.compiled_Ham, labels, dtype=jnp.float64)
    c32 = ContractOp(m.compiled_Ham, labels, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    x = np.zeros(c64.N)
    x[labels] = rng.normal(size=labels.size)
    y64 = np.asarray(c64((jnp.asarray(x), None))[0])
    y32 = np.asarray(c32((jnp.asarray(x, np.float32), None))[0], np.float64)
    rel = np.max(np.abs(y64 - y32)) / np.max(np.abs(y64))
    assert rel < 5e-6, rel


def test_mixed_precision_solve_golden():
    """f32 Krylov + f64 polish reproduces the chain-16 golden E0 to 1e-9
    (reference assert: src/main_test.cc:88)."""
    from quantum_basis_tpu import config

    m, c = heisenberg_chain(16, "1/2")
    m.enumerate_basis_full([c["Sz"]], [0.0])
    old = config.mixed_precision
    config.mixed_precision = True
    try:
        m.locate_E0_lanczos(nev=1, ncv=1)
    finally:
        config.mixed_precision = old
    assert abs(m.eigenvals_full[0] - (-7.142296361)) < 1e-9
    # the solve used the f32 engine for stage 1
    import jax.numpy as jnp

    assert jnp.dtype(jnp.float32) in m.sec_full[0]._fs_cache


def _contract_pairs_vs_matvecfull(m, cons, vals, max_window, tol=1e-11):
    """Force the pair-window path (tiny max_window) and compare against the
    sector matvec with a COMPLEX input vector (exercises _pair_G re/im and
    the out-of-support JW sign prefactor)."""
    import jax.numpy as jnp

    from quantum_basis_tpu.ops.apply_contract import ContractOp

    m.enumerate_basis_full(cons, vals)
    labels = m.sec_full[0].labels
    cop = ContractOp(m.compiled_Ham, labels, dtype=jnp.float64,
                     max_window=max_window)
    assert cop._pairs, "max_window=%d did not force any pair windows" \
        % max_window
    rng = np.random.default_rng(11)
    xr = np.zeros(cop.N)
    xi = np.zeros(cop.N)
    xr[labels] = rng.normal(size=labels.size)
    xi[labels] = rng.normal(size=labels.size)
    yc = cop((jnp.asarray(xr), jnp.asarray(xi)))
    mv = m.sec_full[0].matvec
    ys = mv((jnp.asarray(xr[labels]), jnp.asarray(xi[labels])))
    err = float(np.max(np.abs(np.asarray(yc[0])[labels] - np.asarray(ys[0]))))
    assert err < tol, err
    yi_ref = (np.asarray(ys[1]) if ys[1] is not None
              else np.zeros(labels.size))
    yi = (np.asarray(yc[1])[labels] if yc[1] is not None
          else np.zeros(labels.size))
    assert float(np.max(np.abs(yi - yi_ref))) < tol
    return cop


def test_contract_pair_windows_spin_chain():
    """max_window=2 on a d=2 chain makes every 2-site bond a pair window
    (no 2-slot window fits in D<=2) — covers the 5-axis einsum path."""
    m, c = heisenberg_chain(10, "1/2")
    cop = _contract_pairs_vs_matvecfull(m, [c["Sz"]], [0.0], max_window=2)
    assert not cop._wins or all(w[2] <= 2 for w in cop._wins)


def test_contract_pair_windows_fermionic_jw():
    """Pairs on the honeycomb spinless fermion: hopping terms carry JW
    strings, so the pair path must reproduce both the intra-support joint
    matrix and the out-of-support elementwise sign prefactor."""
    m, ops = spinless_fermion_honeycomb(3, 2)
    _contract_pairs_vs_matvecfull(m, [ops["N"]], [3.0], max_window=2)
