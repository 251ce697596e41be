"""Momentum-sector machinery vs dense projector oracle.

Oracle: in the full label space build H (kron oracle) and the unit
translation matrix T (with fermion signs), form the projector
P_k = (1/G) sum_R e^{+i k.R} T(R), orthonormalize its range, and compare the
projected spectrum against the framework's repr matvec. The complex-hopping
(chiral) model has E(k) != E(-k), pinning the phase convention: the k sector
contains two-particle states with q1 + q2 = k for single-particle momenta
defined by eps(q) = -2|t| cos(2 pi q / L + phi) under hopping -t e^{i phi}.
"""

import numpy as np
import pytest

from quantum_basis_tpu.basis.enumerate import enumerate_basis
from quantum_basis_tpu.basis.site_basis import SiteBasis
from quantum_basis_tpu.basis.state import StateSpace
from quantum_basis_tpu.basis.translation import TranslationSet, enumerate_reps, sector_norms
from quantum_basis_tpu.lattice.lattice import Lattice
from quantum_basis_tpu.ops.apply_repr import MatvecRepr, ReprBasis
from quantum_basis_tpu.ops.compile import compile_operator
from quantum_basis_tpu.ops.operators import Mopr, Opr

from oracles import SP_HALF, mopr_dense
from test_apply import heisenberg_mopr, sz_total


def translation_matrix(space, lattice, disp):
    """Dense unit-translation matrix over the full label space (with signs)."""
    plan = lattice.translation_plan(disp)
    labels = np.arange(space.label_space, dtype=np.int64)
    new_labels, parity = space.transform(labels, plan)
    T = np.zeros((space.label_space, space.label_space))
    T[new_labels, labels] = (-1.0) ** parity
    return T


def projected_spectrum(H, space, lattice, momentum, sector_labels=None):
    """Oracle: eigenvalues of H restricted to the momentum-k subspace."""
    dim = lattice.dim
    G_total = np.prod([lattice.L[d] if lattice.bc[d] == "pbc" else 1
                       for d in range(dim)])
    P = np.zeros((space.label_space, space.label_space), dtype=np.complex128)
    disps, _ = lattice.translation_group()
    for R in disps:
        phase = np.exp(+2j * np.pi * np.sum(np.asarray(momentum) * R / lattice.L))
        T = translation_matrix(space, lattice, R)
        P += phase * T
    P /= G_total
    if sector_labels is not None:
        mask = np.zeros(space.label_space, bool)
        mask[sector_labels] = True
        Q = np.diag(mask.astype(float))
        P = Q @ P @ Q
    w, V = np.linalg.eigh((P + P.conj().T) / 2)
    B = V[:, w > 0.5]
    if B.shape[1] == 0:
        return np.array([])
    Hk = B.conj().T @ H @ B
    return np.sort(np.linalg.eigvalsh(Hk))


def repr_dense(model_free_mv, n):
    """Materialize the repr matvec as a dense complex matrix."""
    import jax.numpy as jnp

    H = np.zeros((n, n), dtype=np.complex128)
    for j in range(n):
        e = np.zeros(n)
        e[j] = 1.0
        yr, yi = model_free_mv((jnp.asarray(e), None))
        H[:, j] = np.asarray(yr) + 1j * np.asarray(yi)
    np.testing.assert_allclose(H, H.conj().T, atol=1e-10)
    return H


def _repr_all_k_check(space, lattice, H, conserve=None, vals=None, atol=1e-9):
    labels = enumerate_basis(space, conserve, vals)
    tset = TranslationSet(space, lattice)
    reps = enumerate_reps(tset, labels)
    compiled = compile_operator(H, space)
    Hd = mopr_dense(space, H)
    total_dim = 0
    ks = [[k] for k in range(int(lattice.L[0]))] if lattice.dim == 1 else [
        [kx, ky] for kx in range(int(lattice.L[0]))
        for ky in range(int(lattice.L[1]))]
    for k in ks:
        nus = sector_norms(tset, reps, k)
        if not np.any(nus > 1e-10):
            continue
        rbasis = ReprBasis(space, tset, labels, k, reps_all=reps, block_rows=32)
        mv = MatvecRepr(compiled, rbasis)
        got = np.sort(np.linalg.eigvalsh(repr_dense(mv, rbasis.n)))
        want = projected_spectrum(Hd, space, lattice, k, labels)
        assert got.size == want.size, (k, got.size, want.size)
        np.testing.assert_allclose(got, want, atol=atol, err_msg=f"k={k}")
        total_dim += rbasis.n
    assert total_dim == labels.size  # sum over k recovers the sector


def test_repr_heisenberg_chain_all_k():
    L = 6
    lat = Lattice("chain", [L], ["pbc"])
    space = StateSpace([(SiteBasis.named("spin-1/2"), L)])
    _repr_all_k_check(space, lat, heisenberg_mopr(L), [sz_total(L)], [0.0])


def test_repr_full_space_no_qn():
    L = 4
    lat = Lattice("chain", [L], ["pbc"])
    space = StateSpace([(SiteBasis.named("spin-1/2"), L)])
    _repr_all_k_check(space, lat, heisenberg_mopr(L))


def test_repr_chiral_fermion_pins_phase():
    """Spinless fermions with complex hopping: E(k) != E(-k)."""
    L = 6
    lat = Lattice("chain", [L], ["pbc"])
    space = StateSpace([(SiteBasis.named("spinless-fermion"), L)])
    c = np.array([[0.0, 1.0], [0.0, 0.0]])
    t = 1.0 * np.exp(0.7j)
    H = Mopr()
    n_tot = Mopr()
    for x in range(L):
        j = (x + 1) % L
        ci = Opr(x, 0, True, c)
        cj = Opr(j, 0, True, c)
        H += (-t) * (ci.dagger() * cj)
        H += (-np.conj(t)) * (cj.dagger() * ci)
        n_tot += Opr(x, 0, False, np.array([0.0, 1.0]))
    _repr_all_k_check(space, lat, H, [n_tot], [2.0])


def test_repr_tj_chain_all_k():
    from test_apply import tj_mopr, n_total

    L = 6
    lat = Lattice("chain", [L], ["pbc"])
    space = StateSpace([(SiteBasis.named("tJ"), L)])
    _repr_all_k_check(space, lat, tj_mopr(L), [n_total(L)], [3.0])


def test_repr_square_lattice_2d():
    lat = Lattice("square", [2, 3], ["pbc", "pbc"])
    space = StateSpace([(SiteBasis.named("spin-1/2"), lat.n_sites)])
    H = Mopr()
    for x in range(2):
        for y in range(3):
            i = lat.coor2site([x, y], 0)
            for dx, dy in ((1, 0), (0, 1)):
                j = lat.coor2site([x + dx, y + dy], 0)
                H += 0.5 * (Opr(i, 0, False, SP_HALF["Sp"]) * Opr(j, 0, False, SP_HALF["Sm"])
                            + Opr(i, 0, False, SP_HALF["Sm"]) * Opr(j, 0, False, SP_HALF["Sp"]))
                H += Opr(i, 0, False, SP_HALF["Sz"]) * Opr(j, 0, False, SP_HALF["Sz"])
    _repr_all_k_check(space, lat, H, [sz_total(lat.n_sites)], [0.0])


@pytest.mark.slow
def test_golden_chain16_momentum_sectors():
    """Reference golden values: E0(k) for the 16-site Heisenberg chain
    (examples/trans_symmetric/latt_chain/chain_Heisenberg_spin_half.cc)."""
    from quantum_basis_tpu import Model

    golden = [-7.142296361, -6.523407057, -5.990986863, -5.615175598,
              -5.451965668, -5.525353087, -5.823231143, -6.298652725,
              -6.872106678]
    L = 16
    lat = Lattice("chain", [L], ["pbc"])
    m = Model(lat)
    m.add_orbital(lat.n_sites, "spin-1/2")
    for x in range(L):
        j = (x + 1) % L
        m.add_Ham(0.5 * (Opr(x, 0, False, SP_HALF["Sp"]) * Opr(j, 0, False, SP_HALF["Sm"])
                         + Opr(x, 0, False, SP_HALF["Sm"]) * Opr(j, 0, False, SP_HALF["Sp"])))
        m.add_Ham(Opr(x, 0, False, SP_HALF["Sz"]) * Opr(j, 0, False, SP_HALF["Sz"]))
    got = []
    for k in range(L):
        m.enumerate_basis_repr([k], [sz_total(L)], [0.0], sec=0)
        m.locate_E0_lanczos("repr", nev=1, ncv=1, sec=0)
        got.append(m.eigenvals_repr[0])
    for k in range(L):
        want = golden[k] if k <= 8 else golden[L - k]
        assert abs(got[k] - want) < 1e-8, (k, got[k], want)

def test_measure_repr_cache_not_reused_across_reenumeration():
    """Regression: the per-(sector, operator) MatvecRepr cache must miss
    after the sector slot is re-enumerated with different quantum numbers
    (mirror Sz sectors share momentum AND dimension, so a key without the
    basis identity silently reused the stale device tables)."""
    from tests.models_zoo import SP_HALF, heisenberg_chain
    from quantum_basis_tpu import Opr

    L = 8
    m, c = heisenberg_chain(L)
    sz0 = Opr(0, 0, False, SP_HALF["Sz"])

    m.enumerate_basis_repr([0], [c["Sz"]], [1.0], sec=0)
    m.locate_E0_lanczos(which="repr", sec=0)
    up = m.measure_repr_static(sz0, 0, 0)
    assert abs(up.real - 1.0 / L) < 1e-9

    dim_up = m.dim_repr(0)
    m.enumerate_basis_repr([0], [c["Sz"]], [-1.0], sec=0)
    assert m.dim_repr(0) == dim_up  # mirror sector: key would have aliased
    m.locate_E0_lanczos(which="repr", sec=0)
    dn = m.measure_repr_static(sz0, 0, 0)
    assert abs(dn.real + 1.0 / L) < 1e-9


def test_ell_routed_golden_momentum_sector(monkeypatch):
    """A golden momentum sector solved end to end on the explicit-ELL route
    via the public Model API: chain-16 k=0, E0 = -7.142296361 (reference
    golden, trans_symmetric chain_Heisenberg_spin_half.cc:102). The
    projected full-space fast path is disabled so the explicit-sparse
    branch runs — with mixed precision requested, which that route serves
    in f64."""
    from quantum_basis_tpu import config
    from quantum_basis_tpu.models.model import Model
    from quantum_basis_tpu.ops.sparse import EllMatrix
    from models_zoo import heisenberg_chain

    monkeypatch.setattr(config, "mixed_precision", True)
    monkeypatch.setattr(Model, "_fullspace_repr_op",
                        lambda self, sector, dtype=None: None)
    m, ops = heisenberg_chain(16)
    m.enumerate_basis_repr([0], [ops["Sz"]], [0.0])
    m.locate_E0_lanczos(which="repr")
    assert abs(m.eigenvals_repr[0] - (-7.142296361)) < 1e-8
    assert isinstance(m.sec_repr[0]._ell, EllMatrix)
