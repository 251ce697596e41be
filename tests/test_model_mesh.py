"""Model-level multi-device orchestration.

``Model(..., mesh=...)`` must reproduce golden-zoo E0s through the PUBLIC
API on the 8-virtual-device mesh — no hand-written driver: residency and
matvecs route through the sharded engines automatically, with the
halo-vs-allgather choice made from ``halo_stats()``.
"""

import numpy as np
import pytest

from quantum_basis_tpu.parallel import EllShardedHalo, basis_mesh


@pytest.mark.multichip
def test_model_mesh_full_golden_chain():
    """Heisenberg chain L=16 full sector on the mesh: E0 = -7.142296361
    (reference golden, src/main_test.cc:88), solved via Model(mesh=...)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from models_zoo import heisenberg_chain

    m, ops = heisenberg_chain(16)
    m.set_mesh(basis_mesh(8))
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    m.locate_E0_lanczos("full", nev=1, ncv=1)
    assert abs(m.eigenvals_full[0] - (-7.142296361)) < 1e-8
    # the chain's banded ELL must have routed to the halo engine
    mv = m.sec_full[0]._mesh_mv[1]
    assert isinstance(mv, EllShardedHalo)
    assert mv.halo_stats()["traffic_ratio"] < 1.0
    # eigenvector usable by the ordinary measurement API (single-entry
    # model object, cf. reference src/model.cc:74-177)
    SZ = np.array([0.5, -0.5])
    from quantum_basis_tpu import Opr

    c = m.measure_full_static(Opr(0, 0, False, SZ) * Opr(1, 0, False, SZ),
                              0, 0)
    assert abs(c.real - (-0.1487978408)) < 1e-7


@pytest.mark.multichip
def test_model_mesh_repr_golden_chain():
    """Momentum sector k=0 of the L=16 chain on the mesh equals the full
    E0 (reference golden E0(k=0) = -7.142296361,
    trans_symmetric chain_Heisenberg_spin_half.cc:102)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from models_zoo import heisenberg_chain

    m, ops = heisenberg_chain(16)
    m.set_mesh(basis_mesh(8))
    m.enumerate_basis_repr([0], [ops["Sz"]], [0.0])
    m.locate_E0_lanczos(which="repr")
    assert abs(m.eigenvals_repr[0] - (-7.142296361)) < 1e-8


@pytest.mark.multichip
def test_model_mesh_matches_single_device():
    """Mesh route and single-device route agree at solver tolerance on a
    fermionic model (t-J chain L=12, N=8, Sz=0; golden E0 = -9.762087307,
    src/main_test.cc:207)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from test_golden_chain import build_tj_chain

    m, Sz_total, N_total = build_tj_chain(12)
    m.set_mesh(basis_mesh(8))
    dim = m.enumerate_basis_full([Sz_total, N_total], [0.0, 8.0])
    assert dim == 34650
    m.locate_E0_lanczos("full", nev=2, ncv=2)
    assert abs(m.eigenvals_full[0] - (-9.762087307)) < 1e-8
    # degenerate golden pair must be resolved on the mesh path too
    assert abs(m.eigenvals_full[1] - (-9.762087307)) < 1e-8
