"""chip_smoke.py: every phase at small golden sizes on the CPU, the mesh
phase on four virtual devices, and its refusal to run without a GPU."""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def test_kagome_full_phase_golden_12_sites():
    ck = cs.Checks()
    cs.kagome_full(ck, lx=2, ly=2, e0_ref=cs.E0_KAGOME12, tol=1e-8)
    assert any(i.startswith("E0_mixed=") for i in ck.items)


def test_hubbard_phase_golden_4x2():
    ck = cs.Checks()
    cs.hubbard(ck, apply_size=(4, 2), solve_size=(4, 2))
    assert any(i.startswith("rel_dense32_vs_ell64=") for i in ck.items)


def test_momentum_phase_tj_golden_and_tilted_ell_route(monkeypatch):
    # the t-J sector's projected full-space solve takes minutes on the CPU;
    # here it runs on the explicit-ELL route (the chip run takes the
    # routed default)
    from quantum_basis_tpu.models.model import Model

    monkeypatch.setattr(Model, "_fullspace_repr_op",
                        lambda self, sector, dtype=None: None)
    ck = cs.Checks()
    cs.momentum(ck)
    assert "tJ_route=ell" in ck.items
    assert "tilted_dim=1430" in ck.items


def test_kpm_phase_fullspace_moments_match_ell():
    ck = cs.Checks()
    cs.kpm(ck, lx=2, ly=2, k0=(0, 0), q=(1, 0), n_moments=24, e0_ref=None)
    assert any(i.startswith("max_mu_diff=") for i in ck.items)


def test_cards_phase_on_four_virtual_devices():
    ck = cs.Checks()
    cs.cards(ck, n_cards=4, lx=2, ly=2, e0_ref=cs.E0_KAGOME12, tol=1e-8,
             hub=(4, 2))
    assert "halo_out_devices=4" in ck.items
    assert "kron_out_devices=4" in ck.items


def test_tilted_square_cluster_is_complete():
    lat = cs.tilted_square(4, 1)
    assert lat.n_sites == 17
    disps, plans = lat.translation_group()
    assert len(disps) == 17


def test_refuses_to_run_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr
