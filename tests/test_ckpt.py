"""Checkpoint/restart: crash-consistency, corruption fallback, solver resume."""

import numpy as np
import pytest

from quantum_basis_tpu import config
from quantum_basis_tpu.utils.ckpt import CkptStore


def test_store_roundtrip(tmp_path):
    st = CkptStore(str(tmp_path))
    st.save("rec", {"a": np.arange(5), "x": 3.5, "n": 7})
    rec = st.load("rec")
    np.testing.assert_array_equal(rec["a"], np.arange(5))
    assert float(rec["x"]) == 3.5 and int(rec["n"]) == 7
    st.delete("rec")
    assert st.load("rec") is None


def test_store_corruption_returns_none(tmp_path):
    st = CkptStore(str(tmp_path))
    st.save("rec", {"a": np.arange(100)})
    path = st._path("rec")
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF  # flip a byte mid-file
    open(path, "wb").write(bytes(data))
    assert st.load("rec") is None  # CRC or zip validation rejects


def test_store_truncation_returns_none(tmp_path):
    st = CkptStore(str(tmp_path))
    st.save("rec", {"a": np.arange(1000)})
    path = st._path("rec")
    data = open(path, "rb").read()
    open(path, "wb").write(data[: len(data) // 2])
    assert st.load("rec") is None


def test_thick_restart_resume(tmp_path, monkeypatch):
    """Interrupt eigs_smallest via maxit, resume from checkpoint, verify
    the resumed run completes and matches the dense eigenvalue."""
    monkeypatch.setattr(config, "enable_ckpt", True)
    monkeypatch.setattr(config, "ckpt_dir", str(tmp_path))

    from quantum_basis_tpu.solvers.restarted import eigs_smallest
    from test_solvers import _chain_setup

    mv, Hd, n = _chain_setup(10)  # dim 252
    evals = np.linalg.eigvalsh(Hd)

    # force an "interruption": too-few iterations to converge
    with pytest.raises(RuntimeError):
        eigs_smallest(mv, n, nev=2, ncv=8, maxit=9, ckpt_key="resume_test")
    files = list(tmp_path.iterdir())
    assert files, "no checkpoint written before the crash"

    # resume: loads the restart state and converges
    got, vecs = eigs_smallest(mv, n, nev=2, ncv=8, maxit=600,
                              ckpt_key="resume_test")
    np.testing.assert_allclose(got, evals[:2], atol=1e-9)
    # completed run cleans its checkpoint
    assert CkptStore(str(tmp_path)).load("resume_test") is None


def test_model_stage_checkpoint(tmp_path, monkeypatch):
    """Stage-level record: second locate_E0_lanczos call loads the stored
    eigenpair without re-running the solver."""
    monkeypatch.setattr(config, "enable_ckpt", True)
    monkeypatch.setattr(config, "ckpt_dir", str(tmp_path))

    from models_zoo import heisenberg_chain

    m, ops = heisenberg_chain(12)
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    m.locate_E0_lanczos("full", nev=1, ncv=1)
    E0_first = m.eigenvals_full[0]
    skey = f"lczsE0_full_sec0_nev1_h{m._ham_fingerprint():08x}"
    assert CkptStore(str(tmp_path)).load(skey) is not None

    # poison the solver: a second real run would crash; the stage record
    # must short-circuit it
    import quantum_basis_tpu.solvers.restarted as restarted

    def boom(*a, **k):
        raise AssertionError("solver re-ran despite stage checkpoint")

    monkeypatch.setattr(restarted, "eigs_smallest", boom)
    m2, ops2 = heisenberg_chain(12)
    m2.enumerate_basis_full([ops2["Sz"]], [0.0])
    m2.locate_E0_lanczos("full", nev=1, ncv=1)
    assert m2.eigenvals_full[0] == E0_first

def test_cg_resume(tmp_path, monkeypatch):
    """eigenvec_cg: interrupt via maxit, resume from the saved iterate."""
    monkeypatch.setattr(config, "enable_ckpt", True)
    monkeypatch.setattr(config, "ckpt_dir", str(tmp_path))

    from quantum_basis_tpu.solvers.cg import eigenvec_cg
    from quantum_basis_tpu.utils.rng import vec_randomize
    from test_solvers import _chain_setup

    mv, Hd, n = _chain_setup(10)
    w, V = np.linalg.eigh(Hd)
    E0 = float(w[0])
    import jax.numpy as jnp

    re, _ = vec_randomize(n, seed=3)
    # bias the start toward the eigenvector so CG (a refiner) converges
    v0 = 0.2 * re / np.linalg.norm(re) + V[:, 0]
    v0 = (jnp.asarray(v0 / np.linalg.norm(v0)), None)

    # interrupted run: checkpoint every 5 iters, stop at 12
    v_mid, res_mid, m_mid = eigenvec_cg(mv, E0, v0, maxit=12, tol=1e-11,
                                        ckpt_key="cg_test", ckpt_every=5)
    assert res_mid > 1e-11  # genuinely unconverged
    rec = CkptStore(str(tmp_path)).load("cg_test")
    assert rec is not None and int(rec["m"]) >= 5

    # resume: continues from the saved iterate and converges
    v, res, m_total = eigenvec_cg(mv, E0, v0, maxit=3000, tol=1e-11,
                                  ckpt_key="cg_test", ckpt_every=500)
    assert res < 1e-9
    overlap = abs(np.vdot(np.asarray(v[0]), V[:, 0]))
    assert overlap > 1.0 - 1e-8
    assert m_total > int(rec["m"])  # the count carried over
    assert CkptStore(str(tmp_path)).load("cg_test") is None  # cleaned up


def test_lanczos_dynamics_resume(tmp_path, monkeypatch):
    """Dynamics a/b recording: crash after a mid-run checkpoint, resume,
    coefficients identical to an uninterrupted run."""
    monkeypatch.setattr(config, "enable_ckpt", True)
    monkeypatch.setattr(config, "ckpt_dir", str(tmp_path))

    import jax.numpy as jnp

    import quantum_basis_tpu.utils.ckpt as ckpt_mod
    from quantum_basis_tpu.solvers.lanczos import lanczos_dynamics
    from quantum_basis_tpu.utils.rng import vec_randomize
    from test_solvers import _chain_setup

    mv, Hd, n = _chain_setup(10)
    re, _ = vec_randomize(n, seed=7)
    v0 = (jnp.asarray(re / np.linalg.norm(re)), None)

    a_ref, b_ref = lanczos_dynamics(mv, v0, 24)

    class CrashingStore(CkptStore):
        saves = 0

        def save(self, key, payload):
            super().save(key, payload)
            CrashingStore.saves += 1
            if CrashingStore.saves == 2:
                raise RuntimeError("simulated crash after checkpoint")

    monkeypatch.setattr(ckpt_mod, "active_store",
                        lambda: CrashingStore(str(tmp_path)))
    with pytest.raises(RuntimeError, match="simulated crash"):
        lanczos_dynamics(mv, v0, 24, ckpt_key="dyn_test", ckpt_chunk=8)
    rec = CkptStore(str(tmp_path)).load("dyn_test")
    assert rec is not None and int(rec["k"]) == 16

    monkeypatch.setattr(ckpt_mod, "active_store",
                        lambda: CkptStore(str(tmp_path)))
    a, b = lanczos_dynamics(mv, v0, 24, ckpt_key="dyn_test", ckpt_chunk=8)
    np.testing.assert_allclose(a, a_ref, atol=1e-9)
    np.testing.assert_allclose(b, b_ref, atol=1e-9)
    assert CkptStore(str(tmp_path)).load("dyn_test") is None


def test_stage_key_carries_ham_fingerprint(tmp_path, monkeypatch):
    """Changing one coupling must invalidate the stage record: model B run
    in a cwd holding model A's out_Qckpt/ (same sector dim) must NOT be
    handed A's eigenvalues."""
    monkeypatch.setattr(config, "enable_ckpt", True)
    monkeypatch.setattr(config, "ckpt_dir", str(tmp_path))

    from models_zoo import heisenberg_chain

    m, ops = heisenberg_chain(12)
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    m.locate_E0_lanczos("full", nev=1, ncv=1)
    E0_a = m.eigenvals_full[0]

    # model B: same lattice/sector dim, one coupling changed
    from quantum_basis_tpu import Opr

    m2, ops2 = heisenberg_chain(12)
    SZ = np.array([0.5, -0.5])
    m2.add_Ham(0.37 * (Opr(0, 0, False, SZ) * Opr(1, 0, False, SZ)))
    assert m2._ham_fingerprint() != m._ham_fingerprint()
    m2.enumerate_basis_full([ops2["Sz"]], [0.0])
    m2.locate_E0_lanczos("full", nev=1, ncv=1)
    assert m2.eigenvals_full[0] != E0_a  # solved fresh, not A's record
