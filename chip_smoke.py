"""Drive the exact-diagonalization main path once on the GPU and check it.

Usage:
    python chip_smoke.py             # one card: the four phases below
    python chip_smoke.py --cards 4   # four cards: the mesh path only

Phases (one card), each through the public API at the sizes users solve:

1. ``kagome24_full``: 24-site kagome Heisenberg, full Sz=0 sector
   (dim 2,704,156), solved pure f64 and mixed (f32 bulk + f64 polish); both
   E0s against the recorded value, the exact-f64 residual against the
   solver's gate, <phi|H|phi> from ``measure_full_static``.
2. ``hubbard4x4_apply``: factorized Fermi-Hubbard 4x4 (dim 165,636,900);
   dense f64 and dense f32 applies against the ELL-gather f64 reference on
   one random vector, then the 4x2 golden E0 mixed and pure f64.
3. ``momentum_sectors``: kagome t-J 2x2 k=(0,0) golden (mixed precision),
   and a tilted-cluster sector on the explicit-ELL route against the dense
   eigensolver.
4. ``kpm``: 64 KPM moments of a kagome-24 momentum transfer on the
   projected full-space engine against the sector-dimension ELL, and the
   zeroth moment against the sum rule <phi|A^dag A|phi>.

With ``--cards 4``: a 4-device mesh (all to all, no torus shape), the
kagome-24 full-sector E0 on the mesh against the single-card value, one
``KronSharded`` Hubbard 4x4 f64 apply against the single-device apply, and
one halo-ELL apply against the unsharded ELL apply.

One line per phase: name, wall seconds, the compared numbers and their
tolerances. The first line is the card (``nvidia-smi``), the JAX version
and the device kind; the last line is one JSON object. A phase that fails
raises, and the script exits nonzero without that line. It refuses to run
anywhere but on a GPU.

The phase functions take their sizes, so tests can run them on the CPU at
small golden sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Recorded physics (BASELINE.md): kagome-24 full Sz=0 ground state, two
# independent algorithms; reference goldens for the small models.
E0_KAGOME24 = -10.759897248084128
E0_KAGOME12 = -5.444875217
E0_HUBBARD4X2 = -14.07605866
E0_KAGOME_TJ_K00 = -15.41931496


class CheckFailed(AssertionError):
    pass


class Checks:
    """Compared numbers of one phase, printed on its line."""

    def __init__(self):
        self.items: list[str] = []

    def close(self, name, got, want, tol):
        err = abs(got - want)
        self.items.append(f"{name}={got:.15g} ref={want:.15g} "
                          f"err={err:.3e} tol={tol:.0e}")
        if not err <= tol:
            raise CheckFailed(f"{name}: {got!r} vs {want!r}, "
                              f"|diff| {err:.3e} > {tol:.0e}")

    def below(self, name, got, limit):
        self.items.append(f"{name}={got:.3e} limit={limit:.3e}")
        if not got <= limit:
            raise CheckFailed(f"{name}: {got:.3e} > {limit:.3e}")

    def note(self, name, value):
        self.items.append(f"{name}={value}")


@contextlib.contextmanager
def _config(**settings):
    """Set package config knobs for one block, then restore them."""
    from quantum_basis_tpu import config

    old = {k: getattr(config, k) for k in settings}
    for k, v in settings.items():
        setattr(config, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(config, k, v)


def _import_path():
    for d in (ROOT, os.path.join(ROOT, "benchmarks")):
        if d not in sys.path:
            sys.path.insert(0, d)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def _residual(matvec, vec, e0):
    """||H v - e0 v|| / ||v|| with an exact-f64 engine."""
    from quantum_basis_tpu.ops import cplx as cx

    hv = matvec(vec)
    return float(cx.norm(cx.axpy(-e0, vec, hv)) / cx.norm(vec))


# ---------------------------------------------------------------- phases


def kagome_full(ck, lx=2, ly=4, e0_ref=E0_KAGOME24, tol=1e-10):
    """Full Sz=0 sector: pure f64, then mixed, on one model."""
    _import_path()
    from flagship_kagome24 import build

    from quantum_basis_tpu.config import residual_gate

    m, sz = build(lx, ly)
    ck.note("dim", m.enumerate_basis_full([sz], [0.0]))
    sector = m.sec_full[0]
    for tag, mixed in (("f64", False), ("mixed", True)):
        with _config(mixed_precision=mixed):
            t0 = time.time()
            m.locate_E0_lanczos(nev=1, ncv=1)
        e0 = float(m.eigenvals_full[0])
        ck.note(f"solve_{tag}_s", f"{time.time() - t0:.1f}")
        ck.close(f"E0_{tag}", e0, e0_ref, tol)
        # residual on the matrix-free sector engine, not the solver's own
        ck.below(f"residual_{tag}", _residual(sector.matvec,
                                              sector.evecs[0], e0),
                 residual_gate(e0))
    e_static = m.measure_full_static(m.Ham, 0).real
    ck.close("phiHphi", e_static, e0, 1e-9)
    ck.note("peak_bytes_in_use", _peak_bytes())


def hubbard(ck, apply_size=(4, 4), solve_size=(4, 2), e0_solve=E0_HUBBARD4X2,
            seed=0):
    """Factorized Hubbard: dense vs ELL applies, then the golden solve."""
    import jax
    import jax.numpy as jnp

    _import_path()
    from examples.square_fermi_hubbard import build_factorized

    pm, _ = build_factorized(*apply_size)
    ck.note("dim", pm.dim)
    x = jax.random.normal(jax.random.PRNGKey(seed), (pm.dim,), jnp.float64)
    y_ref = pm.op(jnp.float64, layout="ell")((x, None))[0]
    y64 = pm.op(jnp.float64, layout="dense")((x, None))[0]
    ck.below("rel_dense64_vs_ell64", _rel(y64, y_ref), 1e-12)
    del y64
    y32 = pm.op(jnp.float32, layout="dense")((x.astype(jnp.float32), None))[0]
    ck.below("rel_dense32_vs_ell64", _rel(y32, y_ref), 1e-5)
    del y32, y_ref, x, pm

    pm, _ = build_factorized(*solve_size)
    for tag, mixed in (("mixed", True), ("f64", False)):
        e0 = pm.locate_E0_lanczos(mixed=mixed, ncv=16, log=lambda *a: None)
        ck.close(f"E0_{solve_size[0]}x{solve_size[1]}_{tag}", e0, e0_solve,
                 1e-8)


def tilted_square(a, b):
    """Tilted square cluster with superlattice A = [[a, b], [-b, a]]
    (a^2 + b^2 sites, cyclic translation group when gcd(a, b) = 1)."""
    from quantum_basis_tpu.lattice.tilted import TiltedLattice

    A = np.asarray([[a, b], [-b, a]])
    n = a * a + b * b
    Ainv = np.linalg.inv(A.astype(float))
    seen, sites = set(), []
    r = a + b
    for x in range(-r, r + 1):
        for y in range(-r, r + 1):
            M = np.floor(np.asarray([x, y]) @ Ainv + 1e-12).astype(int)
            c0 = tuple(np.asarray([x, y]) - M @ A)
            if c0 not in seen:
                seen.add(c0)
                sites.append(([x, y], 0))
    if len(sites) != n:
        raise ValueError("coset enumeration missed sites")
    return TiltedLattice(2, 1, np.eye(2), A, [[0.0, 0.0]], sites)


def _tilted_heisenberg(lat):
    from flagship_kagome24 import SZ, heis_bond

    from quantum_basis_tpu import Model, Mopr, Opr

    m = Model(lat)
    m.add_orbital(lat.n_sites, "spin-1/2")
    bonds = set()
    for s in range(lat.n_sites):
        coor, sub = lat.site2coor(s)
        for d in ((1, 0), (0, 1)):
            j = lat.coor2site([coor[0] + d[0], coor[1] + d[1]], sub)
            bonds.add((min(s, j), max(s, j)))
    for i, j in sorted(bonds):
        heis_bond(m, i, j)
    sz = Mopr()
    for s in range(lat.n_sites):
        sz += Opr(s, 0, False, SZ)
    return m, sz


def momentum(ck, tj_size=(2, 2), n_elec=8, e0_tj=E0_KAGOME_TJ_K00,
             tilted=(4, 1)):
    """Momentum sectors: golden t-J sector (mixed precision) and one
    tilted-cluster sector on the explicit-ELL route vs dense eigvalsh."""
    _import_path()
    from examples.kagome_heisenberg_tj import build_tj

    mt, n_op, sz_op = build_tj(*tj_size)
    ck.note("tJ_dim", mt.enumerate_basis_repr([0, 0], [n_op, sz_op],
                                              [float(n_elec), 0.0]))
    ck.note("tJ_route", "projected" if mt._fullspace_repr_op(
        mt.sec_repr[0]) is not None else "ell")
    with _config(mixed_precision=True):
        mt.locate_E0_lanczos(which="repr")
    ck.close("E0_tJ_k00", float(mt.eigenvals_repr[0]), e0_tj, 1e-8)

    lat = tilted_square(*tilted)
    m, sz = _tilted_heisenberg(lat)
    n = lat.n_sites
    ck.note("tilted_dim", m.enumerate_basis_repr([0, 0], [sz],
                                                 [0.5 * (n % 2)]))
    sector = m.sec_repr[0]
    if m._fullspace_repr_op(sector) is not None:
        raise CheckFailed("tilted cluster left the explicit-ELL route")
    m.locate_E0_lanczos(which="repr")
    ell = m._repr_ell(sector)
    dim = sector.dim
    H = np.zeros((dim, dim), dtype=np.complex128)
    rows = np.repeat(np.arange(dim), ell.width)
    vals = np.asarray(ell.vre).reshape(-1) + 1j * (
        np.asarray(ell.vim).reshape(-1) if ell.vim is not None else 0.0)
    np.add.at(H, (rows, np.asarray(ell.cols).reshape(-1)), vals)
    H[np.arange(dim), np.arange(dim)] += np.asarray(ell.diag)
    ck.close("E0_tilted_vs_eigvalsh", float(m.eigenvals_repr[0]),
             float(np.linalg.eigvalsh(H)[0]), 1e-10)


def sz_q(lat, q, L):
    """Sz(q) = (1/sqrt(N)) sum_r e^{-i q.r} Sz_r, cell-coordinate phases."""
    from quantum_basis_tpu import Mopr, Opr
    from flagship_kagome24 import SZ

    out = Mopr()
    n = lat.n_sites
    for s in range(n):
        coor, _ = lat.site2coor(s)
        ph = np.exp(-2j * np.pi * sum(q[d] * coor[d] / L[d]
                                      for d in range(2)))
        out += (ph / np.sqrt(n)) * Opr(s, 0, False, SZ)
    return out


def kpm(ck, lx=2, ly=4, k0=(0, 2), q=(1, 0), n_moments=64,
        e0_ref=E0_KAGOME24):
    """KPM moments of Sz(q)|phi_k0> on the projected full-space engine vs
    the sector-dimension ELL; mu_0 against the sum rule."""
    _import_path()
    from flagship_kagome24 import build

    m, sz = build(lx, ly)
    L = (lx, ly)
    ck.note("dim_k0", m.enumerate_basis_repr(list(k0), [sz], [0.0], sec=0))
    m.locate_E0_lanczos(which="repr", sec=0)
    if e0_ref is not None:
        ck.close("E0_k0", float(m.eigenvals_repr[0]), e0_ref, 1e-10)
    kt = [(k0[d] - q[d]) % L[d] for d in range(2)]
    ck.note("dim_target", m.enumerate_basis_repr(kt, [sz], [0.0], sec=1))
    A = sz_q(m.lattice, q, L)
    # |H| <= 3/4 per bond, two bonds per kagome site
    bounds = (-1.5 * m.lattice.n_sites, 1.5 * m.lattice.n_sites)
    full_n = int(m.space.label_space)
    with _config(kpm_fullspace_max_N=full_n):
        if m._fullspace_repr_op(m.sec_repr[1]) is None:
            raise CheckFailed("projected full-space KPM path unavailable")
        t0 = time.time()
        nrm_fs, mu_fs, _, _ = m.measure_repr_dynamic_kpm(
            A, 0, 1, n_moments, bounds=bounds)
        ck.note("fullspace_s", f"{time.time() - t0:.1f}")
    with _config(kpm_fullspace_max_N=0):
        t0 = time.time()
        nrm_ell, mu_ell, _, _ = m.measure_repr_dynamic_kpm(
            A, 0, 1, n_moments, bounds=bounds)
        ck.note("ell_s", f"{time.time() - t0:.1f}")
    ck.close("norm_fs_vs_ell", nrm_fs, nrm_ell, 1e-10)
    ck.below("max_mu_diff", float(np.max(np.abs(mu_fs - mu_ell))), 1e-8)
    weight = m.measure_repr_static(A.dagger() * A, 0).real
    ck.close("mu0_times_norm2", float(mu_fs[0]) * nrm_fs ** 2, weight,
             1e-10)


def cards(ck, n_cards=4, lx=2, ly=4, e0_ref=E0_KAGOME24, tol=1e-10,
          hub=(4, 4), seed=0):
    """The mesh path: sharded E0, KronSharded and halo-ELL applies."""
    import jax
    import jax.numpy as jnp

    _import_path()
    from examples.square_fermi_hubbard import build_factorized
    from flagship_kagome24 import build

    from quantum_basis_tpu.parallel import EllShardedHalo, basis_mesh

    mesh = basis_mesh(n_cards)

    def spread(name, arr):
        devs = {s.device for s in arr.addressable_shards
                if s.data.size > 0}
        ck.note(f"{name}_devices", len(devs))
        if len(devs) != n_cards:
            raise CheckFailed(f"{name} lives on {len(devs)} devices, "
                              f"want {n_cards}")

    m, sz = build(lx, ly)
    m.set_mesh(mesh)
    m.enumerate_basis_full([sz], [0.0])
    m.locate_E0_lanczos(nev=1, ncv=1)
    sector = m.sec_full[0]
    mv = sector._mesh_mv[1]
    ck.note("mesh_engine", type(mv).__name__)
    ck.close("E0_mesh", float(m.eigenvals_full[0]), e0_ref, tol)

    ell = sector._ell
    halo = EllShardedHalo(ell, mesh)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(ell.n)
    y_halo = halo(halo.pad((x, None)))[0]
    spread("halo_out", y_halo)
    y_ref = ell((jnp.asarray(x), None))[0]
    ck.below("rel_halo_vs_ell", _rel(halo.unpad((y_halo, None))[0], y_ref),
             1e-12)
    del m, sector, mv, ell, halo, y_halo, y_ref

    pm, _ = build_factorized(*hub)
    x = rng.standard_normal(pm.dim)
    y1 = pm.op(jnp.float64)((jnp.asarray(x), None))[0]
    pm.set_mesh(mesh)
    kop = pm.op(jnp.float64)
    ym = kop(kop.pad((x, None)))[0]
    spread("kron_out", ym)
    ck.below("rel_kron_sharded_vs_single",
             _rel(kop.unpad((ym, None))[0], y1), 1e-12)
    jax.block_until_ready(ym)


ONE_CARD = (
    ("kagome24_full", kagome_full),
    ("hubbard4x4_apply", hubbard),
    ("momentum_sectors", momentum),
    ("kpm", kpm),
)


def _card_line():
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return (f"{'; '.join(smi.splitlines())} | jax {jax.__version__} | "
            f"device_kind {jax.devices()[0].device_kind}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the mesh path on four cards")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    if len(devs) < args.cards:
        print(f"chip_smoke: needs {args.cards} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import quantum_basis_tpu
    from quantum_basis_tpu import initialize

    if not os.path.abspath(quantum_basis_tpu.__file__).startswith(ROOT):
        print("chip_smoke: the package beside this script is missing",
              file=sys.stderr)
        return 2
    initialize(quiet=True)
    print(_card_line(), flush=True)

    phases = (ONE_CARD if args.cards == 1
              else (("cards4", lambda ck: cards(ck, n_cards=args.cards)),))
    for name, fn in phases:
        ck = Checks()
        t0 = time.time()
        fn(ck)
        print(f"{name} wall_s={time.time() - t0:.1f} "
              + " ; ".join(ck.items), flush=True)

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
