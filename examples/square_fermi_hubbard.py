"""Square-lattice Fermi-Hubbard model at half filling (4x2).

Python driver mirroring the reference examples
examples/trans_absent/latt_square/square_Fermi_Hubbard.cc (full sector:
E0 and the <c†_up,1 c_up,5> correlator) and
examples/trans_symmetric/latt_square/square_Fermi_Hubbard.cc (all 8
momentum sectors).

Run:  python examples/square_fermi_hubbard.py
"""

from __future__ import annotations

import os
import sys

try:
    import quantum_basis_tpu  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from quantum_basis_tpu import Lattice, Model, Mopr, Opr

C_UP = np.array([[0, 1, 0, 0], [0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 0.0]])
C_DN = np.array([[0, 0, 1, 0], [0, 0, 0, -1], [0, 0, 0, 0], [0, 0, 0, 0.0]])


def build(Lx, Ly, t=1.0, U=1.1):
    lat = Lattice("square", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat)
    m.add_orbital(lat.n_sites, "electron")
    Nup, Ndn = Mopr(), Mopr()
    for x in range(Lx):
        for y in range(Ly):
            i = lat.coor2site([x, y], 0)
            cu, cd = Opr(i, 0, True, C_UP), Opr(i, 0, True, C_DN)
            for dx, dy in ((1, 0), (0, 1)):
                j = lat.coor2site([x + dx, y + dy], 0)
                cu_j, cd_j = Opr(j, 0, True, C_UP), Opr(j, 0, True, C_DN)
                m.add_Ham((-t) * (cu.dagger() * cu_j))
                m.add_Ham((-t) * (cu_j.dagger() * cu))
                m.add_Ham((-t) * (cd.dagger() * cd_j))
                m.add_Ham((-t) * (cd_j.dagger() * cd))
            m.add_Ham(U * ((cu.dagger() * cu) * (cd.dagger() * cd)))
            Nup += cu.dagger() * cu
            Ndn += cd.dagger() * cd
    return m, lat, Nup, Ndn


C1 = np.array([[0.0, 1.0], [0.0, 0.0]])  # spinless annihilation
N1 = np.array([0.0, 1.0])                # spinless occupation (diagonal)


def build_factorized_sector(Lx, Ly, Nup, Ndn, t=1.0, U=1.1):
    """Factorized Hubbard in an arbitrary (N_up, N_dn) sector: two factor
    Models over the same spinless space with independent particle numbers
    (spin/charge-gap sectors of BASELINE config #3)."""
    from quantum_basis_tpu.models.product import ProductModel
    from quantum_basis_tpu.ops.operators import OprProd

    def factor(Nf):
        lat = Lattice("square", [Lx, Ly], ["pbc", "pbc"])
        ms = Model(lat)
        ms.add_orbital(lat.n_sites, "spinless-fermion")
        Nop = Mopr()
        for x in range(Lx):
            for y in range(Ly):
                i = lat.coor2site([x, y], 0)
                ci = Opr(i, 0, True, C1)
                for dx, dy in ((1, 0), (0, 1)):
                    j = lat.coor2site([x + dx, y + dy], 0)
                    cj = Opr(j, 0, True, C1)
                    ms.add_Ham((-t) * (ci.dagger() * cj))
                    ms.add_Ham((-t) * (cj.dagger() * ci))
                Nop += ci.dagger() * ci
        ms.enumerate_basis_full([Nop], [float(Nf)])
        return ms, lat

    mu, lat = factor(Nup)
    md, _ = factor(Ndn)
    pairs = []
    for s in range(lat.n_sites):
        n_s = Mopr([OprProd(1.0, [Opr(s, 0, False, N1)])])
        pairs.append((n_s, n_s))
    return ProductModel(mu, md, coupling=pairs, coupling_scale=U)


def build_factorized(Lx, Ly, t=1.0, U=1.1, Nf=None):
    """Species-factorized Hubbard (the dense-matmul formulation).

    In the species-major Jordan-Wigner ordering the up and down species
    decouple into two copies of a SPINLESS-fermion hopping factor on the
    same lattice, coupled only by the diagonal U sum_i n_i^up (x) n_i^dn.
    Eigenvalues are ordering-independent, so this cross-checks against the
    site-major 'electron' encoding of :func:`build` at 1e-8
    (reference golden: trans_absent square_Fermi_Hubbard.cc:113).

    Returns (ProductModel, factor Model); the factor sector is N = Nf
    fermions (default half filling).
    """
    from quantum_basis_tpu.models.product import ProductModel
    from quantum_basis_tpu.ops.operators import OprProd

    lat = Lattice("square", [Lx, Ly], ["pbc", "pbc"])
    ms = Model(lat)
    ms.add_orbital(lat.n_sites, "spinless-fermion")
    Nop = Mopr()
    for x in range(Lx):
        for y in range(Ly):
            i = lat.coor2site([x, y], 0)
            ci = Opr(i, 0, True, C1)
            for dx, dy in ((1, 0), (0, 1)):
                j = lat.coor2site([x + dx, y + dy], 0)
                cj = Opr(j, 0, True, C1)
                ms.add_Ham((-t) * (ci.dagger() * cj))
                ms.add_Ham((-t) * (cj.dagger() * ci))
            Nop += ci.dagger() * ci
    if Nf is None:
        Nf = lat.n_sites // 2
    ms.enumerate_basis_full([Nop], [float(Nf)])
    pairs = []
    for s in range(lat.n_sites):
        n_s = Mopr([OprProd(1.0, [Opr(s, 0, False, N1)])])
        pairs.append((n_s, n_s))
    return ProductModel(ms, None, coupling=pairs, coupling_scale=U), ms


def main():
    # full sector (trans_absent square_Fermi_Hubbard.cc:113,122)
    m, lat, Nup, Ndn = build(4, 2)
    dim = m.enumerate_basis_full([Nup, Ndn], [4.0, 4.0])
    print(f"4x2, 4up 4dn sector dim = {dim}")
    m.locate_E0_lanczos(nev=1, ncv=1)
    E0 = m.eigenvals_full[0]
    print(f"E0(full) = {E0:.9f}")
    assert abs(E0 - (-14.07605866)) < 1e-8
    hop = m.measure_full_static(
        Opr(1, 0, True, C_UP).dagger() * Opr(5, 0, True, C_UP), 0, 0)
    print(f"<c†_up,1 c_up,5> = {hop.real:+.10f}")
    assert abs(hop.real - 0.3957690742) < 1e-8

    # all 8 momentum sectors (trans_symmetric …cc:126-133)
    mk, latk, Nupk, Ndnk = build(4, 2)
    golden = {(0, 0): -14.07605866, (1, 0): -10.50470669,
              (2, 0): -12.16861094, (3, 0): -12.19847764,
              (0, 1): -10.54300366, (1, 1): -14.03137587,
              (2, 1): -12.16861094, (3, 1): -12.19847764}
    for (kx, ky), e_ref in golden.items():
        mk.enumerate_basis_repr([kx, ky], [Nupk, Ndnk], [4.0, 4.0])
        mk.locate_E0_lanczos(which="repr")
        e0k = mk.eigenvals_repr[0]
        print(f"E0(k=({kx},{ky})) = {e0k:.9f}")
        assert abs(e0k - e_ref) < 1e-8, ((kx, ky), e0k)
    print("All checks passed.")


if __name__ == "__main__":
    main()
