"""Spin-1/2 Heisenberg chain: full sector, momentum sectors, correlators.

Python driver mirroring the reference example
examples/trans_symmetric/latt_chain/chain_Heisenberg_spin_half.cc —
the same physics checks, through the JAX API.

Run:  python examples/chain_heisenberg_spin_half.py [L]
"""

from __future__ import annotations

import os
import sys

try:  # installed package preferred; fall back to the repo tree
    import quantum_basis_tpu  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np

from quantum_basis_tpu import Lattice, Model, Mopr, Opr

SZ = np.array([0.5, -0.5])
SP = np.array([[0.0, 1.0], [0.0, 0.0]])
SM = np.array([[0.0, 0.0], [1.0, 0.0]])


def build(L):
    lat = Lattice("chain", [L], ["pbc"])
    m = Model(lat)
    m.add_orbital(L, "spin-1/2")
    Sz_tot = Mopr()
    for x in range(L):
        j = (x + 1) % L
        m.add_Ham(0.5 * (Opr(x, 0, False, SP) * Opr(j, 0, False, SM)
                         + Opr(x, 0, False, SM) * Opr(j, 0, False, SP)))
        m.add_Ham(Opr(x, 0, False, SZ) * Opr(j, 0, False, SZ))
        Sz_tot += Opr(x, 0, False, SZ)
    return m, Sz_tot


def main(L=16):
    m, Sz_tot = build(L)
    dim = m.enumerate_basis_full([Sz_tot], [0.0])
    print(f"L={L}  Sz=0 sector dim = {dim}")
    m.locate_E0_lanczos(nev=2, ncv=2)
    E0 = m.eigenvals_full[0]
    print(f"E0 = {E0:.9f}   E1 = {m.eigenvals_full[1]:.9f}")
    if L == 16:
        assert abs(E0 - (-7.142296361)) < 1e-8  # src/main_test.cc:88

    # static correlators (src/main_test.cc:106-108)
    def szsz(i, j):
        return m.measure_full_static(
            Opr(i, 0, False, SZ) * Opr(j, 0, False, SZ), 0, 0).real

    print(f"<Sz0 Sz1> = {szsz(0, 1):+.10f}")
    print(f"<Sz0 Sz2> = {szsz(0, 2):+.10f}")
    if L == 16:
        assert abs(szsz(0, 1) - (-0.1487978408)) < 1e-8
        assert abs(szsz(0, 2) - (+0.0617414604)) < 1e-8

    # momentum sectors: E0(k)
    mk, Sz_tot_k = build(L)
    for k in range(L):
        mk.enumerate_basis_repr([k], [Sz_tot_k], [0.0])
        mk.locate_E0_lanczos(which="repr")
        print(f"E0(k={k:2d}) = {mk.eigenvals_repr[0]:.9f} "
              f"(dim {mk.dim_repr(0)})")
        if L == 16 and k == 0:
            assert abs(mk.eigenvals_repr[0] - E0) < 1e-8
    print("All checks passed.")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
