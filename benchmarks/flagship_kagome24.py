"""North-star flagship: 24-site kagome Heisenberg antiferromagnet.

Spin-1/2 nearest-neighbor Heisenberg model on a 2x4-cell kagome lattice
(24 sites), Sz = 0 sector (dim C(24,12) = 2,704,156), solved two
independent ways on one device:

1. full sector: mixed-precision Krylov on the full-space engines
   (f32 window contractions -> f64 polish);
2. every momentum sector k in the 2x4 Brillouin zone grid via the
   momentum-filtered full-space path (ops/translate_fullspace.py).

Success criteria enforced by this artifact:
- sum_k dim(k) == dim(full)  (resolution of identity over sectors);
- min_k E0(k) == E0(full) to 1e-10  (two independent algorithms: the
  full-sector solve vs the momentum-projected sector solves).
The ground-state momentum is a RESULT, not an assumption — for this
cluster it sits at k=(0,2), so "E0(k=0) == E0(full)" is reported as
informational (checks.k0_matches_full_1e-10) but not gated on.

Writes FLAGSHIP_kagome24.json at the repo root and prints a summary table.
Scaled-up version of the reference's 12-site anchor
(examples/trans_absent/latt_kagome/kagome_Heisenberg_spin_half.cc:175).

Run:  python benchmarks/flagship_kagome24.py  [--lx 2 --ly 4]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from quantum_basis_tpu import Lattice, Model, Mopr, Opr, initialize

SZ = np.array([0.5, -0.5])
SP = np.array([[0.0, 1.0], [0.0, 0.0]])
SM = SP.T.copy()

# (sub_i, sub_j, cell displacement of j) — the kagome NN bond set of the
# reference examples (examples/*/latt_kagome/kagome_Heisenberg_spin_half.cc)
KAGOME_BONDS = [
    (0, 2, (1, 0)), (0, 2, (0, 0)),
    (1, 0, (0, 1)), (1, 0, (0, 0)),
    (2, 1, (-1, -1)), (2, 1, (0, 0)),
]


def heis_bond(m, i, j, J=1.0):
    m.add_Ham((0.5 * J) * (Opr(i, 0, False, SP) * Opr(j, 0, False, SM)
                           + Opr(i, 0, False, SM) * Opr(j, 0, False, SP)))
    m.add_Ham(J * (Opr(i, 0, False, SZ) * Opr(j, 0, False, SZ)))


def build(Lx, Ly):
    lat = Lattice("kagome", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat)
    m.add_orbital(lat.n_sites, "spin-1/2")
    for x in range(Lx):
        for y in range(Ly):
            for si, sj, (dx, dy) in KAGOME_BONDS:
                i = lat.coor2site([x, y], si)
                j = lat.coor2site([x + dx, y + dy], sj)
                heis_bond(m, i, j)
    Sz_tot = Mopr()
    for s in range(lat.n_sites):
        Sz_tot += Opr(s, 0, False, SZ)
    return m, Sz_tot


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lx", type=int, default=2)
    ap.add_argument("--ly", type=int, default=4)
    ap.add_argument("--out", default="FLAGSHIP_kagome24.json")
    ap.add_argument("--maxit", type=int, default=4000)
    args = ap.parse_args()

    import jax

    # checkpointing on: each sector's solve stage persists (out_Qckpt/), so
    # a killed/hung run resumes past completed sectors (cf. ckpt_lczsE0,
    # reference src/model.cc:2521-2749)
    initialize(quiet=True, mixed_precision=True, enable_checkpoint=True)
    from quantum_basis_tpu import config
    config.solver_log_dir = "out_logs"   # per-restart convergence lines
    t_all = time.time()

    # ---- full sector
    m, Sz = build(args.lx, args.ly)
    t0 = time.time()
    dim_full = m.enumerate_basis_full([Sz], [0.0])
    t_enum = time.time() - t0
    print(f"full Sz=0 sector dim = {dim_full}  (enumerate {t_enum:.1f}s)",
          flush=True)
    t0 = time.time()
    m.locate_E0_lanczos(nev=1, ncv=1, maxit=args.maxit)
    t_full = time.time() - t0
    E0_full = float(m.eigenvals_full[0])
    print(f"E0(full) = {E0_full:.12f}   [{t_full:.1f}s]", flush=True)
    with open(args.out + ".partial", "w") as f:
        json.dump({"workload": f"kagome_heisenberg_{args.lx}x{args.ly}_Sz0",
                   "status": "full sector done; momentum sectors pending",
                   "dim_full": int(dim_full), "E0_full": E0_full,
                   "e0_per_site": E0_full / (3 * args.lx * args.ly),
                   "timings_s": {"enumerate_full": round(t_enum, 1),
                                 "solve_full": round(t_full, 1)},
                   "backend": jax.devices()[0].platform}, f, indent=1)

    # ---- momentum sectors
    sectors = []
    mk, Szk = build(args.lx, args.ly)
    for kx in range(args.lx):
        for ky in range(args.ly):
            t0 = time.time()
            dim_k = mk.enumerate_basis_repr([kx, ky], [Szk], [0.0])
            t_enum_k = time.time() - t0
            sec = mk.sec_repr[0]
            fs = mk._fullspace_repr_op(sec)
            assert fs is not None, "projected full-space path must be active"
            t0 = time.time()
            mk.locate_E0_lanczos(which="repr", maxit=args.maxit)
            t_k = time.time() - t0
            e0k = float(mk.eigenvals_repr[0])
            sectors.append({"k": [kx, ky], "dim": int(dim_k), "E0": e0k,
                            "enum_s": round(t_enum_k, 1),
                            "solve_s": round(t_k, 1)})
            print(f"E0(k=({kx},{ky})) = {e0k:.12f}  dim {dim_k}  "
                  f"[enum {t_enum_k:.1f}s solve {t_k:.1f}s]", flush=True)
            # incremental partial: a preempted run still leaves evidence
            with open(args.out + ".partial", "w") as f:
                json.dump({
                    "workload":
                        f"kagome_heisenberg_{args.lx}x{args.ly}_Sz0",
                    "status": f"{len(sectors)}/{args.lx * args.ly} momentum "
                              "sectors done",
                    "dim_full": int(dim_full), "E0_full": E0_full,
                    "sectors": sectors,
                    "backend": jax.devices()[0].platform}, f, indent=1)

    # ---- checks. Hard criteria: the sector dims resolve the identity and
    # min_k E0 equals the full-sector E0 at 1e-10 (two independent
    # algorithms). The k=0 comparison is reported but only enforced when
    # the ground state actually lives at k=0 — for an asymmetric cluster
    # (2x4) the GS momentum is a RESULT, not an assumption.
    sum_dims = sum(s["dim"] for s in sectors)
    e0_min = min(s["E0"] for s in sectors)
    k_gs = min(sectors, key=lambda s: s["E0"])["k"]
    e0_k0 = next(s["E0"] for s in sectors if s["k"] == [0, 0])
    ok_dims = sum_dims == dim_full
    ok_min = abs(e0_min - E0_full) < 1e-10 * max(1.0, abs(E0_full))
    k0_match = abs(e0_k0 - E0_full) < 1e-10 * max(1.0, abs(E0_full))
    print(f"sum_k dim = {sum_dims} vs full {dim_full}: "
          f"{'OK' if ok_dims else 'MISMATCH'}")
    print(f"min_k E0 - E0(full) = {e0_min - E0_full:.3e} at k={k_gs}: "
          f"{'OK' if ok_min else 'MISMATCH'}")
    print(f"E0(k=0) - E0(full) = {e0_k0 - E0_full:.3e} "
          f"({'GS at k=0' if k0_match else 'GS at nonzero k'})")
    ok_k0 = k0_match or (k_gs != [0, 0] and ok_min)

    out = {
        "workload": f"kagome_heisenberg_{args.lx}x{args.ly}_Sz0",
        "n_sites": 3 * args.lx * args.ly,
        "dim_full": int(dim_full),
        "E0_full": E0_full,
        "e0_per_site": E0_full / (3 * args.lx * args.ly),
        "sectors": sectors,
        "checks": {"sum_dims": ok_dims,
                   "k0_matches_full_1e-10": k0_match,
                   "gs_momentum": k_gs,
                   "min_k_matches_full_1e-10": ok_min},
        "timings_s": {"enumerate_full": round(t_enum, 1),
                      "solve_full": round(t_full, 1),
                      "total": round(time.time() - t_all, 1)},
        "backend": jax.devices()[0].platform,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "sectors"}))
    if not (ok_dims and ok_k0 and ok_min):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
