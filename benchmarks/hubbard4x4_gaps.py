"""Spin and charge gaps of the 4x4 half-filled Hubbard cluster (config #3).

BASELINE config #3 reads "Fermi-Hubbard 4x4 half filling, charge+spin
sectors": beyond the (8,8) ground state (HUBBARD4x4.json), this driver
converges E0 in the neighboring (N_up, N_dn) sectors — each a 1.3-1.5e8-
dim factorized solve with the full mixed-precision pipeline and hard
residual gate — and publishes

    spin gap    Delta_s = E0(9,7) - E0(8,8)
    charge gap  Delta_c = E0(9,8) + E0(8,7) - 2 E0(8,8)

(the S_z=1 spin excitation and the particle/hole addition energies of the
finite cluster). Checkpointed/resumable per sector; writes
HUBBARD4x4_GAPS.json.

Run (real chip):  python benchmarks/hubbard4x4_gaps.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--maxit", type=int, default=4000)
    ap.add_argument("--ncv", type=int, default=6)
    ap.add_argument("--out", default="HUBBARD4x4_GAPS.json")
    ap.add_argument("--reuse-e88", action="store_true",
                    help="take the converged, residual-gated E0(8,8) from "
                         "HUBBARD4x4.json instead of re-solving it "
                         "(recorded as source='HUBBARD4x4.json' in the "
                         "artifact)")
    args = ap.parse_args()

    import jax

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    from square_fermi_hubbard import build_factorized_sector

    from quantum_basis_tpu import config, initialize

    initialize(enable_checkpoint=True, quiet=True)
    config.solver_log_dir = "out_logs"
    config.ckpt_max_bytes = 2 << 30
    backend = jax.devices()[0].platform
    print(f"backend: {backend}", flush=True)

    sectors = {}
    t_all = time.time()
    todo = [(8, 8), (9, 7), (9, 8), (8, 7)]
    if args.reuse_e88:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        with open(os.path.join(root, "HUBBARD4x4.json")) as f:
            h44 = json.load(f)
        assert h44["status"] == "converged" and h44["gate_passed"]
        sectors["8,8"] = {
            "Nup": 8, "Ndn": 8, "dim": h44["dim"], "E0": h44["E0"],
            "residual_f64": h44["residual_f64"],
            "source": "HUBBARD4x4.json"}
        print(f"E0(8,8) = {h44['E0']:.12f}  [reused HUBBARD4x4.json, "
              f"residual {h44['residual_f64']:.2e}]", flush=True)
        todo = todo[1:]
    for (nu, nd) in todo:
        t0 = time.time()
        pm = build_factorized_sector(4, 4, nu, nd)
        E0 = pm.locate_E0_lanczos(maxit=args.maxit, ncv=args.ncv,
                                  mixed=True)
        resid = getattr(pm, "_last_residual", None)
        wall = time.time() - t0
        sectors[f"{nu},{nd}"] = {
            "Nup": nu, "Ndn": nd, "dim": pm.dim, "E0": E0,
            "residual_f64": resid, "wall_s": round(wall, 1)}
        # resid is None when a stage record predating residual capture is
        # resumed — report, don't crash a multi-hour sweep
        rtxt = f"{resid:.2e}" if resid is not None else "n/a (resumed)"
        print(f"E0({nu},{nd}) = {E0:.12f}  dim {pm.dim:,}  "
              f"resid {rtxt}  [{wall:.1f}s]", flush=True)
        with open(args.out + ".partial", "w") as f:
            json.dump(sectors, f, indent=1)

    e88 = sectors["8,8"]["E0"]
    spin_gap = sectors["9,7"]["E0"] - e88
    charge_gap = sectors["9,8"]["E0"] + sectors["8,7"]["E0"] - 2 * e88
    out = {
        "workload": "fermi_hubbard_4x4_U1.1_gap_sectors",
        "backend": backend,
        "sectors": sectors,
        "spin_gap": spin_gap,
        "charge_gap": charge_gap,
        "wall_s": round(time.time() - t_all, 1),
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    if os.path.exists(args.out + ".partial"):
        os.remove(args.out + ".partial")
    print(json.dumps({"spin_gap": spin_gap, "charge_gap": charge_gap}))


if __name__ == "__main__":
    main()
