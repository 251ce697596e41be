"""Fermi-Hubbard 4x4 at half filling — BASELINE config #3, on one device.

U=1.1, N_up = N_dn = 8, sector dim C(16,8)^2 = 165,636,900 — the scale-out
workload of the framework (the reference's anchor stops at 4x2,
examples/trans_absent/latt_square/square_Fermi_Hubbard.cc:113).

Factorized formulation (models/product.py, ops/apply_kron.py): in the
species-major Jordan-Wigner ordering the sector factorizes as
up (x) down, so the 1.66e8-dim state vector is a (12870, 12870) matrix and
one H application is two dense 12870^3 matmuls + one elementwise pass
— no 1.66e8-label enumeration, no Lin table, no residency build. The
previous row-gather formulation needed 869 s of setup and managed
0.0121 iter/s on 8 virtual CPU devices; this one runs the full
mixed-precision pipeline (f32 thick-restart bulk -> f64 RQI polish with
the hard residual gate) on one device.

Protocol:
1. 4x2 golden cross-check (E0 = -14.07605866, reference golden) through
   the SAME ProductModel path on the same backend;
2. 4x4 solve, checkpointed (out_Qckpt/) and resumable; publishes E0 with
   the exact f64 residual ||Hx - E0 x|| and the gate verdict.

Run (GPU):         python benchmarks/hubbard4x4.py
    (CPU check):   python benchmarks/hubbard4x4.py --platform cpu --skip-4x4
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu); default = "
                         "JAX's choice")
    ap.add_argument("--skip-4x4", action="store_true")
    ap.add_argument("--maxit", type=int, default=4000)
    ap.add_argument("--ncv", type=int, default=6,
                    help="f32 thick-restart basis size (memory-bound: "
                         "ncv+1 rows of 662 MB each)")
    ap.add_argument("--out", default="HUBBARD4x4.json")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    import numpy as np

    from quantum_basis_tpu import config, initialize
    from square_fermi_hubbard import build_factorized

    initialize(enable_checkpoint=True, quiet=True)
    config.solver_log_dir = "out_logs"
    # allow the one-shot f32 stage-result record (662 MB) — worth the
    # pull for a warm resume of the whole bulk stage; the multi-GB
    # per-outer RQI records stay over the cap and are skipped
    config.ckpt_max_bytes = 2 << 30
    backend = jax.devices()[0].platform
    print(f"backend: {backend} ({jax.devices()[0].device_kind})", flush=True)

    # ---- 1. golden cross-check through the same path ----
    t0 = time.time()
    pm42, _ = build_factorized(4, 2)
    E42 = pm42.locate_E0_lanczos(mixed=True)
    t42 = time.time() - t0
    ok42 = abs(E42 - (-14.07605866)) < 1e-8
    print(f"4x2 golden: E0 = {E42:.9f} (ref -14.07605866) "
          f"[{'OK' if ok42 else 'FAIL'}] {t42:.1f}s", flush=True)
    assert ok42, E42

    rec = {
        "workload": "fermi_hubbard_4x4_halffilling_U1.1",
        "formulation": "species-factorized (up x down), models/product.py",
        "backend": backend,
        "golden_4x2": {"E0": E42, "ref": -14.07605866, "ok": ok42,
                       "wall_s": round(t42, 1)},
    }
    if args.skip_4x4:
        print(json.dumps(rec))
        return

    # ---- 2. the 4x4 solve ----
    import jax.numpy as jnp

    t_all = time.time()
    t0 = time.time()
    pm, ms = build_factorized(4, 4)
    assert pm.dim == 165_636_900, pm.dim
    t_build = time.time() - t0
    print(f"factor dim {pm.na} (x) {pm.nb} = {pm.dim}  "
          f"[factor ELL + coupling build {t_build:.1f}s]", flush=True)

    t0 = time.time()
    E0 = pm.locate_E0_lanczos(maxit=args.maxit, ncv=args.ncv, mixed=True)
    t_solve = time.time() - t0
    resid = getattr(pm, "_last_residual", None)
    if resid is None:
        resid = float("nan")  # pre-residual stage record (shouldn't happen)

    # matvec throughput (the f32 bulk engine) — timed AFTER the solve so
    # the extra bench buffers never share the chip with the solver's peak
    fs32 = pm.op(jnp.float32)
    from quantum_basis_tpu.utils.rng import vec_randomize

    re, _ = vec_randomize(pm.dim, seed=1)
    x = (jnp.asarray(re, jnp.float32), None)
    ap_jit = jax.jit(fs32.apply)
    y = ap_jit(fs32.params, x)
    jax.block_until_ready(y[0])
    t0b = time.time()
    reps = 10
    for _ in range(reps):
        y = ap_jit(fs32.params, y)
    jax.block_until_ready(y[0])
    ms_apply = (time.time() - t0b) / reps * 1e3
    nnzs = fs32.nnz_estimate / (ms_apply / 1e3)
    print(f"f32 apply: {ms_apply:.1f} ms  "
          f"({nnzs:.3e} stored-nnz/s equivalent)", flush=True)
    del x, y
    info = getattr(pm, "solve_info", {})
    from quantum_basis_tpu.config import lanczos_precision

    gate = max(1e3 * lanczos_precision * max(abs(E0), 1.0), 5e-10)
    print(f"E0 = {E0:.12f}  residual {resid:.3e} < gate {gate:.3e}",
          flush=True)

    rec.update({
        "dim": pm.dim,
        "factor_dim": pm.na,
        "status": "converged",
        "E0": E0,
        "residual_f64": resid,
        "residual_gate": gate,
        "gate_passed": bool(resid < gate),
        "f32_apply_ms": round(ms_apply, 2),
        "stored_nnz_per_s": round(nnzs, 1),
        "timings_s": {"factor_build": round(t_build, 1),
                      "solve": round(t_solve, 1),
                      "total": round(time.time() - t_all, 1),
                      **{k: v for k, v in info.items()
                         if k.endswith("_s")}},
        "solver": {k: v for k, v in info.items() if not k.endswith("_s")},
    })
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
