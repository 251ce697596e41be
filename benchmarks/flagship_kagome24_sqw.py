"""Momentum-resolved dynamical structure factor S(q, w) for kagome-24.

The flagship-scale dynamics artifact (reference analog:
model::measure_repr_dynamic, src/model.cc:1896-1912 — continued fractions
only, no KPM): on the 24-site kagome Heisenberg antiferromagnet,

1. solve the ground state in its momentum sector k0 (GS momentum (0,2),
   BASELINE.md),
2. for every q on the 2x4 Brillouin-zone grid, build
   Sz(q) = (1/sqrt(N)) sum_r e^{-i q.r} Sz_r (cell-coordinate phases,
   sublattice-summed), land A_q|gs> in sector k0 - q, and record
   operator-resolved Chebyshev moments via measure_repr_dynamic_kpm —
   running on the PROJECTED FULL-SPACE engine (the fast momentum
   machinery of the flagship; dual-path-tested against the sector ELL in
   tests/test_kpm.py),
3. reconstruct S(q, w) with the Jackson kernel and write
   SQW_kagome24.json + a heatmap PNG.

Checkpointed and resumable (per-sector stage records + per-q moment
records in out_Qckpt/). Run (GPU):
    python benchmarks/flagship_kagome24_sqw.py [--n-moments 192]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "benchmarks"))

import numpy as np

from quantum_basis_tpu import Mopr, Opr, initialize
from quantum_basis_tpu.postprocess import sqw_kpm

from flagship_kagome24 import SZ, build


def sz_q(lat, qx, qy, Lx, Ly):
    out = Mopr()
    n = lat.n_sites
    for s in range(n):
        coor, _ = lat.site2coor(s)
        ph = np.exp(-2j * np.pi * (qx * coor[0] / Lx + qy * coor[1] / Ly))
        out += (ph / np.sqrt(n)) * Opr(s, 0, False, SZ)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lx", type=int, default=2)
    ap.add_argument("--ly", type=int, default=4)
    ap.add_argument("--n-moments", type=int, default=192)
    ap.add_argument("--k0", type=int, nargs=2, default=[0, 2],
                    help="GS momentum sector (BASELINE.md: (0,2) for 2x4)")
    ap.add_argument("--maxit", type=int, default=4000)
    ap.add_argument("--out", default="SQW_kagome24")
    ap.add_argument("--kpm-fs-max", type=int, default=1 << 24,
                    help="run the Chebyshev recurrence on the projected "
                         "full-space engine up to this label-space size")
    args = ap.parse_args()

    import jax

    initialize(quiet=True, mixed_precision=True, enable_checkpoint=True)
    from quantum_basis_tpu import config
    config.solver_log_dir = "out_logs"
    config.kpm_fullspace_max_N = int(args.kpm_fs_max)
    t_all = time.time()
    Lx, Ly = args.lx, args.ly

    k0 = [int(args.k0[0]), int(args.k0[1])]
    print(f"GS momentum sector k0 = {k0}", flush=True)

    m, Sz_tot = build(Lx, Ly)
    lat = m.lattice
    t0 = time.time()
    dim0 = m.enumerate_basis_repr(k0, [Sz_tot], [0.0], sec=0)
    m.locate_E0_lanczos(which="repr", sec=0, maxit=args.maxit)
    E0 = float(m.eigenvals_repr[0])
    t_gs = time.time() - t0
    print(f"E0(k0) = {E0:.12f}  dim {dim0}  [{t_gs:.1f}s]", flush=True)

    from quantum_basis_tpu.utils.ckpt import active_store

    # Release the GS-phase f64 device memory before the q loop: the f64
    # projected-engine template (full-space 2^24 params) and the solver
    # program caches pin several GB the moment recurrence never touches.
    import gc

    import jax.numpy as jnp

    from quantum_basis_tpu.solvers import restarted as _restarted
    from quantum_basis_tpu.solvers import rqi as _rqi

    sec0 = m.sec_repr[0]
    _restarted._DOPS_CACHE.clear()
    _rqi._PROGRAM_CACHE.clear()
    gc.collect()

    # Shared spectral bounds, computed ONCE on the full-space f32 engine
    # confined to the Sz=0 subspace (covers every momentum sector, and 0 —
    # the projector complement's eigenvalue), instead of a per-q
    # energy_scale on each target sector.
    from quantum_basis_tpu.solvers.chebyshev import energy_scale
    from quantum_basis_tpu.utils.rng import vec_randomize

    bk = f"sqw24_bounds_h{m._ham_fingerprint():08x}"
    store = active_store()
    brec = store.load(bk) if store is not None else None
    if brec is not None:
        bounds = (float(brec["e_min"]), float(brec["e_max"]))
    else:
        t0 = time.time()
        fs0 = m._fullspace_repr_op(sec0, dtype=jnp.float32)
        re, _ = vec_randomize(fs0.N, seed=7)
        vr = jnp.asarray(re * np.asarray(fs0.mask), jnp.float32)
        # the projected engine is force-complex: the seed needs an
        # explicit (zero) imaginary part or the Lanczos scan carry
        # changes pytree structure after the first apply
        v0 = (vr, jnp.zeros_like(vr))
        e_min, e_max = energy_scale(fs0, v0)
        bounds = (min(e_min, E0 - 0.1), max(e_max, 0.1))
        if store is not None:
            store.save(bk, {"e_min": bounds[0], "e_max": bounds[1]})
        print(f"shared bounds [{bounds[0]:.3f}, {bounds[1]:.3f}] "
              f"[{time.time()-t0:.1f}s]", flush=True)

    runs = []
    for qx in range(Lx):
        for qy in range(Ly):
            t0 = time.time()
            m.sec_repr.pop(1, None)  # drop the previous q-sector's tables
            gc.collect()
            kt = [(k0[0] - qx) % Lx, (k0[1] - qy) % Ly]
            # key carries k0 too: moments are defined relative to the GS
            # sector, so a rerun with a different --k0 must not reuse them
            ck = (f"sqw24_k{k0[0]}_{k0[1]}_q{qx}_{qy}_m{args.n_moments}"
                  f"_h{m._ham_fingerprint():08x}")
            rec = store.load(ck) if store is not None else None
            if rec is not None:
                nrm = float(rec["nrm"])
                mu = np.asarray(rec["mu"])
                e_min, e_max = float(rec["e_min"]), float(rec["e_max"])
                src = "ckpt"
            else:
                m.enumerate_basis_repr(kt, [Sz_tot], [0.0], sec=1)
                nrm, mu, e_min, e_max = m.measure_repr_dynamic_kpm(
                    sz_q(lat, qx, qy, Lx, Ly), 0, 1, args.n_moments,
                    bounds=bounds)
                if store is not None:
                    store.save(ck, {"nrm": nrm, "mu": np.asarray(mu),
                                    "e_min": e_min, "e_max": e_max})
                src = "solved"
            runs.append({"q": [qx, qy], "k_target": kt, "norm": nrm,
                         "mu": np.asarray(mu).tolist(),
                         "e_min": e_min, "e_max": e_max})
            print(f"q=({qx},{qy}) -> k={kt}  norm^2 = {nrm**2:.6f}  "
                  f"[{src}, {time.time()-t0:.1f}s]", flush=True)

    e_max_all = max(r["e_max"] for r in runs if r["norm"] > 0)
    omegas = np.linspace(0.0, (e_max_all - E0) * 1.02, 600)
    S = np.stack([sqw_kpm(omegas, r["norm"], np.asarray(r["mu"]),
                          r["e_min"], r["e_max"], E0)
                  if r["norm"] > 0 else np.zeros_like(omegas)
                  for r in runs])
    out = {
        "workload": f"kagome{3*Lx*Ly}_heisenberg_sqw_kpm",
        "n_sites": 3 * Lx * Ly, "dim_k0": int(dim0), "k0": k0,
        "E0": E0, "n_moments": args.n_moments,
        "engine": "projected full-space (measure_repr_dynamic_kpm)",
        "backend": jax.devices()[0].platform,
        "sum_rule": {"integral": float(np.trapezoid(S, omegas,
                                                    axis=1).sum()),
                     "norms2": float(sum(r["norm"] ** 2 for r in runs))},
        "runs": runs, "wall_s": round(time.time() - t_all, 1),
    }
    with open(args.out + ".json", "w") as f:
        json.dump(out, f)
    print(f"wrote {args.out}.json  (wall {out['wall_s']}s)", flush=True)

    try:
        from quantum_basis_tpu.postprocess import _agg_plt

        plt = _agg_plt()
        fig, ax = plt.subplots(figsize=(7, 4.5))
        im = ax.imshow(S, aspect="auto", origin="lower",
                       extent=[omegas[0], omegas[-1], -0.5, S.shape[0]-0.5],
                       cmap="magma")
        ax.set_yticks(range(len(runs)))
        ax.set_yticklabels([f"({r['q'][0]},{r['q'][1]})" for r in runs])
        ax.set_xlabel(r"$\omega$")
        ax.set_ylabel("q (cell momenta)")
        ax.set_title(f"kagome-24 S(q,$\\omega$), KPM "
                     f"{args.n_moments} moments")
        fig.colorbar(im, ax=ax, label="S(q,$\\omega$)")
        fig.tight_layout()
        fig.savefig(args.out + ".png", dpi=130)
        print(f"wrote {args.out}.png", flush=True)
    except Exception as e:  # plotting is best-effort
        print(f"plot skipped: {e}", flush=True)


if __name__ == "__main__":
    main()
