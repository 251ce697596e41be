"""Scaling harness: sharded apply + Lanczos rate over a 1-D device mesh.

Measures (JSON lines, one per configuration):
- spmv_nnz_per_s for the sharded full-space apply at each device count;
- lanczos_iters_per_s (full iteration incl. psum reductions);
- scaling efficiency vs the 1-device run.

On several real devices this exercises their interconnect; on one device
or a CPU run with
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORMS=cpu python benchmarks/scaling.py [L]
to validate the sharded program (virtual devices share one socket, so CPU
"efficiency" underestimates real hardware).
"""

from __future__ import annotations

import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:  # __graft_entry__ lives at the repo root
    sys.path.insert(0, _ROOT)

import numpy as np


def main(L=20):
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _chain_setup
    from quantum_basis_tpu.ops.apply_fullspace import FullSpaceOp
    from quantum_basis_tpu.parallel import basis_mesh
    from quantum_basis_tpu.parallel.fullspace_sharded import FullSpaceSharded
    from quantum_basis_tpu.utils.rng import vec_randomize

    compiled, _, labels = _chain_setup(L, light=True)
    fs = FullSpaceOp(compiled, labels)
    nnz = labels.size * 0  # filled below per config
    counts = [c for c in (1, 2, 4, 8, 16) if c <= len(jax.devices())]
    base_rate = None
    for nd in counts:
        mesh = basis_mesh(nd)
        fss = FullSpaceSharded(fs, mesh)

        @jax.jit
        def lanczos_iter(params, v_prev, v_cur, b_prev):
            w, _ = fss.apply(params, (v_cur, None))
            w = w - b_prev * v_prev
            a = jnp.vdot(v_cur, w)
            w = w - a * v_cur
            b = jnp.linalg.norm(w)
            return v_cur, w / jnp.maximum(b, 1e-300), a, b

        re, _ = vec_randomize(fs.N, seed=1)
        v = jax.device_put(jnp.asarray(re * np.asarray(fs.mask)), fss.sharding)
        z = jax.device_put(jnp.zeros(fs.N), fss.sharding)
        out = lanczos_iter(fss.params, z, v, 0.0)
        jax.block_until_ready(out)
        iters = 25
        t0 = time.time()
        vp, vc, b = z, v, 0.0
        for _ in range(iters):
            vp, vc, a, b = lanczos_iter(fss.params, vp, vc, b)
        jax.block_until_ready(vc)
        dt = (time.time() - t0) / iters
        rate = 1.0 / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd / counts[0])
        print(json.dumps({
            "metric": "lanczos_iters_per_s",
            "value": round(rate, 3),
            "unit": "iter/s",
            "devices": nd,
            "scaling_efficiency_vs_1dev": round(eff, 4),
            "detail": {"workload": f"heisenberg_chain_L{L}_Sz0_fullspace",
                       "ms_per_iter": round(dt * 1e3, 3),
                       "backend": jax.devices()[0].platform},
        }))

    # ---- explicit-sparse halo engine (static all-to-all exchange) vs the
    # all-gather strategy, at the largest mesh
    from quantum_basis_tpu.basis.lin_table import digit_split
    from quantum_basis_tpu.basis.index import BasisIndex
    from quantum_basis_tpu.ops.apply import DeviceBasis, MatvecFull
    from quantum_basis_tpu.ops.sparse import build_sparse_full
    from quantum_basis_tpu.parallel.halo_sharded import EllShardedHalo

    index = BasisIndex(labels, compiled.space.label_space,
                       lin_split=digit_split(compiled.space))
    dbasis = DeviceBasis(compiled.space, labels, index)
    ell = build_sparse_full(MatvecFull(compiled, dbasis))
    nd = counts[-1]
    hs = EllShardedHalo(ell, basis_mesh(nd))
    re, _ = vec_randomize(ell.n, seed=2)
    x = hs.pad((re, None))
    y = hs(x)
    jax.block_until_ready(y[0])
    iters = 25
    t0 = time.time()
    for _ in range(iters):
        y = hs(y if y[1] is None else (y[0], None))
    jax.block_until_ready(y[0])
    dt = (time.time() - t0) / iters
    st = hs.halo_stats()
    print(json.dumps({
        "metric": "halo_spmv_nnz_per_s",
        "value": round(ell.nnz / dt, 1),
        "unit": "nnz/s",
        "devices": nd,
        "detail": {"workload": f"heisenberg_chain_L{L}_Sz0_ell_halo",
                   "ms_per_apply": round(dt * 1e3, 3),
                   "halo_traffic_ratio_vs_allgather":
                       round(st["traffic_ratio"], 4),
                   "backend": jax.devices()[0].platform},
    }))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20)
