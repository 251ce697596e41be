"""Worker for the REAL multi-controller test (tests/test_multiprocess.py).

Launched as one process of an actual ``jax.distributed`` group (gloo
collectives over localhost TCP — the same multi-controller runtime and
cross-process collective path a multi-host job uses; only the transport
differs). Each process owns 4 virtual CPU devices; the global
mesh spans all processes. The engines under test are the production
multi-host engines (parallel/fullspace_sharded.py, parallel/halo_sharded.py)
driven by a plain 2-vector Lanczos whose per-iteration scalars (a, b) are
GSPMD psum reductions fetched as replicated outputs.

The reference has no multi-process capability at all (SURVEY §5.8:
single-node OpenMP only); this verifies the framework's story the
reference cannot tell: the SAME engine code runs unmodified from 1 process
to N processes, with bit-level agreement on the Lanczos scalars.

Usage: mp_worker.py <pid> <nproc> <port> <engine: fullspace|halo> <L>
Prints one line: MPRESULT {json}
"""

from __future__ import annotations

import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    engine, L = sys.argv[4], int(sys.argv[5])

    import jax

    jax.config.update("jax_platforms", "cpu")
    from quantum_basis_tpu.parallel.distributed import (
        init_distributed, global_basis_mesh)

    multi = init_distributed(f"localhost:{port}", num_processes=nproc,
                             process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = global_basis_mesh()
    ndev = int(np.prod(list(mesh.shape.values())))

    from __graft_entry__ import _chain_setup
    from quantum_basis_tpu.utils.rng import vec_randomize

    compiled, _, labels = _chain_setup(L, light=True)

    if engine == "fullspace":
        from quantum_basis_tpu.ops.apply_fullspace import FullSpaceOp
        from quantum_basis_tpu.parallel.fullspace_sharded import (
            FullSpaceSharded)

        mv = FullSpaceSharded(FullSpaceOp(compiled, labels), mesh)
        n = mv.fs.N
        re, _ = vec_randomize(n, seed=1)
        re = re * np.asarray(mv.fs.mask)
        re /= np.linalg.norm(re)
    elif engine == "halo":
        from quantum_basis_tpu.basis.index import BasisIndex
        from quantum_basis_tpu.basis.lin_table import digit_split
        from quantum_basis_tpu.ops.apply import DeviceBasis, MatvecFull
        from quantum_basis_tpu.ops.sparse import build_sparse_full
        from quantum_basis_tpu.parallel.halo_sharded import EllShardedHalo

        index = BasisIndex(labels, compiled.space.label_space,
                           lin_split=digit_split(compiled.space))
        dbasis = DeviceBasis(compiled.space, labels, index)
        ell = build_sparse_full(MatvecFull(compiled, dbasis))
        mv = EllShardedHalo(ell, mesh)
        n = mv.n_pad
        re0, _ = vec_randomize(labels.size, seed=1)
        re = np.zeros(n)
        re[: labels.size] = re0
    elif engine == "kron":
        # the flagship Hubbard engine (dense matmuls), row-sharded:
        # GSPMD partitions the A@psi contraction across the two processes
        sys.path.insert(0, os.path.join(_ROOT, "examples"))
        from square_fermi_hubbard import build_factorized

        pm, _ = build_factorized(4, 2)
        pm.set_mesh(mesh)
        import jax.numpy as jnp_

        mv = pm.op(jnp_.float64)
        n = mv.N
        re0, _ = vec_randomize(pm.dim, seed=1)
        rep_ = np.zeros((mv.na, mv.nb))  # host-side zero-row padding
        rep_[: mv.na_logical] = re0.reshape(mv.na_logical, mv.nb)
        re = rep_.reshape(-1)
    else:
        raise SystemExit(f"unknown engine {engine}")

    sh = NamedSharding(mesh, P("b"))
    rep = NamedSharding(mesh, P())
    params = mv.params

    @jax.jit
    def lanczos_iter(params, v_prev, v_cur, b_prev):
        w, _ = mv.apply(params, (v_cur, None))
        w = w - b_prev * v_prev
        a = jnp.vdot(v_cur, w)
        w = w - a * v_cur
        b = jnp.linalg.norm(w)
        return v_cur, w / jnp.maximum(b, 1e-300), a, b

    jl = jax.jit(lanczos_iter,
                 in_shardings=(None, sh, sh, rep),
                 out_shardings=(sh, sh, rep, rep))

    v = jax.device_put(jnp.asarray(re), sh)
    z = jax.device_put(jnp.zeros(n), sh)
    b = jax.device_put(jnp.asarray(0.0), rep)

    m = 300
    alphas, betas = [], []
    vp, vc = z, v
    for _ in range(m):
        vp, vc, a, b = jl(params, vp, vc, b)
        alphas.append(float(a))
        betas.append(float(b))

    T = (np.diag(np.asarray(alphas))
         + np.diag(np.asarray(betas[:-1]), 1)
         + np.diag(np.asarray(betas[:-1]), -1))
    E0 = float(np.linalg.eigvalsh(T)[0])

    print("MPRESULT " + json.dumps({
        "pid": pid, "multi": bool(multi),
        "process_count": int(jax.process_count()),
        "ndev": ndev, "engine": engine, "L": L, "E0": E0,
        "a0": alphas[0], "b0": betas[0],
    }), flush=True)


if __name__ == "__main__":
    main()
