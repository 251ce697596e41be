"""ProductModel — public API for tensor-factorized sectors.

The model-object entry point (the reference's single-entry philosophy,
src/model.cc:74-177) for Hamiltonians that factorize over a tensor product
of two conserved subsectors:

    H = H_a (x) I_b + I_a (x) H_b + scale * sum_m D_a,m (x) D_b,m

Each factor is an ordinary :class:`~quantum_basis_tpu.models.model.Model`
with its full sector enumerated; the coupling is a list of pairs of
diagonal operators. ``locate_E0_lanczos`` then runs the framework's
standard mixed-precision pipeline — f32 thick-restart bulk on the dense
engine, f64 Jacobi-Davidson/RQI polish on the f64 engine —
with stage checkpointing and the hard residual gate.

Flagship use: Fermi-Hubbard 4x4 at half filling (species-major JW
ordering; sector dim C(16,8)^2 = 165,636,900) — see
benchmarks/hubbard4x4.py and examples/square_fermi_hubbard.py's
factorized cross-check against the reference's 4x2 golden values.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu.ops import cplx as cx
from quantum_basis_tpu.ops.apply_kron import KronOp, diagonal_product_coupling


class ProductModel:
    """Two-factor product-sector model; see module docstring."""

    def __init__(self, model_a, model_b=None, coupling=(),
                 coupling_scale: float = 1.0, sec: int = 0,
                 hermiticity="exact", mesh=None):
        self.model_a = model_a
        self.model_b = model_b  # None => same factor twice (Hubbard)
        self.mesh = mesh  # 1-D jax.sharding.Mesh: solves route to KronSharded
        self.coupling = list(coupling)
        self.coupling_scale = float(coupling_scale)
        self._sec = sec
        self._check = hermiticity
        self._ops: dict = {}
        self._P = None
        self._ells = None
        self.eigenvals: list[float] = []
        self.eigenvecs: list = []
        sa = model_a.sec_full[sec]
        sb = (model_b.sec_full[sec] if model_b is not None else sa)
        self.na, self.nb = sa.dim, sb.dim
        self.dim = self.na * self.nb

    # ------------------------------------------------------------- build
    def _factor_ells(self):
        if self._ells is None:
            from quantum_basis_tpu.models.model import Model
            from quantum_basis_tpu.ops.sparse import build_sparse_full

            sa = self.model_a.sec_full[self._sec]
            ell_a = build_sparse_full(sa.matvec)
            Model._check_hermiticity(ell_a, self.na,
                                     sa.matvec.is_complex, self._check)
            if self.model_b is not None:
                sb = self.model_b.sec_full[self._sec]
                ell_b = build_sparse_full(sb.matvec)
                Model._check_hermiticity(ell_b, self.nb,
                                         sb.matvec.is_complex, self._check)
            else:
                ell_b = None
            self._ells = (ell_a, ell_b)
        return self._ells

    def _coupling_matrix(self):
        if self._P is None and self.coupling:
            ma, mb = self.model_a, (self.model_b or self.model_a)
            sa = ma.sec_full[self._sec]
            sb = mb.sec_full[self._sec]
            self._P = diagonal_product_coupling(
                ma.space, sa.dbasis.labels_np, mb.space,
                sb.dbasis.labels_np, self.coupling)
        return self._P

    def op(self, dtype=None, layout=None) -> KronOp:
        """The device engine at a given precision (cached per dtype).

        With a ``mesh`` attached this is the row-sharded
        :class:`~quantum_basis_tpu.parallel.kron_sharded.KronSharded`
        (same protocol; ``N``/``mask`` reflect the mesh-padded space)."""
        import jax.numpy as jnp

        dtype = jnp.dtype(dtype or jnp.float64)
        ndev = (int(np.prod(list(self.mesh.shape.values())))
                if self.mesh is not None else 0)
        key = (str(dtype), layout, ndev)
        if key not in self._ops:
            ell_a, ell_b = self._factor_ells()
            if self.mesh is not None:
                from quantum_basis_tpu.parallel.kron_sharded import (
                    KronSharded)

                self._ops[key] = KronSharded(
                    ell_a, ell_b, coupling=self._coupling_matrix(),
                    coupling_scale=self.coupling_scale, mesh=self.mesh,
                    dtype=dtype, layout=layout)
            else:
                self._ops[key] = KronOp(
                    ell_a, ell_b, coupling=self._coupling_matrix(),
                    coupling_scale=self.coupling_scale, dtype=dtype,
                    layout=layout)
        return self._ops[key]

    def set_mesh(self, mesh):
        """Attach/replace the device mesh; sharded engines rebuild on the
        next solve (mirrors Model.set_mesh)."""
        self.mesh = mesh
        self._ops = {k: v for k, v in self._ops.items() if k[2] == 0}

    def _fingerprint(self) -> int:
        import zlib

        fp = self.model_a._ham_fingerprint()
        if self.model_b is not None:
            fp = zlib.crc32(self.model_b._ham_fingerprint()
                            .to_bytes(4, "little"), fp)
        P = self._coupling_matrix()
        if P is not None:
            fp = zlib.crc32(np.float64(self.coupling_scale).tobytes(), fp)
            # hash ALL of P (zero-copy via the buffer protocol, ~1 GB/s):
            # a prefix hash would alias couplings differing only on
            # higher-index factor states and stage-load the wrong model
            buf = memoryview(np.ascontiguousarray(P)).cast("B")
            fp = zlib.crc32(buf, fp)
        return fp & 0xFFFFFFFF

    # ------------------------------------------------------------- solve
    def locate_E0_lanczos(self, nev: int = 1, maxit: int = 4000,
                          ncv: int = 6, seed: int = 1,
                          mixed: bool | None = None, log=print):
        """Ground state via the mixed-precision pipeline with a hard
        residual gate (cf. model::locate_E0_lanczos, src/model.cc:1123-1316;
        the staged-checkpoint discipline of ckpt_lczsE0, model.cc:2521-2749).

        ``mixed=None`` auto-selects: mixed precision above 2^22 states
        (config.mixed_precision also forces it), pure f64 thick restart
        below. Results land in ``eigenvals``/``eigenvecs``.
        """
        import jax.numpy as jnp

        from quantum_basis_tpu import config
        from quantum_basis_tpu.config import residual_gate
        from quantum_basis_tpu.solvers.restarted import (_solver_log,
                                                         eigs_smallest)

        # factor dims spelled out: transposed sectors like Hubbard (9,8)
        # vs (8,7) share dim = na*nb and the same Hamiltonian terms — only
        # the factor split (and the coupling bytes) tells them apart
        key = (f"prodE0_{self.na}x{self.nb}_nev{nev}"
               f"_h{self._fingerprint():08x}")
        if self.mesh is not None:
            ndev = int(np.prod(list(self.mesh.shape.values())))
            key += f"_mesh{ndev}"
        done = self._stage_load(key)
        if done is not None:
            self.eigenvals, self.eigenvecs, self._last_residual = done
            return self.eigenvals[0]
        if mixed is None:
            mixed = config.mixed_precision or self.dim > (1 << 22)
        if not mixed:
            fs = self.op(jnp.float64)
            evals, vecs = eigs_smallest(
                fs, fs.N, nev=nev,
                ncv=max(ncv, 2 * nev + 4), maxit=maxit, seed=seed,
                complex_vec=False, mask=fs.mask,
                ckpt_key=key + "_krylov")
            self._publish(key, evals, [self._unpad(fs, v) for v in vecs])
            return self.eigenvals[0]

        # stage 1: f32 bulk on the dense engine
        import time as _time

        fs32 = self.op(jnp.float32)
        from quantum_basis_tpu.models.model import Model

        t32 = _time.time()
        try:
            v0 = Model._f32_stage_cached(fs32, nev, ncv, maxit, seed,
                                         False, key)
        except Exception as e:  # HBM fallback: 2-vector rolling kernel
            if "RESOURCE_EXHAUSTED" not in str(e):
                raise
            # the (ncv+1, N) thick-restart buffer (plus its donation copy)
            # overflowed device memory; the rolling 2-vector kernel needs ~5
            # vectors total. tol=1e-8 makes its residual gate match the
            # thick path's f32 gate (1e3 * tol * |E0|).
            log("f32 thick-restart OOM; falling back to rolling 2-vector "
                "Lanczos")
            from quantum_basis_tpu.solvers.lanczos import (
                lanczos_ground as _lg)
            from quantum_basis_tpu.utils.rng import vec_randomize

            re, _ = vec_randomize(self.dim, seed=seed)
            if hasattr(fs32, "pad"):  # mesh route: logical -> padded sharded
                v32 = fs32.pad((re.astype(np.float32), None))
            else:
                v32 = (jnp.asarray(re, jnp.float32), None)
            out32 = _lg(fs32, v32, maxit=maxit, inner=48, tol=1e-8,
                        ckpt_key=key + "_f32roll")
            v0 = out32["vector"]
        t32 = _time.time() - t32
        if v0 is None:
            raise RuntimeError("f32 bulk stage failed to produce a vector")
        # stage 2: f64 RQI/JD polish on the exact-f64 engine
        from quantum_basis_tpu.solvers.lanczos import lanczos_ground
        from quantum_basis_tpu.solvers.rqi import rqi_polish

        fs64 = self.op(jnp.float64)
        v0 = cx.scale((jnp.asarray(v0[0], jnp.float64), None),
                      1.0 / float(cx.norm((jnp.asarray(v0[0], jnp.float64),
                                           None))))
        tp = _time.time()
        out = rqi_polish(fs64, v0, fs32=fs32, ckpt_key=key + "_rqi",
                         log=lambda i, th, rn, ni: _solver_log(
                             "rqi_product", i, [th], [rn]))
        self.solve_info = {
            "f32_stage_s": round(t32, 1),
            "polish_s": round(_time.time() - tp, 1),
            "rqi_outer": out.get("n_outer"),
            "rqi_inner_f32_matvecs": out.get("n_inner"),
            "rqi_converged": out.get("converged"),
        }
        if not out["converged"]:
            v0 = cx.scale(out["vector"],
                          1.0 / float(cx.norm(out["vector"])))
            out = lanczos_ground(fs64, v0, maxit=maxit, inner=60,
                                 ckpt_key=key + "_polish")
        r_gate = residual_gate(out["E0"])
        if out["residual"] >= r_gate:
            err = RuntimeError(
                f"product-sector polish unconverged: E0={out['E0']:.12f}, "
                f"residual {out['residual']:.3e} >= gate {r_gate:.3e} "
                f"(checkpoint retained; re-run to resume)")
            err.E0 = out["E0"]
            err.residual = out["residual"]
            raise err
        self._publish(key, [out["E0"]], [self._unpad(fs64, out["vector"])],
                      resid=out["residual"])
        self._last_residual = out["residual"]
        return self.eigenvals[0]

    @staticmethod
    def _unpad(fs, v):
        """Strip mesh padding from a solver vector (no-op off-mesh)."""
        if not hasattr(fs, "unpad"):
            return v
        import jax.numpy as jnp

        re, im = fs.unpad(v)
        return (jnp.asarray(re), None if im is None else jnp.asarray(im))

    def _publish(self, key, evals, vecs, resid=None):
        self.eigenvals = [float(e) for e in evals]
        self.eigenvecs = list(vecs)
        self._stage_save(key, evals, vecs, resid)

    # ------------------------------------------------- stage checkpointing
    def _stage_load(self, key):
        from quantum_basis_tpu.utils.ckpt import active_store

        store = active_store()
        if store is None:
            return None
        rec = store.load(key)
        if rec is None:
            return None
        import jax.numpy as jnp

        nev = int(rec["nev"])
        evals = [float(x) for x in rec["evals"]]
        vecs = [(jnp.asarray(rec[f"v{i}_re"]), None) for i in range(nev)]
        resid = float(rec["resid"]) if "resid" in rec else None
        return evals, vecs, resid

    def _stage_save(self, key, evals, vecs, resid=None):
        from quantum_basis_tpu import config
        from quantum_basis_tpu.utils.ckpt import active_store

        store = active_store()
        if store is None:
            return
        payload = {"nev": len(vecs), "evals": np.asarray(evals)}
        if resid is not None:
            payload["resid"] = float(resid)
        nbytes = sum(np.asarray(v[0]).nbytes for v in vecs)
        if nbytes > config.ckpt_max_bytes:
            return
        for i, (vr, _) in enumerate(vecs):
            payload[f"v{i}_re"] = np.asarray(vr)
        store.save(key, payload)

    # ------------------------------------------------------- measurements
    def measure_product_static(self, op_a=None, op_b=None, which: int = 0):
        """<phi| O_a (x) O_b |phi> for factor-local operators (either may be
        None = identity). Uses the factor models' generic apply machinery
        on the reshaped eigenvector."""
        import jax.numpy as jnp

        phi = self.eigenvecs[which][0].reshape(self.na, self.nb)
        w = phi
        if op_a is not None:
            from quantum_basis_tpu.ops.apply import MatvecFull

            ma = self.model_a
            mva = MatvecFull(ma.compile_op(op_a), ma.sec_full[self._sec].dbasis)
            # apply O_a to every column: vmap over the b index
            import jax

            w = jax.vmap(lambda col: mva.apply(mva.params, (col, None))[0],
                         in_axes=1, out_axes=1)(w)
        if op_b is not None:
            mb = self.model_b or self.model_a
            from quantum_basis_tpu.ops.apply import MatvecFull

            mvb = MatvecFull(mb.compile_op(op_b), mb.sec_full[self._sec].dbasis)
            import jax

            w = jax.vmap(lambda row: mvb.apply(mvb.params, (row, None))[0],
                         in_axes=0, out_axes=0)(w)
        return float(jnp.sum(phi * w))
