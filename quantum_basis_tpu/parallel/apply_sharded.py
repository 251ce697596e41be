"""Sharded matrix-free apply: basis rows partitioned across a device mesh.

The multi-chip replacement for the reference's OpenMP row-parallel
``model::MultMv2`` loops (reference: src/model.cc:941-1121, §2.2/§5.8 of
SURVEY.md). Row blocks are sharded over a 1-D mesh axis; Lanczos vectors are
sharded over the same axis; each device all-gathers the source vector and
computes its own rows with the identical gather kernel as the
single-chip path (:func:`quantum_basis_tpu.ops.apply.apply_block_rows`) —
no scatters, no host round-trips. Reductions in the solvers (vdot/norm) are
ordinary jnp ops over sharded arrays, which XLA lowers to psum collectives.

The all-gather is the v1 halo strategy (every off-shard column may be
touched). For bases too large to replicate one vector per chip, the upgrade
path is ragged all-to-all exchange of only the halo entries.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu.ops.apply import DeviceBasis, apply_block_rows, _group_device
from quantum_basis_tpu.ops.compile import CompiledOperator, compile_diagonal


class MatvecSharded:
    """y = H x with basis rows sharded over ``mesh``'s ``axis``.

    Vectors are padded to ``n_pad`` (block-aligned, divisible by the mesh
    size) and sharded; use :meth:`pad` / :meth:`unpad` at the boundary.
    Solvers consume this through the same ``.apply``/``.params`` protocol as
    :class:`~quantum_basis_tpu.ops.apply.MatvecFull` — padding rows are
    masked to zero so dots/norms over padded vectors are exact.
    """

    def __init__(self, compiled: CompiledOperator, dbasis: DeviceBasis, mesh,
                 axis: str = "b"):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        self.compiled = compiled
        self.basis = dbasis
        self.mesh = mesh
        self.axis = axis
        self.n = dbasis.n
        nd = mesh.shape[axis]
        nb, B = dbasis.n_blocks, dbasis.block_rows
        nbp = ((nb + nd - 1) // nd) * nd
        self.n_pad = nbp * B
        space = compiled.space
        self.groups = [_group_device(g) for g in compiled.groups]
        self.is_complex = any(g["amp_im"] is not None for g in self.groups)
        index = dbasis.index

        def pad_blocks(arr):
            """(nb, B, ...) -> (nbp, B, ...) repeating block 0 (masked later)."""
            a = np.asarray(arr)
            if nbp == nb:
                return a
            reps = np.repeat(a[:1], nbp - nb, axis=0)
            return np.concatenate([a, reps], axis=0)

        labels_p = pad_blocks(dbasis.labels_b)
        V_p = pad_blocks(dbasis.V_b)
        F_p = pad_blocks(dbasis.F_b)
        if compiled.diag_terms.q_zero():
            diag_p = np.zeros((nbp, B), dtype=np.float64)
        else:
            ev = compile_diagonal(compiled.diag_terms, space)
            diag_p = np.asarray(jax.jit(ev)(jnp.asarray(V_p.astype(np.int32))))
        row_id = np.arange(nbp * B, dtype=np.int64).reshape(nbp, B)
        mask_p = (row_id < self.n).astype(np.float64)
        diag_p = diag_p * mask_p

        shard_b = NamedSharding(mesh, P(axis))
        shard_rep = NamedSharding(mesh, P())
        put = lambda a, s: jax.device_put(jnp.asarray(a), s)
        self.vec_sharding = shard_b
        self._labels_s = put(labels_p, shard_b)
        self._V_s = put(V_p, shard_b)
        self._F_s = put(F_p, shard_b)
        self._diag_s = put(diag_p, shard_b)
        self._mask_s = put(mask_p, shard_b)
        self._itabs = tuple(put(t, shard_rep) for t in index.tables)
        groups = self.groups

        def local_rows(itabs, labels_b, V_b, F_b, diag_b, mask_b, xb, xg):
            """Rows owned by this device; xb = local x blocks (the diagonal
            slice), xg = the full all-gathered cvec the gathers read from."""

            def one(a):
                if xb[1] is None:
                    labels, V, F, diag, mask, xbr = a
                    xbi = None
                else:
                    labels, V, F, diag, mask, xbr, xbi = a
                yr, yi = apply_block_rows(
                    groups, index, itabs, labels, V, F, diag, (xbr, xbi), xg,
                )
                yr = yr * mask
                if yi is not None:
                    yi = yi * mask
                return yr if yi is None else (yr, yi)

            xs = (labels_b, V_b, F_b, diag_b, mask_b, xb[0])
            if xb[1] is not None:
                xs = xs + (xb[1],)
            return jax.lax.map(one, xs)

        def sharded_real(itabs, labels_b, V_b, F_b, diag_b, mask_b, x_re):
            B_loc = labels_b.shape[1]
            xg = jax.lax.all_gather(x_re, axis, tiled=True)
            xb = (x_re.reshape(-1, B_loc), None)
            y = local_rows(itabs, labels_b, V_b, F_b, diag_b, mask_b, xb,
                           (xg, None))
            return y.reshape(-1)

        def sharded_cplx(itabs, labels_b, V_b, F_b, diag_b, mask_b, x_re, x_im):
            B_loc = labels_b.shape[1]
            xgr = jax.lax.all_gather(x_re, axis, tiled=True)
            xgi = jax.lax.all_gather(x_im, axis, tiled=True)
            xb = (x_re.reshape(-1, B_loc), x_im.reshape(-1, B_loc))
            yr, yi = local_rows(itabs, labels_b, V_b, F_b, diag_b, mask_b, xb,
                                (xgr, xgi))
            return yr.reshape(-1), yi.reshape(-1)

        spec_in = (P(), P(axis), P(axis), P(axis), P(axis), P(axis), P(axis))
        self._apply_real_raw = jax.shard_map(
            sharded_real, mesh=mesh, in_specs=spec_in, out_specs=P(axis),
        )
        self._apply_cplx_raw = jax.shard_map(
            sharded_cplx, mesh=mesh, in_specs=spec_in + (P(axis),),
            out_specs=(P(axis), P(axis)),
        )
        self._apply_real = jax.jit(self._apply_real_raw)
        self._apply_cplx = jax.jit(self._apply_cplx_raw)

    # ------------------------------------------------------------- protocol

    @property
    def params(self):
        return (self._itabs, self._labels_s, self._V_s, self._F_s,
                self._diag_s, self._mask_s)

    def apply(self, params, x):
        itabs, labels_s, V_s, F_s, diag_s, mask_s = params
        x_re, x_im = x
        if x_im is None:
            if self.is_complex:
                raise ValueError("complex Hamiltonian applied to real vector")
            return (self._apply_real_raw(itabs, labels_s, V_s, F_s, diag_s,
                                         mask_s, x_re), None)
        yr, yi = self._apply_cplx_raw(itabs, labels_s, V_s, F_s, diag_s,
                                      mask_s, x_re, x_im)
        return (yr, yi)

    def __call__(self, x):
        x_re, x_im = x
        if x_im is None:
            if self.is_complex:
                raise ValueError("complex Hamiltonian applied to real vector")
            return (self._apply_real(*self.params, x_re), None)
        yr, yi = self._apply_cplx(*self.params, x_re, x_im)
        return (yr, yi)

    # ------------------------------------------------------------ vector IO

    def pad(self, x):
        """Host/device cvec of length n -> sharded padded cvec of n_pad."""
        import jax
        import jax.numpy as jnp

        def one(v):
            if v is None:
                return None
            v = np.asarray(v, dtype=np.float64)
            vp = np.pad(v, (0, self.n_pad - v.size))
            return jax.device_put(jnp.asarray(vp), self.vec_sharding)

        return (one(x[0]), one(x[1]))

    def unpad(self, x):
        """Sharded padded cvec -> host numpy cvec of length n."""
        re = np.asarray(x[0])[: self.n]
        im = None if x[1] is None else np.asarray(x[1])[: self.n]
        return (re, im)
