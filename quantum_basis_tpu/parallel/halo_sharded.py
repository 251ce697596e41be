"""Sharded ELL SpMV with static halo all-to-all exchange.

The v2 halo strategy for basis-sharded matrix application (upgrade over
:class:`~quantum_basis_tpu.parallel.apply_sharded.MatvecSharded`'s
all-gather): the sparsity pattern of H is static, so the exact set of
off-shard source entries each device needs ("the halo") is computed ONCE on
the host, and every apply exchanges only those entries via one
``jax.lax.all_to_all`` over the mesh axis — the ragged all-to-all of
SURVEY §5.8, padded to the max pair capacity (XLA collectives are
static-shaped). For local Hamiltonians in index-locality-preserving basis
orders the halo is a small fraction of the vector, so the exchange costs
bandwidth in proportion to the TRUE coupling between
shards instead of the full vector size (reference's analog: the OpenMP
row-parallel loops share one address space and pay nothing,
src/model.cc:941-1121 — across hosts the halo is the honest replacement).

Construction takes an explicit :class:`~quantum_basis_tpu.ops.sparse.
EllMatrix` (the reference likewise builds CSR once and reuses it per
MultMv, src/sparse.cc:113-328):

1. rows are block-partitioned over the mesh axis (padded to equal shards);
2. for each ordered shard pair (p -> q), the sorted unique column set
   ``need[q][p]`` (q's gather columns owned by p) becomes a static send
   index list on p and a static position map on q;
3. per apply: gather send values, ``all_to_all``, concatenate
   ``[x_local | halo]``, and run the ELL row kernel with columns remapped
   into that compact buffer.

``halo_stats()`` reports per-pair halo sizes and the traffic ratio vs the
all-gather strategy, so callers can pick the cheaper engine per matrix.
"""

from __future__ import annotations

import numpy as np


def _ceil_to(x: int, m: int) -> int:
    return -(-int(x) // m) * m


class EllShardedHalo:
    """y = H x with ELL rows sharded over ``mesh`` and halo all-to-all.

    Protocol-compatible with the other sharded engines: ``params`` /
    ``apply(params, (x_re, x_im))`` on padded sharded vectors, plus
    ``pad``/``unpad`` boundary helpers and ``vec_sharding``.
    """

    def __init__(self, ell, mesh, axis: str = "b"):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P_

        self.mesh = mesh
        self.axis = axis
        self.n = int(ell.n)
        P = int(mesh.shape[axis])
        self.P = P
        W = int(ell.width)
        self.is_complex = bool(ell.is_complex)

        nl = _ceil_to(max(self.n, 1), 8 * P) // P
        self.n_local = nl
        self.n_pad = nl * P

        cols = np.zeros((self.n_pad, W), dtype=np.int64)
        vre = np.zeros((self.n_pad, W), dtype=np.float64)
        vim = np.zeros((self.n_pad, W), dtype=np.float64) \
            if self.is_complex else None
        diag = np.zeros(self.n_pad, dtype=np.float64)
        if W:
            cols[: self.n] = np.asarray(ell.cols, dtype=np.int64)
            vre[: self.n] = np.asarray(ell.vre)
            if vim is not None:
                vim[: self.n] = np.asarray(ell.vim)
        diag[: self.n] = np.asarray(ell.diag)

        # live = entries with a stored value (padded/zero entries must not
        # create halo traffic; their remapped column stays 0 = local slot 0)
        mag = np.abs(vre) + (np.abs(vim) if vim is not None else 0.0)
        live = mag > 0.0

        owner = cols // nl  # owning shard of each gather column

        # ---- per-pair halo sets + send/recv maps
        need = [[None] * P for _ in range(P)]  # need[q][p] = sorted cols
        cap = 1
        for q in range(P):
            rows = slice(q * nl, (q + 1) * nl)
            c_q = cols[rows][live[rows]]
            o_q = owner[rows][live[rows]]
            for p in range(P):
                if p == q:
                    need[q][p] = np.empty(0, dtype=np.int64)
                    continue
                u = np.unique(c_q[o_q == p])
                need[q][p] = u
                cap = max(cap, u.size)
        cap = _ceil_to(cap, 8)
        self.halo_cap = cap

        # send_idx[p, q, k]: LOCAL index (on p) of the k-th value p sends
        # to q; padded slots point at local slot 0 (value unused by q).
        send_idx = np.zeros((P, P, cap), dtype=np.int32)
        for q in range(P):
            for p in range(P):
                u = need[q][p]
                send_idx[p, q, : u.size] = (u - p * nl).astype(np.int32)

        # cols_remap: columns of shard q's rows remapped into the compact
        # buffer [x_local (nl) | halo (P*cap)] where halo[p*cap + k] is the
        # k-th entry of need[q][p].
        cols_remap = np.zeros((self.n_pad, W), dtype=np.int32)
        for q in range(P):
            rows = slice(q * nl, (q + 1) * nl)
            c_q = cols[rows]
            o_q = owner[rows]
            rm = np.zeros_like(c_q, dtype=np.int64)
            loc = o_q == q
            rm[loc] = c_q[loc] - q * nl
            for p in range(P):
                if p == q:
                    continue
                sel = o_q == p
                if not np.any(sel):
                    continue
                pos = np.searchsorted(need[q][p], c_q[sel])
                rm[sel] = nl + p * cap + pos
            rm[~live[rows]] = 0
            cols_remap[rows] = rm.astype(np.int32)

        shard_b = NamedSharding(mesh, P_(axis))
        self.vec_sharding = shard_b
        put = lambda a: jax.device_put(jnp.asarray(a), shard_b)
        self._send_idx = put(send_idx)                      # (P, P, cap)
        self._cols = put(cols_remap.reshape(P, nl, W))      # (P, nl, W)
        self._vre = put(vre.reshape(P, nl, W))
        self._vim = put(vim.reshape(P, nl, W)) if vim is not None else None
        self._diag = put(diag.reshape(P, nl))
        self._halo_nnz = int(sum(need[q][p].size
                                 for q in range(P) for p in range(P)))

        axis_name = axis

        def body(send_idx, colsb, vreb, vimb, diagb, x_parts):
            """One shard's rows. x_parts: tuple of local (nl,) vectors
            (re,) or (re, im) — exchanged in ONE all_to_all."""
            send_idx = send_idx[0]          # (P, cap)
            colsb = colsb[0]
            diagb = diagb[0]
            vreb_ = vreb[0]
            vimb_ = vimb[0] if vimb is not None else None
            nparts = len(x_parts)
            # (P, nparts, cap) send buffer: what this shard provides
            send = jnp.stack([x[send_idx] for x in x_parts], axis=1)
            halo = jax.lax.all_to_all(send, axis_name, split_axis=0,
                                      concat_axis=0, tiled=False)
            outs = []
            for i in range(nparts):
                buf = jnp.concatenate(
                    [x_parts[i], halo[:, i, :].reshape(-1)])
                outs.append(buf[colsb])     # (nl, W)
            gr = outs[0]
            gi = outs[1] if nparts == 2 else None
            xr = x_parts[0]
            xi = x_parts[1] if nparts == 2 else None
            yr = diagb * xr + jnp.sum(vreb_ * gr, axis=1)
            yi = None
            if gi is not None:
                yi = diagb * xi + jnp.sum(vreb_ * gi, axis=1)
            if vimb_ is not None:
                if gi is not None:
                    yr = yr - jnp.sum(vimb_ * gi, axis=1)
                add = jnp.sum(vimb_ * gr, axis=1)
                yi = add if yi is None else yi + add
            return yr if yi is None else (yr, yi)

        has_im = self._vim is not None

        def sharded_real(send_idx, colsb, vreb, diagb, x_re):
            return body(send_idx, colsb, vreb, None, diagb,
                        (x_re.reshape(-1),))

        def sharded_real_im(send_idx, colsb, vreb, vimb, diagb, x_re):
            return body(send_idx, colsb, vreb, vimb, diagb,
                        (x_re.reshape(-1),))

        def sharded_cplx(send_idx, colsb, vreb, vimb, diagb, x_re, x_im):
            return body(send_idx, colsb, vreb, vimb, diagb,
                        (x_re.reshape(-1), x_im.reshape(-1)))

        S = P_(axis)
        kw = dict(mesh=mesh)
        if has_im:
            # a complex-H real-x apply still yields (yr, yi)
            self._apply_real_raw = jax.shard_map(
                sharded_real_im, in_specs=(S,) * 6,
                out_specs=(S, S), **kw)
        else:
            self._apply_real_raw = jax.shard_map(
                sharded_real, in_specs=(S,) * 5, out_specs=S, **kw)
        self._apply_cplx_raw = jax.shard_map(
            sharded_cplx, in_specs=(S,) * 7,
            out_specs=(S, S), **kw)
        self._apply_real = jax.jit(self._apply_real_raw)
        self._apply_cplx = jax.jit(self._apply_cplx_raw)

    # ------------------------------------------------------------- protocol

    @property
    def nnz(self) -> int:
        return self.n * (int(self._vre.shape[-1]) + 1)

    @property
    def params(self):
        if self._vim is None:
            return (self._send_idx, self._cols, self._vre, self._diag)
        return (self._send_idx, self._cols, self._vre, self._vim, self._diag)

    def _run(self, real_fn, cplx_fn, params, x):
        x_re, x_im = x
        if x_im is None:
            out = real_fn(*params, x_re)
            if self.is_complex:
                return out          # (yr, yi): complex H on a real vector
            return (out, None)
        if not self.is_complex:
            yr = real_fn(*params, x_re)
            yi = real_fn(*params, x_im)
            return (yr, yi)
        return cplx_fn(*params, x_re, x_im)

    def apply(self, params, x):
        return self._run(self._apply_real_raw, self._apply_cplx_raw,
                         params, x)

    def __call__(self, x):
        return self._run(self._apply_real, self._apply_cplx,
                         self.params, x)

    # ------------------------------------------------------------ vector IO

    def pad(self, x):
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
        re = np.asarray(x[0])[: self.n]
        im = None if x[1] is None else np.asarray(x[1])[: self.n]
        return (re, im)

    # ---------------------------------------------------------- diagnostics

    def halo_stats(self) -> dict:
        """Exchange volume diagnostics vs the all-gather strategy."""
        allgather = self.n_pad * (self.P - 1)
        exchanged = self.P * (self.P - 1) * self.halo_cap
        return {
            "halo_nnz": self._halo_nnz,
            "pair_capacity": self.halo_cap,
            "exchanged_per_apply": exchanged,
            "allgather_per_apply": allgather,
            "traffic_ratio": exchanged / max(allgather, 1),
        }
