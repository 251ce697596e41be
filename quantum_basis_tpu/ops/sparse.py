"""Explicit sparse Hamiltonian: ELL extraction + device SpMV.

Device counterpart of the reference's LIL -> CSR pipeline
(``generate_Ham_sparse_full/repr``, src/model.cc:619-836; ``lil_mat``/
``csr_mat``, src/sparse.cc). Instead of pointer-chasing CSR, rows are stored
fixed-width (ELL): ``cols (n, W) int32`` + split-complex ``vals (n, W)`` +
real ``diag (n,)``. W = max row occupancy after duplicate-column merging.
The SpMV is then one big gather ``x[cols]`` + a row reduction — dense,
statically-shaped work that XLA tiles well; no scatters (the reference's
row-parallel build needed critical sections, and MKL SpMV does pointer
walks).

Build happens in ONE device pass over row blocks, reusing the matrix-free
image machinery (the same loops the reference shares between its sparse
build and its matrix-free MultMv, src/model.cc:619-685 vs 941-1121), then a
host compaction pass merges duplicate columns and trims the width.

Like the reference (explicit matrix = optional speedup chosen after basis
enumeration, src/main_test.cc:76-78), solvers accept either this or the
matrix-free apply through the same (params, apply) protocol.
"""

from __future__ import annotations

import numpy as np

_VAL_TOL = 1e-14  # drop |v| below this (reference sparse_precision)


def _compact_rows_np(cols: np.ndarray, vre: np.ndarray, vim: np.ndarray | None,
                     tol: float = _VAL_TOL):
    """Numpy fallback for duplicate-column merging (see native.compact_rows).

    cols (n, W) int64 with -1 for invalid; returns (cols, vre, vim)
    trimmed to the max surviving row occupancy.
    """
    n, W = cols.shape
    mag = np.abs(vre) + (np.abs(vim) if vim is not None else 0.0)
    cols = np.where(mag > tol, cols, np.int64(2**62))
    order = np.argsort(cols, axis=1, kind="stable")
    cols = np.take_along_axis(cols, order, axis=1)
    vre = np.take_along_axis(vre, order, axis=1)
    if vim is not None:
        vim = np.take_along_axis(vim, order, axis=1)
    # fold runs of equal columns into the run's last slot
    for k in range(W - 1):
        dup = cols[:, k] == cols[:, k + 1]
        vre[:, k + 1] = np.where(dup, vre[:, k + 1] + vre[:, k], vre[:, k + 1])
        vre[:, k] = np.where(dup, 0.0, vre[:, k])
        if vim is not None:
            vim[:, k + 1] = np.where(dup, vim[:, k + 1] + vim[:, k],
                                     vim[:, k + 1])
            vim[:, k] = np.where(dup, 0.0, vim[:, k])
        cols[:, k] = np.where(dup, np.int64(2**62), cols[:, k])
    mag = np.abs(vre) + (np.abs(vim) if vim is not None else 0.0)
    valid = (mag > tol) & (cols < 2**62)
    # stable re-sort pushing invalid entries right
    order = np.argsort(np.where(valid, 0, 1), axis=1, kind="stable")
    cols = np.take_along_axis(cols, order, axis=1)
    vre = np.take_along_axis(vre, order, axis=1)
    if vim is not None:
        vim = np.take_along_axis(vim, order, axis=1)
    valid = np.take_along_axis(valid, order, axis=1)
    width = int(valid.sum(axis=1).max()) if n else 0
    cols = np.where(valid, cols, 0)
    vre = np.where(valid, vre, 0.0)
    if vim is not None:
        vim = np.where(valid, vim, 0.0)
    return cols[:, :width], vre[:, :width], (vim[:, :width]
                                             if vim is not None else None)


class EllMatrix:
    """Explicit H over a sector basis in ELL layout (device-resident)."""

    def __init__(self, cols, vre, vim, diag):
        import jax.numpy as jnp

        self.n = int(diag.shape[0])
        self.width = int(cols.shape[1]) if cols.size else 0
        self.is_complex = vim is not None
        self.cols = jnp.asarray(cols.astype(np.int32))
        self.vre = jnp.asarray(vre)
        self.vim = None if vim is None else jnp.asarray(vim)
        self.diag = jnp.asarray(diag)

    @property
    def nnz(self) -> int:
        """Stored nonzeros incl. diagonal (for nnz/s metrics)."""
        return self.n * (self.width + 1)

    @property
    def params(self):
        return (self.cols, self.vre, self.vim, self.diag)

    def apply(self, params, x):
        import jax.numpy as jnp

        cols, vre, vim, diag = params
        xr, xi = x
        gr = xr[cols]                                   # (n, W)
        yr = diag * xr + jnp.sum(vre * gr, axis=1)
        if xi is None and vim is None:
            return (yr, None)
        xi_ = xi if xi is not None else jnp.zeros_like(xr)
        gi = xi_[cols]
        if vim is None:
            yi = diag * xi_ + jnp.sum(vre * gi, axis=1)
        else:
            yr = yr + jnp.sum(-vim * gi, axis=1)
            yi = diag * xi_ + jnp.sum(vre * gi + vim * gr, axis=1)
        return (yr, yi)

    def __call__(self, x):
        import jax

        return jax.jit(self.apply)(self.params, x)


def _extract_blocks(run_block, n_blocks, n, block_rows, diag_b):
    """Shared assembly: run the jitted per-block extractor, compact on host."""
    cols_list, vre_list, vim_list = [], [], []
    any_im = False
    for b in range(n_blocks):
        c, vr, vi = run_block(b)
        c = np.asarray(c, dtype=np.int64)
        vr = np.asarray(vr)
        vi = None if vi is None else np.asarray(vi)
        any_im = any_im or vi is not None
        from quantum_basis_tpu.native import compact_rows

        c, vr, vi = compact_rows(c, vr, vi, _VAL_TOL)
        cols_list.append(c)
        vre_list.append(vr)
        vim_list.append(vi)
    width = max((c.shape[1] for c in cols_list), default=0)

    def padw(a, fill):
        if a.shape[1] == width:
            return a
        return np.pad(a, ((0, 0), (0, width - a.shape[1])),
                      constant_values=fill)

    cols = np.concatenate([padw(c, 0) for c in cols_list])[:n]
    vre = np.concatenate([padw(v, 0.0) for v in vre_list])[:n]
    if any_im:
        vim = np.concatenate([
            padw(v if v is not None else np.zeros_like(vre_list[i]), 0.0)
            for i, v in enumerate(vim_list)])[:n]
    else:
        vim = None
    diag = np.asarray(diag_b).reshape(-1)[:n]
    return EllMatrix(cols, vre, vim, diag)


def build_sparse_full(matvec) -> EllMatrix:
    """Extract the explicit matrix from a MatvecFull (one device pass).

    Row i's entries are H[i, j] = conj(A) * sign over the images of
    applying each compiled term group to |i> (the same Hermitian row-gather
    direction as the matrix-free apply).
    """
    import jax
    import jax.numpy as jnp

    from quantum_basis_tpu.ops.apply import _block_images

    dbasis = matvec.basis
    groups = matvec.groups
    index = dbasis.index
    itabs = index.tables
    n = dbasis.n

    @jax.jit
    def block(labels, V, F, base):
        row_ok = (base + jnp.arange(labels.shape[0])) < n
        outs = []
        for g in groups:
            sign, amp_re, amp_im, tgt = _block_images(g, labels, V, F)
            j = index.lookup_t(itabs, tgt)
            B = labels.shape[0]
            # H[i, j] = conj(amp) * sign; images always land in the sector
            cr = (sign[..., None] * amp_re).reshape(B, -1)
            ci = (None if amp_im is None
                  else (-sign[..., None] * amp_im).reshape(B, -1))
            ok = row_ok[:, None]
            outs.append((jnp.where(ok, j.reshape(B, -1), -1),
                         jnp.where(ok, cr, 0.0),
                         None if ci is None else jnp.where(ok, ci, 0.0)))
        cols = jnp.concatenate([o[0] for o in outs], axis=1)
        vre = jnp.concatenate([o[1] for o in outs], axis=1)
        if any(o[2] is not None for o in outs):
            vim = jnp.concatenate(
                [o[2] if o[2] is not None else jnp.zeros_like(o[1])
                 for o in outs], axis=1)
        else:
            vim = None
        return cols, vre, vim

    def run_block(b):
        return block(dbasis.labels_b[b], dbasis.V_b[b], dbasis.F_b[b],
                     b * dbasis.block_rows)

    return _extract_blocks(run_block, dbasis.n_blocks, n, dbasis.block_rows,
                           matvec.diag_b)


def build_sparse_repr(matvec) -> EllMatrix:
    """Extract the explicit momentum-sector matrix from a MatvecRepr.

    Same coefficients as the matrix-free repr row kernel:
    H[i, j] = sqrt(nu_j/nu_i) * conj(A) * sigma_{g*} * e^{-i k.R_{g*}}
    (cf. generate_Ham_sparse_repr, src/model.cc:729-829).
    """
    import jax
    import jax.numpy as jnp

    from quantum_basis_tpu.ops.apply import _block_images
    from quantum_basis_tpu.ops.apply_repr import index_labels_eq

    rbasis = matvec.basis
    groups = matvec.groups
    space = matvec.compiled.space
    tset = rbasis.tset
    index = rbasis.index
    itabs = index.tables
    sqrt_nu = rbasis.sqrt_nu
    n = rbasis.n
    Ftab = jnp.asarray(space.fermion_count_table)
    slot_iota = jnp.arange(space.n_slots)
    cos_d, sin_d = matvec.cos_d, matvec.sin_d
    n_pad_idx = matvec.n_pad_idx

    @jax.jit
    def block(labels, V, F, isn, mask):
        outs = []
        for g in groups:
            sign, amp_re, amp_im, tgt = _block_images(g, labels, V, F)
            Vm = space.decode(tgt)
            Fm = Ftab[slot_iota[None, None, None, :], Vm.astype(jnp.int64)]
            tl, tsign = tset.transform_all(Vm, Fm)
            gstar = jnp.argmin(tl, axis=-1)
            rmin = jnp.min(tl, axis=-1)
            sig = jnp.take_along_axis(tsign, gstar[..., None], axis=-1)[..., 0]
            ph_re = cos_d[gstar]
            ph_im = sin_d[gstar]
            j = index.lookup_t(itabs, rmin)
            valid = index_labels_eq(itabs, index, j, rmin)
            jc = jnp.where(valid, j, n_pad_idx)
            w = sign[..., None] * sig * sqrt_nu[jc] * isn[:, None, None] \
                * jnp.where(valid, 1.0, 0.0) * mask[:, None, None]
            a_re = amp_re
            a_im = -amp_im if amp_im is not None else None
            c_re = a_re * ph_re - (a_im * ph_im if a_im is not None else 0.0)
            c_im = a_re * ph_im + (a_im * ph_re if a_im is not None else 0.0)
            B = labels.shape[0]
            outs.append((jnp.where(valid & (w != 0.0), j, -1).reshape(B, -1),
                         (w * c_re).reshape(B, -1),
                         (w * c_im).reshape(B, -1)))
        cols = jnp.concatenate([o[0] for o in outs], axis=1)
        vre = jnp.concatenate([o[1] for o in outs], axis=1)
        vim = jnp.concatenate([o[2] for o in outs], axis=1)
        return cols, vre, vim

    def run_block(b):
        return block(rbasis.labels_b[b], rbasis.V_b[b], rbasis.F_b[b],
                     rbasis.inv_sqrt_nu_b[b], rbasis.mask_b[b])

    ell = _extract_blocks(run_block, rbasis.n_blocks, n, rbasis.block_rows,
                          matvec.diag_b)
    return ell


def hermiticity_exact(ell: EllMatrix, tol: float = 1e-9) -> None:
    """Exact O(nnz) Hermiticity verification of an ELL matrix.

    Parity with the reference's full-matrix check (src/sparse.cc:235-256,
    which walks every CSR entry and exit(99)s on mismatch): every stored
    entry (i, j, v) must be matched by (j, i, conj(v)) to ``tol``. The
    randomized :func:`hermiticity_probe` can miss a single-entry asymmetry
    below its global tolerance; this one cannot. Cost: two host sorts of
    the nnz stream. Raises AssertionError with the worst offender.
    """
    n = ell.n
    W = ell.width
    if W == 0 or n == 0:
        return
    rows = np.repeat(np.arange(n, dtype=np.int64), W)
    cols = np.asarray(ell.cols, dtype=np.int64).reshape(-1)
    vals = np.asarray(ell.vre, dtype=np.float64).reshape(-1).astype(np.complex128)
    if ell.vim is not None:
        vals = vals + 1j * np.asarray(ell.vim, dtype=np.float64).reshape(-1)
    live = np.abs(vals) > 0.0
    rows, cols, vals = rows[live], cols[live], vals[live]

    def _canon(keys, v):
        """Sort by key and merge duplicate keys (defensive; compaction
        normally leaves none)."""
        order = np.argsort(keys, kind="stable")
        k = keys[order]
        v = v[order]
        if k.size and np.any(k[1:] == k[:-1]):
            starts = np.flatnonzero(np.concatenate(([True], k[1:] != k[:-1])))
            v = np.add.reduceat(v, starts)
            k = k[starts]
        return k, v

    k_f, v_f = _canon(rows * n + cols, vals)
    k_t, v_t = _canon(cols * n + rows, np.conj(vals))
    if k_f.shape != k_t.shape or np.any(k_f != k_t):
        # an entry (i,j) has no transpose partner at all
        only_f = np.setdiff1d(k_f, k_t)
        only_t = np.setdiff1d(k_t, k_f)
        bad = int((only_f if only_f.size else only_t)[0])
        raise AssertionError(
            f"H not Hermitian: entry ({bad // n}, {bad % n}) unpaired "
            "(cf. csr_mat check, src/sparse.cc:235-256)")
    err = np.abs(v_f - v_t)
    scale = np.maximum(1.0, np.abs(v_f))
    worst = int(np.argmax(err / scale)) if err.size else 0
    if err.size and err[worst] > tol * scale[worst]:
        i, j = int(k_f[worst] // n), int(k_f[worst] % n)
        raise AssertionError(
            f"H not Hermitian: H[{i},{j}]={v_f[worst]:.12g} vs "
            f"conj(H[{j},{i}])={v_t[worst]:.12g} "
            "(cf. csr_mat check, src/sparse.cc:235-256)")


def hermiticity_probe(matvec_or_ell, n: int, complex_vec: bool,
                      n_probes: int = 3, seed: int = 11, tol: float = 1e-9):
    """Randomized Hermiticity check: <z|Hx> == conj(<x|Hz>).

    The device analog of the reference's full-matrix verification
    (src/sparse.cc:235-256, exit(99) on failure) — O(probes * SpMV) instead
    of O(nnz) host walks; raises AssertionError on failure.
    """
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    mv = matvec_or_ell
    params = mv.params
    for _ in range(n_probes):
        x = rng.normal(size=n)
        z = rng.normal(size=n)
        if complex_vec:
            xc = (jnp.asarray(x), jnp.asarray(rng.normal(size=n)))
            zc = (jnp.asarray(z), jnp.asarray(rng.normal(size=n)))
        else:
            xc = (jnp.asarray(x), None)
            zc = (jnp.asarray(z), None)
        from quantum_basis_tpu.ops import cplx as cx

        hx = mv.apply(params, xc)
        hz = mv.apply(params, zc)
        lr, li = cx.vdot(zc, hx)
        rr, ri = cx.vdot(hz, xc)
        err = abs(float(lr) - float(rr))
        if li is not None or ri is not None:
            err += abs((0.0 if li is None else float(li))
                       - (0.0 if ri is None else float(ri)))
        scale = max(1.0, abs(float(lr)))
        if err > tol * scale:
            raise AssertionError(
                f"H failed the Hermiticity probe: err={err:.3e} "
                "(cf. csr_mat check, src/sparse.cc:235-256)")
