"""Matrix-free operator application on device.

The hot path of the framework — the device equivalent of
``model::MultMv2`` (reference: src/model.cc:941-1121). Per row block:

1. decode slot values V and fermion counts F (precomputed, int8);
2. joint columns c = V[slots] . jstrides  — batched gathers + tiny dot;
3. Jordan-Wigner parities for ALL terms at once: (F @ W^T) mod 2 — one
   small f32 matmul (replaces per-state fermion scans);
4. table lookups amp/delta, target labels, index lookup (one gather for the
   direct table; log N gathers for binary search);
5. y[i] = diag[i] x[i] + sum conj(amp) * sign * x[j]  — the Hermitian
   row-gather trick: applying H to basis state i enumerates <j|H|i>, so row
   i of H is the conjugate — every row is computed independently with NO
   scatters (the reference needed critical sections, src/model.cc:1529-1533).

Row blocks are processed with ``lax.map`` to bound peak memory
((B, T, K) intermediates) and pipeline HBM traffic.
"""

from __future__ import annotations

import math

import numpy as np

from quantum_basis_tpu.basis.index import BasisIndex
from quantum_basis_tpu.ops.compile import CompiledOperator, compile_diagonal

# target elements per (B, T, K) intermediate; keeps block arrays ~128 MB
_BLOCK_BUDGET = 1 << 24


def _choose_block(n: int, work_per_row: int) -> int:
    b = max(1024, _BLOCK_BUDGET // max(work_per_row, 1))
    b = 1 << int(math.floor(math.log2(b)))
    return int(min(b, n))


class DeviceBasis:
    """Device-resident per-state data, padded into uniform row blocks.

    Holds labels (nb, B), decoded slot values V (nb, B, S) int8, fermion
    counts F (nb, B, S) int8 — shared by the Hamiltonian apply and all
    measurement operators on the same sector.
    """

    def __init__(self, space, labels: np.ndarray, index: BasisIndex | None = None,
                 block_rows: int | None = None, work_per_row: int = 16):
        import jax.numpy as jnp

        labels = np.asarray(labels, dtype=np.int64)
        self.space = space
        self.n = int(labels.size)
        if index is None:
            from quantum_basis_tpu.basis.lin_table import digit_split

            index = BasisIndex(labels, space.label_space,
                               lin_split=digit_split(space))
        self.index = index
        B = block_rows or _choose_block(self.n, work_per_row * space.n_slots)
        nb = max(1, (self.n + B - 1) // B)
        pad = nb * B - self.n
        lab_pad = np.concatenate([labels, np.full(pad, labels[0] if self.n else 0,
                                                  dtype=np.int64)])
        V = space.decode(lab_pad)  # numpy path
        F = np.take_along_axis(space.fermion_count_table,
                               V.astype(np.int64).T, axis=1).T  # (nb*B, S)
        self.block_rows = B
        self.n_blocks = nb
        self.pad = pad
        self.labels_b = jnp.asarray(lab_pad.reshape(nb, B))
        self.V_b = jnp.asarray(V.reshape(nb, B, space.n_slots).astype(np.int8))
        self.F_b = jnp.asarray(F.reshape(nb, B, space.n_slots).astype(np.int8))
        self.labels_np = labels

    def pad_vec(self, x):
        import jax.numpy as jnp

        return jnp.pad(x, (0, self.pad)).reshape(self.n_blocks, self.block_rows)


def _group_device(group):
    """Move one TermGroup's tables to device, flattening (T, D) for lookup."""
    import jax.numpy as jnp

    T, D, K = group.dlt.shape
    return dict(
        slots=jnp.asarray(group.slots.astype(np.int32)),        # (T, k)
        jstrides=jnp.asarray(group.jstrides),                   # (T, k)
        dlt=jnp.asarray(group.dlt.reshape(T * D, K)),           # (T*D, K)
        amp_re=jnp.asarray(group.amp_re.reshape(T * D, K)),
        amp_im=None if group.amp_im is None
        else jnp.asarray(group.amp_im.reshape(T * D, K)),
        Wf=jnp.asarray(group.W.T.astype(np.float32)),           # (S, T)
        D=D,
        T=T,
        K=K,
    )


def _block_images(g, labels, V, F):
    """Per block: (sign (B,T), amp tables (B,T,K), target labels (B,T,K))."""
    import jax
    import jax.numpy as jnp

    Vg = V.astype(jnp.int64)[:, g["slots"]]                      # (B, T, k)
    c = jnp.sum(Vg * g["jstrides"][None], axis=-1)               # (B, T)
    par = jnp.dot(F.astype(jnp.float32), g["Wf"],               # (B, T) counts
                  precision=jax.lax.Precision.HIGHEST)
    sign = 1.0 - 2.0 * jnp.mod(par, 2.0)                         # (B, T) f32
    flat = jnp.arange(g["T"], dtype=jnp.int64)[None, :] * g["D"] + c
    amp_re = g["amp_re"][flat]                                   # (B, T, K)
    amp_im = None if g["amp_im"] is None else g["amp_im"][flat]
    tgt = labels[:, None, None] + g["dlt"][flat]                 # (B, T, K)
    return sign.astype(jnp.float64), amp_re, amp_im, tgt


def apply_block_rows(groups, index, itabs, labels, V, F, diag, xb, x):
    """One block of rows of y = H x (Hermitian row-gather direction).

    ``xb`` is this block's slice of x, ``x`` the full (or all-gathered)
    vector the gathers read from; both are split-complex cvecs. Shared by the
    single-chip :class:`MatvecFull` and the sharded apply in
    :mod:`quantum_basis_tpu.parallel.apply_sharded`.
    """
    import jax.numpy as jnp

    xb_re, xb_im = xb
    x_re, x_im = x
    y_re = diag * xb_re
    y_im = None if xb_im is None else diag * xb_im
    for g in groups:
        sign, amp_re, amp_im, tgt = _block_images(g, labels, V, F)
        j = index.lookup_t(itabs, tgt)
        xr = x_re[j]
        xi = None if x_im is None else x_im[j]
        # y[i] += conj(amp) * sign * x[j]
        s = sign[..., None]
        cr = amp_re * xr
        if amp_im is not None and xi is not None:
            cr = cr + amp_im * xi
        y_re = y_re + jnp.sum(s * cr, axis=(1, 2))
        if y_im is not None:
            ci = amp_re * (xi if xi is not None else 0.0) - amp_im * xr \
                if amp_im is not None else amp_re * xi
            y_im = y_im + jnp.sum(s * ci, axis=(1, 2))
    return y_re, y_im


class MatvecFull:
    """Matrix-free y = H x over a fixed basis (full or quantum-number sector).

    ``H`` must be Hermitian and conserve the sector (every image stays in the
    basis). Use :func:`mopr_x_vec` for general operators.
    """

    def __init__(self, compiled: CompiledOperator, dbasis: DeviceBasis):
        import jax
        import jax.numpy as jnp

        self.compiled = compiled
        self.basis = dbasis
        self.n = dbasis.n
        space = compiled.space
        self.groups = [_group_device(g) for g in compiled.groups]
        self.is_complex = any(g["amp_im"] is not None for g in self.groups)

        # precompute the diagonal once (reference: Ham_diag fast path)
        if compiled.diag_terms.q_zero():
            diag = np.zeros(dbasis.n_blocks * dbasis.block_rows, dtype=np.float64)
            self.diag_b = jnp.asarray(diag.reshape(dbasis.n_blocks, -1))
        else:
            ev = compile_diagonal(compiled.diag_terms, space)
            self.diag_b = jax.jit(ev)(dbasis.V_b.astype(jnp.int32))
        index = dbasis.index
        groups = self.groups
        basis = dbasis

        # NOTE: the per-state arrays are passed as ARGUMENTS, not captured as
        # jit closure constants — capturing them lets XLA attempt compile-time
        # constant folding of all the (x-independent) index arithmetic, which
        # blows compilation time up by orders of magnitude.
        def apply_real(itabs, labels_b, V_b, F_b, diag_b, x_re):
            xb = basis.pad_vec(x_re)
            y = jax.lax.map(
                lambda a: apply_block_rows(
                    groups, index, itabs, a[0], a[1], a[2], a[3],
                    (a[4], None), (x_re, None))[0],
                (labels_b, V_b, F_b, diag_b, xb),
            )
            return y.reshape(-1)[: self.n]

        def apply_cplx(itabs, labels_b, V_b, F_b, diag_b, x_re, x_im):
            xbr = basis.pad_vec(x_re)
            xbi = basis.pad_vec(x_im)
            y_re, y_im = jax.lax.map(
                lambda a: apply_block_rows(
                    groups, index, itabs, a[0], a[1], a[2], a[3],
                    (a[4], a[5]), (x_re, x_im)),
                (labels_b, V_b, F_b, diag_b, xbr, xbi),
            )
            return y_re.reshape(-1)[: self.n], y_im.reshape(-1)[: self.n]

        self._apply_real_raw = apply_real
        self._apply_cplx_raw = apply_cplx
        self._apply_real = jax.jit(apply_real)
        self._apply_cplx = jax.jit(apply_cplx)

    @property
    def params(self):
        """Device arrays to thread through outer jits as ARGUMENTS (see note
        above — solvers must pass these explicitly, not capture them)."""
        b = self.basis
        return (b.index.tables, b.labels_b, b.V_b, b.F_b, self.diag_b)

    def apply(self, params, x):
        """Pure traceable apply: params from :attr:`params`, x=(re, im|None)."""
        itabs, labels_b, V_b, F_b, diag_b = params
        x_re, x_im = x
        if x_im is None:
            if self.is_complex:
                raise ValueError("complex Hamiltonian applied to real vector")
            return (self._apply_real_raw(itabs, labels_b, V_b, F_b, diag_b, x_re), None)
        yr, yi = self._apply_cplx_raw(itabs, labels_b, V_b, F_b, diag_b, x_re, x_im)
        return (yr, yi)

    def __call__(self, x):
        """x = (re, im|None) -> (re, im|None)."""
        x_re, x_im = x
        if x_im is None:
            if self.is_complex:
                raise ValueError("complex Hamiltonian applied to real vector")
            return (self._apply_real(*self.params, x_re), None)
        yr, yi = self._apply_cplx(*self.params, x_re, x_im)
        return (yr, yi)

    @property
    def nnz_estimate(self) -> int:
        """Upper bound on stored nonzeros (incl. diagonal) for benchmarks."""
        return self.n * (1 + self.compiled.nnz_per_row)


def mopr_x_vec(compiled: CompiledOperator, src: DeviceBasis, dst: DeviceBasis, x):
    """General (non-Hermitian-trick) application: y = O x, scatter direction.

    ``src``/``dst`` may be different sectors (e.g. A_q maps Sz -> Sz-1 for
    dynamical structure factors; reference: model::moprXvec_full,
    src/model.cc:1468-1548). Images that leave ``dst`` are dropped, matching
    the reference's binary-search miss behavior.
    """
    import jax
    import jax.numpy as jnp

    x_re, x_im = x
    groups = [_group_device(g) for g in compiled.groups]
    has_im = any(g["amp_im"] is not None for g in groups) or x_im is not None

    if not compiled.diag_terms.q_zero():
        ev = compile_diagonal(compiled.diag_terms, compiled.space)
        diag_b = jax.jit(ev)(src.V_b.astype(jnp.int32))
    else:
        diag_b = None

    offsets = jnp.arange(src.n_blocks, dtype=jnp.int64) * src.block_rows
    row_iota = np.arange(src.block_rows)

    def block_contrib(y_re, y_im, labels, V, F, diag, xr, xi, base):
        row_ok = (base + row_iota) < src.n
        if diag is not None:
            j, valid = dst.index.lookup_checked(labels)
            y_re = y_re.at[j].add(jnp.where(valid & row_ok, diag * xr, 0.0))
            if y_im is not None and xi is not None:
                y_im = y_im.at[j].add(jnp.where(valid & row_ok, diag * xi, 0.0))
        for g in groups:
            sign, amp_re, amp_im, tgt = _block_images(g, labels, V, F)
            j, valid = dst.index.lookup_checked(tgt)
            ok = valid & row_ok[:, None, None]
            s = jnp.where(ok, sign[..., None], 0.0)
            # y[j] += amp * sign * x[i]   (no conjugate: forward direction)
            cr = amp_re * xr[:, None, None]
            ci = amp_re * xi[:, None, None] if xi is not None else None
            if amp_im is not None:
                if xi is not None:
                    cr = cr - amp_im * xi[:, None, None]
                    ci = ci + amp_im * xr[:, None, None]
                else:
                    ci = amp_im * xr[:, None, None]
            y_re = y_re.at[j.reshape(-1)].add((s * cr).reshape(-1))
            if y_im is not None and ci is not None:
                y_im = y_im.at[j.reshape(-1)].add((s * ci).reshape(-1))
        return y_re, y_im

    def run(x_re, x_im):
        xbr = src.pad_vec(x_re)
        xbi = src.pad_vec(x_im) if x_im is not None else None
        y0_re = jnp.zeros(dst.n, dtype=jnp.float64)
        y0_im = jnp.zeros(dst.n, dtype=jnp.float64) if has_im else None

        def body(carry, xs):
            y_re, y_im = carry
            if xbi is not None and diag_b is not None:
                labels, V, F, diag, xr, xi, base = xs
            elif xbi is not None:
                labels, V, F, xr, xi, base = xs
                diag = None
            elif diag_b is not None:
                labels, V, F, diag, xr, base = xs
                xi = None
            else:
                labels, V, F, xr, base = xs
                xi = None
                diag = None
            y_re, y_im = block_contrib(y_re, y_im, labels, V, F, diag, xr, xi, base)
            return (y_re, y_im), None

        xs = [src.labels_b, src.V_b, src.F_b]
        if diag_b is not None:
            xs.append(diag_b)
        xs.append(xbr)
        if xbi is not None:
            xs.append(xbi)
        xs.append(offsets)
        (y_re, y_im), _ = jax.lax.scan(body, (y0_re, y0_im), tuple(xs))
        return y_re, y_im

    if x_im is not None:
        y_re, y_im = jax.jit(run)(x_re, x_im)
    else:
        y_re, y_im = jax.jit(lambda a: run(a, None))(x_re)
    return (y_re, y_im)
