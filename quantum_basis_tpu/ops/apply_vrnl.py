"""Operator application in the variational (vrnl) sector.

Device counterparts of ``model::MultMv`` over the explicit vrnl matrix,
``moprXgs_vrnl`` (reference: src/model.cc:1915-1984), ``moprXvec_vrnl``
(src/model.cc:1987-2074), and ``measure_vrnl_static_trans_invariant``
(src/model.cc:2077-2129). All use the batched canonicalization from
:class:`quantum_basis_tpu.basis.vrnl.CenterTranslator`; phases follow the
2*pi-ful convention documented there.

Deliberate divergence from the reference: ``translate2center_OBC`` computes
the fermion parity of the canonicalizing translation and then discards it
(src/basis.cc:678-680 — ``int sgn`` never applied), so the reference's whole
vrnl sector silently drops translation signs for fermionic states. We keep
them (the ``csign`` factor from ``canonicalize_vf``) — identical for
spin/boson polarons, physically correct for fermionic ones.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu.ops.apply import _block_images, _group_device
from quantum_basis_tpu.ops.compile import (CompiledOperator,
                                            compile_diagonal_complex)


class MatvecVrnl:
    """y = H_vrnl(k) x from a momentum-rephased COO skeleton, on device.

    rows are sorted ascending (by construction of VrnlMatrix), so the
    scatter-add is a segmented reduction XLA handles well. Entries are
    split-complex; the vrnl sector is always treated as complex (phases).
    """

    def __init__(self, vmat, momentum, upper_triangle: bool = True):
        import jax.numpy as jnp

        self.n = vmat.n
        self.is_complex = True
        momentum = np.asarray(momentum, dtype=np.float64)
        ang = 2.0 * np.pi * (vmat.disp @ momentum)
        amp = (vmat.amp_re + 1j * vmat.amp_im) * np.exp(1j * ang)
        val = np.conj(amp)
        rows, cols = vmat.rows, vmat.cols
        if upper_triangle:
            # keep i <= j; apply strict-upper entries mirrored (conjugate
            # transpose) — same Hermitization-by-construction as the
            # reference's upper-triangle build + Hermitian SpMV descriptor
            # (src/model.cc:910-918, src/sparse.cc:276-301).
            keep = rows <= cols
            rows, cols, val = rows[keep], cols[keep], val[keep]
        order = np.argsort(rows, kind="stable")
        rows, cols, val = rows[order], cols[order], val[order]
        self._upper = upper_triangle
        self._rows = jnp.asarray(rows.astype(np.int32))
        self._cols = jnp.asarray(cols.astype(np.int32))
        self._vre = jnp.asarray(val.real)
        self._vim = jnp.asarray(val.imag)
        strict = rows < cols
        self._srows = jnp.asarray(rows[strict].astype(np.int32))
        self._scols = jnp.asarray(cols[strict].astype(np.int32))
        self._svre = jnp.asarray(val.real[strict])
        self._svim = jnp.asarray(val.imag[strict])
        self._diag = jnp.asarray(vmat.diag)

    @property
    def params(self):
        return (self._rows, self._cols, self._vre, self._vim,
                self._srows, self._scols, self._svre, self._svim, self._diag)

    def apply(self, params, x):
        import jax.numpy as jnp

        rows, cols, vre, vim, srows, scols, svre, svim, diag = params
        xr, xi = x
        if xi is None:
            xi = jnp.zeros_like(xr)
        gr = xr[cols]
        gi = xi[cols]
        yr = (diag * xr).at[rows].add(vre * gr - vim * gi)
        yi = (diag * xi).at[rows].add(vre * gi + vim * gr)
        if self._upper:
            # mirrored strict-lower part: H[j, i] = conj(H[i, j])
            hr = xr[srows]
            hi = xi[srows]
            yr = yr.at[scols].add(svre * hr + svim * hi)
            yi = yi.at[scols].add(svre * hi - svim * hr)
        return (yr, yi)

    def __call__(self, x):
        import jax

        return jax.jit(self.apply)(self.params, x)


def _images_canon(compiled: CompiledOperator, ct, labels_dev):
    """All images of a batch of labels with canonical form + displacement.

    Returns a list per term-group of numpy arrays
    (amp (B, M) complex incl. canonicalization sign, canon (B, M) int64,
    disp (B, M, dim) int64). Used by the gs/vec application paths.
    """
    import jax
    import jax.numpy as jnp

    space = ct.space
    groups = [_group_device(g) for g in compiled.groups]

    @jax.jit
    def run(lab):
        V, F = ct._decode(lab)
        outs = []
        for g in groups:
            sign, amp_re, amp_im, tgt = _block_images(g, lab, V, F)
            B = lab.shape[0]
            tgt_f = tgt.reshape(B, -1)
            M = tgt_f.shape[1]
            ar = (sign[..., None] * amp_re).reshape(B, M)
            ai = ((sign[..., None] * amp_im).reshape(B, M)
                  if amp_im is not None else jnp.zeros((B, M)))
            Vt = space.decode(tgt_f.reshape(-1))
            Ft = jnp.asarray(space.fermion_count_table)[
                jnp.arange(space.n_slots)[None, :], Vt.astype(jnp.int64)]
            canon, disp, csign = ct.canonicalize_vf(tgt_f.reshape(-1), Vt, Ft)
            outs.append((ar * csign.reshape(B, M),
                         ai * csign.reshape(B, M),
                         canon.reshape(B, M), disp.reshape(B, M, -1)))
        return outs

    out = []
    for ar, ai, canon, disp in run(labels_dev):
        out.append((np.asarray(ar) + 1j * np.asarray(ai),
                    np.asarray(canon), np.asarray(disp)))
    return out


def mopr_x_gs_vrnl(Bq, sector, ct) -> np.ndarray:
    """vec[j] = sqrt(omega_g) sum <gs| T-canon | Bq_dagger basis[j]> phases.

    Reference: model::moprXgs_vrnl (src/model.cc:1915-1984) — builds
    B_q |gs,k> expressed over the vrnl basis at the sector momentum.
    """
    import jax.numpy as jnp

    from quantum_basis_tpu.ops.compile import compile_operator

    Bq_dg = compile_operator(Bq.dagger(), ct.space)
    labels = sector.labels
    momentum = np.asarray(sector.momentum, dtype=np.float64)
    sqrt_wg = np.sqrt(float(sector.gs_omega))
    vec = np.zeros(labels.size, dtype=np.complex128)
    for amp, canon, disp in _images_canon(Bq_dg, ct, jnp.asarray(labels)):
        hit = canon == sector.gs_label
        if not np.any(hit):
            continue
        ang = 2.0 * np.pi * (disp @ momentum)
        contrib = np.where(hit, np.conj(amp * np.exp(1j * ang)), 0.0)
        vec += sqrt_wg * contrib.sum(axis=1)
    return vec


def mopr_x_vec_vrnl(Bq, sec_old, sec_new, ct, x) -> tuple[np.ndarray, complex]:
    """(y, pG): y = Bq x mapped into the target vrnl sector, pG the amplitude
    shed onto the ground state (reference: src/model.cc:1987-2074).

    ``x`` is a numpy complex vector over sec_old's basis; phases use the
    TARGET sector momentum, matching the reference.
    """
    import jax.numpy as jnp

    from quantum_basis_tpu.ops.compile import compile_operator

    space = ct.space
    compiled = compile_operator(Bq, space)
    labels_old = sec_old.labels
    labels_new = sec_new.labels
    momentum = np.asarray(sec_new.momentum, dtype=np.float64)
    sqrt_wg = np.sqrt(float(sec_new.gs_omega))
    x = np.asarray(x, dtype=np.complex128)
    y = np.zeros(labels_new.size, dtype=np.complex128)
    pG = 0.0 + 0.0j

    sorter = np.argsort(labels_new)
    lab_sorted = labels_new[sorter]

    # diagonal part: same state, new sector index, no phase (disp = 0)
    if not compiled.diag_terms.q_zero() and lab_sorted.size > 0:
        ev = compile_diagonal_complex(compiled.diag_terms, space)
        dvals = np.asarray(ev(space.decode(labels_old)))
        pos = np.searchsorted(lab_sorted, labels_old)
        pos = np.clip(pos, 0, max(lab_sorted.size - 1, 0))
        ok = lab_sorted[pos] == labels_old
        np.add.at(y, sorter[pos[ok]], (dvals * x)[ok])

    for amp, canon, disp in _images_canon(compiled, ct, jnp.asarray(labels_old)):
        ang = 2.0 * np.pi * (disp @ momentum)
        coef = x[:, None] * amp * np.exp(1j * ang)
        is_gs = canon == sec_new.gs_label
        if float(sec_new.gs_norm) > 1e-12:
            pG += complex(np.sum(np.where(is_gs, coef, 0.0))) / sqrt_wg
        if lab_sorted.size == 0:
            continue  # target basis is only the (removed) gs; pG still counts
        pos = np.searchsorted(lab_sorted, canon.reshape(-1))
        pos = np.clip(pos, 0, max(lab_sorted.size - 1, 0))
        ok = (lab_sorted[pos] == canon.reshape(-1))
        if float(sec_new.gs_norm) > 1e-12:
            ok &= ~is_gs.reshape(-1)
        np.add.at(y, sorter[pos[ok]], coef.reshape(-1)[ok])
    return y, complex(pG)


def measure_vrnl_static(lhs, sector, ct, eigenvec) -> complex:
    """<phi| lhs |phi> over a vrnl sector eigenvector (translation-invariant
    lhs assumed; reference: src/model.cc:2077-2129, with the phase fixed to
    the 2*pi-ful convention)."""
    import jax.numpy as jnp

    from quantum_basis_tpu.ops.compile import compile_operator

    space = ct.space
    compiled = compile_operator(lhs, space)
    labels = sector.labels
    momentum = np.asarray(sector.momentum, dtype=np.float64)
    phi = np.asarray(eigenvec, dtype=np.complex128)
    result = 0.0 + 0.0j

    if not compiled.diag_terms.q_zero():
        ev = compile_diagonal_complex(compiled.diag_terms, space)
        dvals = np.asarray(ev(space.decode(labels)))
        result += complex(np.sum(np.abs(phi) ** 2 * dvals))

    sorter = np.argsort(labels)
    lab_sorted = labels[sorter]
    for amp, canon, disp in _images_canon(compiled, ct, jnp.asarray(labels)):
        ang = 2.0 * np.pi * (disp @ momentum)
        coef = phi[:, None] * amp * np.exp(1j * ang)
        pos = np.searchsorted(lab_sorted, canon.reshape(-1))
        pos = np.clip(pos, 0, max(lab_sorted.size - 1, 0))
        ok = lab_sorted[pos] == canon.reshape(-1)
        m = sorter[pos]
        result += complex(np.sum(np.conj(phi[m[ok]]) * coef.reshape(-1)[ok]))
    return result
