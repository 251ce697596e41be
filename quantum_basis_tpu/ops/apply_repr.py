"""Matrix-free apply in translational-symmetry (momentum) sectors.

Device-side replacement for the reference's momentum-basis Hamiltonian
(generate_Ham_sparse_repr / matrix-free repr MultMv2,
src/model.cc:687-836, 941-1121). Basis vectors are |r,k> = P_k|r>/sqrt(nu_r)
over representatives r (orbit minima) with nu_r > 0.

Row kernel (Hermitian row-gather, no scatters): apply H to the raw product
state |r_i>; for every image |m> with amplitude A (JW sign included),
compute ALL G translated labels of m in one integer matmul, take the orbit
minimum r_j = min_g T_g(m) and the minimizing element g*; then

    y_i += sqrt(nu_j / nu_i) * conj(A) * sigma_{g*} * e^{-i k.R_{g*}} * x_j

where T_{g*}|m> = sigma |r_j> and the phase convention matches
P_k = (1/G) sum_R e^{+i k.R} T(R) (validated against the dense projector
oracle and a chiral-fermion exact solution in tests/test_repr.py). Images whose representative has nu = 0 (or
falls outside the quantum-number sector) are dropped — the reference instead
keeps them with a pushed-up fake diagonal (src/model.cc:723-727).

All math is split-complex f64; the momentum phases make H complex for
generic k (real at k = 0 and k = L/2 when signs allow, but the complex path
is used uniformly).
"""

from __future__ import annotations

import math

import numpy as np

from quantum_basis_tpu.basis.index import BasisIndex
from quantum_basis_tpu.basis.translation import (
    TranslationSet,
    enumerate_reps,
    sector_norms,
)
from quantum_basis_tpu.ops.apply import _group_device, _block_images
from quantum_basis_tpu.ops.compile import CompiledOperator, compile_diagonal

_NU_TOL = 1e-10
_BLOCK_BUDGET = 1 << 22  # (B,T,K,G) intermediates; ~ 32-64 MB each


class ReprBasis:
    """Momentum-sector basis: representatives + norms, blocked for device.

    Built from the quantum-number-sector labels (cf. enumerate_basis_repr,
    src/model.cc:274-487): reps = orbit minima, nu = <r|P_k|r>, keep nu > 0.
    """

    def __init__(self, space, tset: TranslationSet, sector_labels: np.ndarray,
                 momentum, block_rows: int | None = None,
                 work_per_row: int = 16, reps_all: np.ndarray | None = None):
        import jax.numpy as jnp

        self.space = space
        self.tset = tset
        self.momentum = tuple(int(x) for x in np.atleast_1d(momentum))
        if reps_all is None:
            reps_all = enumerate_reps(tset, np.asarray(sector_labels, np.int64))
        nus = sector_norms(tset, reps_all, momentum)
        keep = nus > _NU_TOL
        labels = reps_all[keep]
        self.nus = nus[keep]
        self.n = int(labels.size)
        if self.n == 0:
            raise ValueError(
                f"momentum sector k={self.momentum} is empty (all norms zero)")
        self.labels_np = labels
        self.index = BasisIndex(labels, space.label_space)

        if block_rows is None:
            per_row = max(work_per_row, 1) * max(tset.G, 1)
            b = max(256, _BLOCK_BUDGET // per_row)
            block_rows = 1 << int(math.floor(math.log2(b)))
        B = int(min(block_rows, max(self.n, 1)))
        nb = max(1, (self.n + B - 1) // B)
        pad = nb * B - self.n
        lab_pad = np.concatenate(
            [labels, np.full(pad, labels[0] if self.n else 0, np.int64)])
        nu_pad = np.concatenate([self.nus, np.full(pad, 1.0)])
        V = space.decode(lab_pad)
        F = np.take_along_axis(space.fermion_count_table,
                               V.astype(np.int64).T, axis=1).T
        self.block_rows = B
        self.n_blocks = nb
        self.pad = pad
        self.labels_b = jnp.asarray(lab_pad.reshape(nb, B))
        self.V_b = jnp.asarray(V.reshape(nb, B, space.n_slots).astype(np.int8))
        self.F_b = jnp.asarray(F.reshape(nb, B, space.n_slots).astype(np.int8))
        self.inv_sqrt_nu_b = jnp.asarray((1.0 / np.sqrt(nu_pad)).reshape(nb, B))
        self.sqrt_nu = jnp.asarray(np.sqrt(np.concatenate(
            [self.nus, [1.0]])))  # index n = padding slot for invalid lookups
        # row validity mask (padding rows excluded)
        row_id = np.arange(nb * B).reshape(nb, B)
        self.mask_b = jnp.asarray((row_id < self.n).astype(np.float64))

    def pad_vec(self, x):
        import jax.numpy as jnp

        return jnp.pad(x, (0, self.pad)).reshape(self.n_blocks, self.block_rows)

    def from_full(self, x_full):
        """Repr coefficients of a full-label-space sector-k vector.

        A normalized |psi> with P_k|psi> = |psi> expands over the repr basis
        |r,k> = P_k|r>/sqrt(nu_r) as c_r = <r,k|psi> = psi[r]/sqrt(nu_r) —
        one gather at the representative labels (see
        ops/translate_fullspace.py). Returns a normalized split-complex pair.
        """
        import jax.numpy as jnp

        idx = jnp.asarray(self.labels_np)
        w = jnp.asarray(1.0 / np.sqrt(self.nus))
        re, im = x_full
        cr = re[idx].astype(jnp.float64) * w
        ci = im[idx].astype(jnp.float64) * w if im is not None else None
        nrm = jnp.sqrt(jnp.sum(cr * cr) + (jnp.sum(ci * ci)
                                           if ci is not None else 0.0))
        inv = 1.0 / jnp.maximum(nrm, 1e-300)
        return (cr * inv, ci * inv if ci is not None else None)


class MatvecRepr:
    """y = H x in a momentum sector; split-complex, matrix-free."""

    def __init__(self, compiled: CompiledOperator, rbasis: ReprBasis):
        import jax
        import jax.numpy as jnp

        self.compiled = compiled
        self.basis = rbasis
        self.n = rbasis.n
        space = compiled.space
        tset = rbasis.tset
        self.groups = [_group_device(g) for g in compiled.groups]
        self.is_complex = True

        if compiled.diag_terms.q_zero():
            self.diag_b = jnp.zeros((rbasis.n_blocks, rbasis.block_rows))
        else:
            ev = compile_diagonal(compiled.diag_terms, space)
            self.diag_b = jax.jit(ev)(rbasis.V_b.astype(jnp.int32))
        cos, sin = tset.phases(rbasis.momentum)
        self.cos_d = jnp.asarray(cos)
        self.sin_d = jnp.asarray(sin)
        index = rbasis.index
        groups = self.groups
        Ftab = jnp.asarray(space.fermion_count_table)
        slot_iota = jnp.arange(space.n_slots)

        def block_fn(itabs, sqrt_nu, labels, V, F, diag, isn, mask,
                     xb_re, xb_im, x_re, x_im):
            y_re = diag * xb_re
            y_im = diag * xb_im
            for g in groups:
                sign, amp_re, amp_im, tgt = _block_images(g, labels, V, F)
                # decode every image and scan its full translation orbit
                Vm = space.decode(tgt)                        # (B,T,K,S)
                Fm = Ftab[slot_iota[None, None, None, :], Vm.astype(jnp.int64)]
                tl, tsign = tset.transform_all(Vm, Fm)        # (B,T,K,G)
                gstar = jnp.argmin(tl, axis=-1)               # (B,T,K)
                rmin = jnp.min(tl, axis=-1)
                sig = jnp.take_along_axis(
                    tsign, gstar[..., None], axis=-1)[..., 0]
                ph_re = self.cos_d[gstar]
                ph_im = self.sin_d[gstar]
                j = index.lookup_t(itabs, rmin)
                valid = index_labels_eq(itabs, index, j, rmin)
                jc = jnp.where(valid, j, self.n_pad_idx)
                w = sign[..., None] * sig * sqrt_nu[jc] * isn[:, None, None] \
                    * jnp.where(valid, 1.0, 0.0)
                # coeff = w * conj(A) * (ph_re + i ph_im)
                a_re = amp_re
                a_im = -amp_im if amp_im is not None else None
                c_re = a_re * ph_re - (a_im * ph_im if a_im is not None else 0.0)
                c_im = a_re * ph_im + (a_im * ph_re if a_im is not None else 0.0)
                xr = x_re[jnp.where(valid, j, 0)]
                xi = x_im[jnp.where(valid, j, 0)]
                y_re = y_re + jnp.sum(w * (c_re * xr - c_im * xi), axis=(1, 2))
                y_im = y_im + jnp.sum(w * (c_re * xi + c_im * xr), axis=(1, 2))
            return y_re * mask, y_im * mask

        basis = rbasis
        self.n_pad_idx = self.n  # sqrt_nu's padding slot

        def apply_cplx(itabs, sqrt_nu, labels_b, V_b, F_b, diag_b, isn_b,
                       mask_b, x_re, x_im):
            xbr = basis.pad_vec(x_re)
            xbi = basis.pad_vec(x_im)
            y_re, y_im = jax.lax.map(
                lambda a: block_fn(itabs, sqrt_nu, a[0], a[1], a[2], a[3],
                                   a[4], a[5], a[6], a[7], x_re, x_im),
                (labels_b, V_b, F_b, diag_b, isn_b, mask_b, xbr, xbi),
            )
            return y_re.reshape(-1)[: self.n], y_im.reshape(-1)[: self.n]

        self._apply_cplx_raw = apply_cplx
        self._apply_cplx = jax.jit(apply_cplx)

    @property
    def params(self):
        b = self.basis
        return (b.index.tables, b.sqrt_nu, b.labels_b, b.V_b, b.F_b,
                self.diag_b, b.inv_sqrt_nu_b, b.mask_b)

    def apply(self, params, x):
        import jax.numpy as jnp

        x_re, x_im = x
        if x_im is None:
            x_im = jnp.zeros_like(x_re)
        yr, yi = self._apply_cplx_raw(*params, x_re, x_im)
        return (yr, yi)

    def __call__(self, x):
        import jax.numpy as jnp

        x_re, x_im = x
        if x_im is None:
            x_im = jnp.zeros_like(x_re)
        yr, yi = self._apply_cplx(*self.params, x_re, x_im)
        return (yr, yi)


def mopr_x_vec_repr(compiled, src: ReprBasis, dst: ReprBasis, x):
    """y = A x across momentum sectors (forward scatter direction).

    The device moprXvec_repr (reference: src/model.cc:1715-1856). ``A``
    must carry a definite momentum transfer q with dst.momentum = k_src - q
    for A = sum_x e^{-i q.x} O_x (the double projection P_k' A P_k then
    collapses to P_k' A):

        y_j = sum_i x_i sqrt(nu'_j / nu_i) sum_{m in A|r_i>}
                  B_m sigma*_m e^{+i k'.R*_m}

    Images whose representative is not in the destination basis are dropped
    (zero norm or out of sector), matching the reference's lookup-miss
    behavior.
    """
    import jax
    import jax.numpy as jnp

    space = compiled.space
    tset = src.tset
    groups = [_group_device(g) for g in compiled.groups]
    cos, sin = tset.phases(dst.momentum)
    cos_d, sin_d = jnp.asarray(cos), jnp.asarray(-np.asarray(sin))  # e^{+ik'R}
    Ftab = jnp.asarray(space.fermion_count_table)
    slot_iota = jnp.arange(space.n_slots)
    dst_index = dst.index
    dst_sqrt_nu = dst.sqrt_nu  # length n_dst + 1 (pad slot)

    if not compiled.diag_terms.q_zero():
        ev = compile_diagonal(compiled.diag_terms, space)
        diag_b = jax.jit(ev)(src.V_b.astype(jnp.int32))
    else:
        diag_b = None

    x_re, x_im = x
    if x_im is None:
        x_im = jnp.zeros_like(x_re)

    def block_contrib(carry, xs):
        y_re, y_im = carry
        if diag_b is None:
            labels, V, F, isn, mask, xbr, xbi = xs
            diag = None
        else:
            labels, V, F, diag, isn, mask, xbr, xbi = xs

        def scatter_images(y_re, y_im, amp_re, amp_im, sgn, tgt, wsrc_re, wsrc_im):
            """images tgt (B,T,K) with amplitude amp*sgn; source weight wsrc."""
            Vm = space.decode(tgt)
            Fm = Ftab[slot_iota[None, None, None, :], Vm.astype(jnp.int64)]
            tl, tsign = tset.transform_all(Vm, Fm)
            gstar = jnp.argmin(tl, axis=-1)
            rmin = jnp.min(tl, axis=-1)
            sig = jnp.take_along_axis(tsign, gstar[..., None], axis=-1)[..., 0]
            ph_re = cos_d[gstar]
            ph_im = sin_d[gstar]
            j = dst_index.lookup_t(dst_index.tables, rmin)
            valid = dst_index.labels[j] == rmin
            jc = jnp.where(valid, j, dst.n)
            w = sgn * sig * dst_sqrt_nu[jc] * jnp.where(valid, 1.0, 0.0)
            a_re = amp_re
            a_im = amp_im if amp_im is not None else None
            c_re = a_re * ph_re - (a_im * ph_im if a_im is not None else 0.0)
            c_im = a_re * ph_im + (a_im * ph_re if a_im is not None else 0.0)
            contrib_re = w * (c_re * wsrc_re - c_im * wsrc_im)
            contrib_im = w * (c_re * wsrc_im + c_im * wsrc_re)
            jflat = jnp.where(valid, j, dst.n).reshape(-1)
            y_re = y_re.at[jflat].add(contrib_re.reshape(-1))
            y_im = y_im.at[jflat].add(contrib_im.reshape(-1))
            return y_re, y_im

        wsrc_re = (xbr * isn * mask)
        wsrc_im = (xbi * isn * mask)
        if diag is not None:
            # diagonal terms: image = source state itself
            y_re, y_im = scatter_images(
                y_re, y_im, diag[:, None, None], None,
                jnp.ones_like(diag)[:, None, None], labels[:, None, None],
                wsrc_re[:, None, None], wsrc_im[:, None, None])
        for g in groups:
            sgn, amp_re, amp_im, tgt = _block_images(g, labels, V, F)
            y_re, y_im = scatter_images(
                y_re, y_im, amp_re, amp_im, sgn[..., None], tgt,
                wsrc_re[:, None, None], wsrc_im[:, None, None])
        return (y_re, y_im), None

    def run(x_re, x_im):
        xbr = src.pad_vec(x_re)
        xbi = src.pad_vec(x_im)
        # one extra slot absorbs invalid-image scatters
        y0 = (jnp.zeros(dst.n + 1), jnp.zeros(dst.n + 1))
        xs = [src.labels_b, src.V_b, src.F_b]
        if diag_b is not None:
            xs.append(diag_b)
        xs.extend([src.inv_sqrt_nu_b, src.mask_b, xbr, xbi])
        (y_re, y_im), _ = jax.lax.scan(block_contrib, y0, tuple(xs))
        return y_re[: dst.n], y_im[: dst.n]

    y_re, y_im = jax.jit(run)(x_re, x_im)
    return (y_re, y_im)


def index_labels_eq(itabs, index, j, tgt):
    """valid mask: does basis label at j equal tgt? (works for both modes)."""
    if index.mode == "direct":
        # direct tables may alias out-of-basis labels to position 0; check
        # via the stored sorted labels array on the index object
        import jax.numpy as jnp

        return index.labels[j] == tgt
    (labels,) = itabs
    return labels[j] == tgt
