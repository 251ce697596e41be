"""Variational ("vrnl") Trugman bases: translate-to-center canonical states.

Device-side re-design of the reference's variational-basis sector for
single-polaron-type excitations (reference: src/model.cc:489-616 build,
src/model.cc:838-924 matrix, src/model.cc:1915-2143 measurements;
src/basis.cc:661-704 translate2center_OBC; src/basis.cc:2842-2946 basis
growth). States are canonicalized by rigidly translating the occupied
("non-vacuum") sites so their mean coordinate sits at the lattice center;
the recorded displacement carries the momentum phase e^{2*pi*i k.disp}.

Device design: instead of walking byte-packed states one at a time, a whole
batch of labels is canonicalized at once — occupancy and centers are two
small matmuls, the per-state displacement selects a column of the
precomputed translation stride table, and fermionic signs come from the same
quadratic-form machinery as :class:`~quantum_basis_tpu.basis.translation.
TranslationSet`. The Hamiltonian matrix is built as a static COO skeleton
(rows, cols, amplitude, displacement) in ONE batched pass; re-phasing it for
a new momentum is then O(nnz) elementwise work with no basis re-walk — the
reference rebuilds the whole matrix per momentum (src/model.cc:2195-2225).

Momentum convention: ``momentum`` is the *fractional* wave vector per
lattice unit cell; every phase in this module is exp(+2*pi*i momentum.disp).
(The reference mixes 2*pi-ful and 2*pi-less phases between
generate_Ham_sparse_vrnl and measure_vrnl_static_trans_invariant — its own
comments mark the code "to be updated"; we pin the 2*pi-ful convention
everywhere.)
"""

from __future__ import annotations

import itertools

import numpy as np

from quantum_basis_tpu.ops.compile import CompiledOperator, compile_diagonal
from quantum_basis_tpu.ops.apply import _block_images, _group_device

_QN_TOL = 1e-5  # quantum-number tolerance (reference: src/model.cc:520)


class CenterTranslator:
    """Batched translate-to-center canonicalization for one (space, lattice).

    Mirrors ``mbasis_elem::translate2center_OBC`` + ``center_pos``
    (reference: src/basis.cc:565-588, 661-704): the canonical form of a
    state translates the mean fractional coordinate of its non-vacuum sites
    onto the lattice center, ``disp = floor(center0 - center1 + 1e-12)``.
    All-vacuum / uniform states are their own canonical form (disp = 0).
    """

    def __init__(self, space, lattice):
        import jax.numpy as jnp

        self.space = space
        self.lattice = lattice
        L = np.asarray(lattice.L, dtype=np.int64)
        self.dim = int(lattice.dim)

        # displacement classes over ALL dimensions (vrnl states are centered;
        # boundary conditions are enforced by construction, not by folding)
        combos = list(itertools.product(*[range(int(l)) for l in L]))
        self.G = len(combos)
        self.disp_classes = np.asarray(combos, dtype=np.int64)   # (G, dim)
        # strides for disp -> class index (last dim fastest, like itertools)
        gstr = np.ones(self.dim, dtype=np.int64)
        for d in range(self.dim - 2, -1, -1):
            gstr[d] = gstr[d + 1] * int(L[d + 1])
        self._gstr = gstr
        self._L = L

        S = space.n_slots
        SP = np.zeros((S, self.G), dtype=np.int64)
        Qs = []
        self.fermionic = space.fermionic
        for g, disp in enumerate(combos):
            plan = lattice.translation_plan(list(disp))
            sp, Q = space.permutation_arrays(plan)
            SP[:, g] = sp
            Qs.append(Q)
        self.SP = jnp.asarray(SP.astype(np.float64))  # f64: exact < 2^53;
        # not every XLA backend implements an s64 dot_general
        self.Q = (jnp.asarray(np.stack(Qs).astype(np.float32))
                  if self.fermionic else None)

        # per-site fractional positions (coor + pos_sub) and lattice center
        n_sites = lattice.n_sites
        pos = np.zeros((n_sites, self.dim), dtype=np.float64)
        for site in range(n_sites):
            coor, sub = lattice.site2coor(site)
            pos[site] = np.asarray(coor, dtype=np.float64) + lattice.pos_sub[sub]
        self.center0 = pos.mean(axis=0)                           # (dim,)
        self.site_pos = jnp.asarray(pos)
        # slot -> site aggregation matrix (S, n_sites)
        agg = np.zeros((S, n_sites), dtype=np.float64)
        for s in range(S):
            agg[s, int(space.slot_site[s])] = 1.0
        self._agg = jnp.asarray(agg)

    # ------------------------------------------------------------- traceable

    def canonicalize_vf(self, labels, V, F):
        """Traceable canonicalization of decoded states.

        labels (N,) int64, V (N, S) int, F (N, S) int ->
        (canon labels (N,) int64, disp (N, dim) int64, sign (N,) f64).
        """
        import jax.numpy as jnp

        occ_slot = (V != 0).astype(jnp.float64)                    # (N, S)
        occ_site = jnp.dot(occ_slot, self._agg) > 0.5              # (N, sites)
        occ_site = occ_site.astype(jnp.float64)
        npos = jnp.sum(occ_site, axis=-1)                          # (N,)
        safe = jnp.maximum(npos, 1.0)
        center1 = jnp.dot(occ_site, self.site_pos) / safe[:, None]  # (N, dim)
        disp = jnp.floor(self.center0[None, :] - center1 + 1e-12).astype(jnp.int64)
        disp = jnp.where(npos[:, None] > 0.5, disp, 0)
        gmod = jnp.mod(disp, jnp.asarray(self._L))
        g = jnp.sum(gmod * jnp.asarray(self._gstr), axis=-1)       # (N,)

        # all-class translations, then select column g per state
        lab_all = jnp.round(
            jnp.dot(V.astype(jnp.float64), self.SP)).astype(jnp.int64)
        lab_c = jnp.take_along_axis(lab_all, g[:, None], axis=-1)[:, 0]
        if self.fermionic:
            Ff = F.astype(jnp.float32)
            par = jnp.einsum("ns,gst,nt->ng", Ff, self.Q, Ff)      # (N, G)
            par_g = jnp.take_along_axis(par, g[:, None], axis=-1)[:, 0]
            sign = 1.0 - 2.0 * jnp.mod(par_g, 2.0).astype(jnp.float64)
        else:
            sign = jnp.ones(lab_c.shape, dtype=jnp.float64)
        return lab_c, disp, sign

    def _decode(self, lab):
        import jax.numpy as jnp

        V = self.space.decode(lab)
        F = jnp.asarray(self.space.fermion_count_table)[
            jnp.arange(self.space.n_slots)[None, :], V.astype(jnp.int64)
        ]
        return V, F

    def canonicalize(self, labels, chunk: int = 1 << 16):
        """Host wrapper: labels (N,) -> (canon (N,), disp (N, dim), sign (N,))."""
        import jax
        import jax.numpy as jnp

        labels = np.asarray(labels, dtype=np.int64)
        n = labels.size

        @jax.jit
        def run(lab):
            V, F = self._decode(lab)
            return self.canonicalize_vf(lab, V, F)

        canon = np.empty(n, dtype=np.int64)
        disp = np.empty((n, self.dim), dtype=np.int64)
        sign = np.empty(n, dtype=np.float64)
        for start in range(0, n, chunk):
            lab = jnp.asarray(labels[start : start + chunk])
            c, d, s = run(lab)
            canon[start : start + lab.size] = np.asarray(c)
            disp[start : start + lab.size] = np.asarray(d)
            sign[start : start + lab.size] = np.asarray(s)
        return canon, disp, sign

    def omega_g(self, label: int) -> int:
        """Orbit-size factor omega_g = G / |{translations fixing the state}|
        (reference: src/model.cc:581-598)."""
        import jax.numpy as jnp

        lab = jnp.asarray(np.asarray([label], dtype=np.int64))
        V, _ = self._decode(lab)
        lab_all = np.asarray(jnp.round(
            jnp.dot(V.astype(jnp.float64), self.SP)).astype(jnp.int64))[0]
        cnt_repeat = int(np.sum(lab_all == int(label)))
        assert cnt_repeat > 0 and self.G % cnt_repeat == 0
        return self.G // cnt_repeat


class VrnlSector:
    """Per-sector vrnl state (the reference's per-sector arrays
    basis_vrnl/dim_vrnl/momenta_vrnl/gs_* members, src/qbasis.h:1285-1300)."""

    def __init__(self):
        self.labels: np.ndarray | None = None
        self.dim = 0
        self.momentum: np.ndarray | None = None   # fractional k
        self.gs_label: int | None = None
        self.gs_momentum: np.ndarray | None = None
        self.gs_omega = 1                          # omega_g(GS)
        self.gs_norm = 0.0                         # gs_norm_vrnl[sec]
        self.gs_E0: float | None = None            # gs_E0_vrnl
        self.vmat = None                           # VrnlMatrix skeleton
        self.matvec = None                         # MatvecVrnl at momentum
        self.evals: list = []
        self.evecs: list = []


# ---------------------------------------------------------------------------
# Basis growth (gen_mbasis_by_mopr + rm_mbasis_dulp_trans, batched)
# ---------------------------------------------------------------------------


def _conserve_ok(space, evals, vals, labels):
    """Filter labels by conserved diagonal quantum numbers (host)."""
    if not evals:
        return labels
    V = space.decode(labels)  # numpy
    ok = np.ones(labels.shape, dtype=bool)
    for ev, v in zip(evals, vals):
        ok &= np.abs(np.asarray(ev(V)) - v) < _QN_TOL
    return labels[ok]


def grow_basis_vrnl(generator: CompiledOperator, ct: CenterTranslator,
                    seed_labels, depth: int,
                    conserve_lst=None, val_lst=None) -> np.ndarray:
    """Grow the variational basis: seeds, then ``depth`` rounds of applying
    the generator operator, canonicalizing, and deduplicating.

    The whole round is batched: one device pass computes every image of every
    current state (fixed (N, T, K) tables), one pass canonicalizes them
    (reference: gen_mbasis_by_mopr src/basis.cc:2842-2908 +
    rm_mbasis_dulp_trans src/basis.cc:2910-2946, per-state with OpenMP
    splices). Returns sorted canonical labels.
    """
    import jax
    import jax.numpy as jnp

    space = ct.space
    evals = [compile_diagonal(m, space) for m in (conserve_lst or [])]
    vals = [float(v) for v in (val_lst or [])]

    seeds = np.asarray(sorted(set(int(x) for x in np.asarray(seed_labels))),
                       dtype=np.int64)
    seeds = _conserve_ok(space, evals, vals, seeds)
    canon, _, _ = ct.canonicalize(seeds)
    basis = np.unique(canon)

    groups = [_group_device(g) for g in generator.groups]

    @jax.jit
    def images(lab):
        V, F = ct._decode(lab)
        outs = []
        for g in groups:
            _, amp_re, amp_im, tgt = _block_images(g, lab, V, F)
            mag = jnp.abs(amp_re) + (jnp.abs(amp_im) if amp_im is not None else 0.0)
            outs.append((tgt.reshape(lab.shape[0], -1),
                         mag.reshape(lab.shape[0], -1)))
        tgts = jnp.concatenate([t for t, _ in outs], axis=-1)
        mags = jnp.concatenate([m for _, m in outs], axis=-1)
        return tgts, mags

    for _ in range(int(depth)):
        if basis.size == 0:
            break
        lab = jnp.asarray(basis)
        tgts, mags = images(lab)
        cand = np.unique(np.asarray(tgts)[np.asarray(mags) > 1e-14])
        cand = _conserve_ok(space, evals, vals, cand.astype(np.int64))
        if cand.size == 0:
            continue
        canon, _, _ = ct.canonicalize(cand)
        basis = np.union1d(basis, np.unique(canon))
    return np.sort(basis)


# ---------------------------------------------------------------------------
# Matrix skeleton + momentum re-phasing
# ---------------------------------------------------------------------------


class VrnlMatrix:
    """H over a vrnl basis as a momentum-independent COO skeleton.

    Entry list (i, j, amp, disp): <j|H|i> contributions before phases — the
    matrix at momentum k is ``M[i, j] = sum conj(amp * e^{2 pi i k.disp})``
    (reference: src/model.cc:890-918). ``at_momentum`` re-phases in O(nnz).
    """

    def __init__(self, compiled: CompiledOperator, ct: CenterTranslator,
                 labels: np.ndarray, chunk: int = 1 << 14):
        import jax
        import jax.numpy as jnp

        space = ct.space
        self.space = space
        self.ct = ct
        self.labels = np.asarray(labels, dtype=np.int64)
        n = self.labels.size
        self.n = n

        # diagonal (real fast path)
        if compiled.diag_terms.q_zero():
            self.diag = np.zeros(n, dtype=np.float64)
        else:
            ev = compile_diagonal(compiled.diag_terms, space)
            self.diag = np.asarray(ev(space.decode(self.labels)))

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
                    jnp.arange(space.n_slots)[None, :], Vt.astype(jnp.int64)
                ]
                canon, disp, csign = ct.canonicalize_vf(
                    tgt_f.reshape(-1), Vt, Ft)
                outs.append((tgt_f, ar, ai,
                             canon.reshape(B, M),
                             disp.reshape(B, M, -1),
                             csign.reshape(B, M)))
            return outs

        rows, cols_lab, amp_re, amp_im, disps = [], [], [], [], []
        sorter = np.argsort(self.labels)
        assert np.all(np.diff(self.labels[sorter]) > 0)
        lab_sorted = self.labels[sorter]
        for start in range(0, n, chunk):
            lab = jnp.asarray(self.labels[start : start + chunk])
            for tgt_f, ar, ai, canon, disp, csign in run(lab):
                tgt_f = np.asarray(tgt_f)
                ar = np.asarray(ar) * np.asarray(csign)
                ai = np.asarray(ai) * np.asarray(csign)
                canon = np.asarray(canon)
                disp = np.asarray(disp)
                mag = np.abs(ar) + np.abs(ai)
                ii, kk = np.nonzero(mag > 1e-14)
                if ii.size == 0:
                    continue
                c = canon[ii, kk]
                pos = np.searchsorted(lab_sorted, c)
                pos = np.clip(pos, 0, max(n - 1, 0))
                ok = lab_sorted[pos] == c
                rows.append(start + ii[ok])
                cols_lab.append(sorter[pos[ok]])
                amp_re.append(ar[ii, kk][ok])
                amp_im.append(ai[ii, kk][ok])
                disps.append(disp[ii, kk][ok])

        if rows:
            self.rows = np.concatenate(rows).astype(np.int64)
            self.cols = np.concatenate(cols_lab).astype(np.int64)
            self.amp_re = np.concatenate(amp_re)
            self.amp_im = np.concatenate(amp_im)
            self.disp = np.concatenate(disps)
        else:
            self.rows = np.empty(0, dtype=np.int64)
            self.cols = np.empty(0, dtype=np.int64)
            self.amp_re = np.empty(0)
            self.amp_im = np.empty(0)
            self.disp = np.empty((0, ct.dim), dtype=np.int64)

    def at_momentum(self, momentum, upper_triangle: bool = True):
        """Dense H(k): M[i, j] = diag + sum conj(amp * e^{2 pi i k.disp}).

        With ``upper_triangle`` (the reference default, qbasis.h:1412-1414)
        only i <= j entries are kept and the strict lower triangle is the
        conjugate transpose — exactly the effective matrix of the reference's
        upper-triangle LIL build + Hermitian CSR descriptor
        (src/model.cc:910-918, src/sparse.cc:276-301). This matters on PBC
        clusters: translate-to-center is not translation-consistent across
        the wrap, so boundary-crossing entries make the raw matrix slightly
        non-Hermitian; the method Hermitizes by construction.
        """
        momentum = np.asarray(momentum, dtype=np.float64)
        ang = 2.0 * np.pi * (self.disp @ momentum)
        amp = self.amp_re + 1j * self.amp_im
        val = np.conj(amp * np.exp(1j * ang))
        H = np.zeros((self.n, self.n), dtype=np.complex128)
        if upper_triangle:
            keep = self.rows <= self.cols
            np.add.at(H, (self.rows[keep], self.cols[keep]), val[keep])
            H = np.triu(H) + np.triu(H, 1).conj().T
        else:
            np.add.at(H, (self.rows, self.cols), val)
            err = np.max(np.abs(H - H.conj().T)) if self.n else 0.0
            if err > 1e-9:
                raise AssertionError(
                    f"H_vrnl(k={momentum}) not Hermitian: err={err:.3e} "
                    "(cf. csr_mat Hermiticity check, src/sparse.cc:235-256)")
        H[np.arange(self.n), np.arange(self.n)] += self.diag
        return H
