"""Full-label-space apply as dense window contractions (matmuls).

The second-generation full-space engine (successor of the masked-roll engine
in :mod:`quantum_basis_tpu.ops.apply_fullspace`). The state vector over the
full mixed-radix label space IS the state tensor ``(d_{S-1}, ..., d_1, d_0)``;
every off-diagonal Hamiltonian term is a small dense matrix acting on a few
tensor axes. Instead of one HBM roll pass per image class (the roll engine's
cost model: ~2 passes per bond), terms are grouped into contiguous slot
WINDOWS of joint dimension <= ``max_window``; each window's terms sum into
one dense G (Dw x Dw) matrix and the whole group applies as ONE batched
matmul:

    y += einsum('amb,nm->anb', x.reshape(hi, Dw, lo), G)

Terms whose slot span exceeds a window (lattice wrap/PBC bonds) are caught by
a second FRAME: the same vector with its slot order rotated by S/2 (one
(hi, lo) transpose), where wrap terms become mid-range and window-assignable.
Anything still left (rare) falls back to the roll engine's masked-roll pass.
The diagonal stays one elementwise pass computed from a label iota.

Why: the roll engine is bandwidth-bound at ~2 passes per bond (L=24
chain: 49 passes per apply); the window engine reads x O(#windows +
#frames) times and turns the per-bond work into matmul flops. Supports any
mixed-radix site dimension (the joint
matrices are exact — no popcount constraint for window terms, unlike the
roll engine) and any dtype (f32 for the mixed-precision Krylov path, f64
for the exact stage).

Reference parity: replaces model::MultMv2 (src/model.cc:941-1121) for full
sectors. No analog exists in the reference — this is the quantum-circuit-
simulator formulation of SpMV.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu.ops.apply_fullspace import (_bit_shift_of_stride,
                                                   _diag_elementwise)
from quantum_basis_tpu.ops.compile import CompiledOperator

_AMP_TOL = 1e-14


# --------------------------------------------------------------------------
# Planning: assign terms to (frame, window) or roll fallback
# --------------------------------------------------------------------------


class _Window:
    """Contiguous slot-position range [a, b) in one frame."""

    def __init__(self, frame: int, a: int, b: int, dims_f):
        self.frame = frame
        self.a = a
        self.b = b
        self.wdims = [int(dims_f[p]) for p in range(a, b)]
        self.D = int(np.prod(self.wdims, dtype=np.int64))
        self.terms = []  # indices into compiled.term_matrices

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Window(f{self.frame}, [{self.a},{self.b}), D={self.D})"


class ContractPlan:
    """Host-side plan: windows per frame + leftover roll terms."""

    def __init__(self, compiled: CompiledOperator, max_window: int = 1024,
                 min_lo: int = 128, max_frames: int = 4):
        space = compiled.space
        S = space.n_slots
        self.space = space
        self.compiled = compiled
        self.windows: list[_Window] = []
        self.roll_terms: list[int] = []
        self.rotations: list[int] = []

        terms = compiled.term_matrices
        # window assignment uses the SUPPORT span only: a Jordan-Wigner
        # string outside the window factorizes into an elementwise sign on
        # the source label (constant along the window axis), applied as
        # y += G (sign * x) — so even an all-slot JW string (t-J wrap hop)
        # does not force a giant window
        involved_sets = [sorted(set(slots))
                         for (slots, dims, jstr, M, w) in terms]

        def span(i, r):
            pos = sorted(((s - r) % S) for s in involved_sets[i])
            return pos[0], pos[-1]

        assigned = [False] * len(terms)

        def run_frame(f, r):
            dims_f = [int(space.dims[(p + r) % S]) for p in range(S)]

            def fits(a, b):
                return int(np.prod(dims_f[a:b], dtype=np.int64)) <= max_window

            made = False
            while True:
                todo = [i for i in range(len(terms)) if not assigned[i]
                        and fits(span(i, r)[0], span(i, r)[1] + 1)]
                if not todo:
                    break
                anchor = min(todo, key=lambda i: span(i, r)[0])
                a = span(anchor, r)[0]
                a_end = span(anchor, r)[1] + 1
                # pull the start down so the batch 'lo' axis is either 1 or
                # wide enough to make a clean lane dimension — but never so
                # far that the anchor term no longer fits
                while a > 0:
                    lo = int(np.prod(dims_f[:a], dtype=np.int64))
                    if lo >= min_lo or not fits(a - 1, a_end):
                        break
                    a -= 1
                b = a + 1
                while b < S and fits(a, b + 1):
                    b += 1
                win = _Window(f, a, b, dims_f)
                for i in todo:
                    pmin, pmax = span(i, r)
                    if a <= pmin and pmax < b:
                        win.terms.append(i)
                        assigned[i] = True
                if not win.terms:
                    # the first todo term cannot fit a window from `a`
                    # (capacity eaten by the lo pull-down); give up on it
                    i0 = min(todo, key=lambda i: span(i, r)[0])
                    assigned[i0] = True
                    self.roll_terms.append(i0)
                    continue
                self.windows.append(win)
                made = True
            return made

        # frame 0 = identity, then adaptive rotations chosen so leftover
        # terms (lattice wrap bonds) become window-assignable. Candidate
        # rotations are scored by how many leftovers they absorb, with a
        # BALANCE tiebreak: the frame transpose is x.reshape(Q, P).T and
        # degenerate shapes like (2, N/2) can run an order of magnitude
        # slower than square-ish ones.
        self.rotations.append(0)
        run_frame(0, 0)
        while (len(self.rotations) < max_frames
               and not all(assigned)):
            leftover = [i for i in range(len(terms)) if not assigned[i]]
            best = None  # (coverage, -imbalance, r)
            for r in range(1, S):
                if r in self.rotations:
                    continue
                dims_f = [int(space.dims[(p + r) % S]) for p in range(S)]

                def rfits(a, b):
                    return int(np.prod(dims_f[a:b],
                                       dtype=np.int64)) <= max_window

                cov = sum(1 for i in leftover
                          if rfits(span(i, r)[0], span(i, r)[1] + 1))
                if cov == 0:
                    continue
                P = float(np.prod([float(space.dims[s]) for s in range(r)]))
                Q = float(int(space.label_space) / P)
                imbalance = abs(np.log2(max(P, 1.0)) - np.log2(max(Q, 1.0)))
                cand = (cov, -imbalance, r)
                if best is None or cand > best:
                    best = cand
            if best is None:
                break
            r = best[2]
            f = len(self.rotations)
            self.rotations.append(r)
            if not run_frame(f, r):
                self.rotations.pop()
                break
        self.roll_terms.extend(i for i in range(len(terms)) if not assigned[i])
        # frames that ended up with windows (frame transposes are paid
        # only for these)
        used = sorted({w.frame for w in self.windows})
        self.frames = [(f, self.rotations[f]) for f in used]

    # ---------------------------------------------------------------- G build

    def w_out(self, win: _Window, ti: int) -> np.ndarray:
        """The term's JW weights restricted to slots OUTSIDE the window —
        the elementwise sign prefactor's support."""
        space = self.space
        S = space.n_slots
        r = self.rotations[win.frame]
        _, _, _, _, w = self.compiled.term_matrices[ti]
        out = w.copy()
        for s in np.nonzero(w)[0]:
            p = (int(s) - r) % S
            if win.a <= p < win.b:
                out[s] = 0
        return out

    def window_G(self, win: _Window, term_indices) -> np.ndarray:
        """Dense window matrix G[w', w] summing the given terms, with
        intra-window Jordan-Wigner signs applied exactly from the fermion
        count tables (cf. the reference's per-state fermion scan,
        src/basis.cc:2650-2664 — here evaluated once at plan time).
        Out-of-window JW weights are NOT included — the engine multiplies
        the source vector by their elementwise sign instead."""
        space = self.space
        S = space.n_slots
        r = self.rotations[win.frame]
        Dw = win.D
        nw = win.b - win.a
        wdims = np.asarray(win.wdims, dtype=np.int64)
        wstr = np.ones(nw, dtype=np.int64)
        for i in range(1, nw):
            wstr[i] = wstr[i - 1] * wdims[i - 1]
        wcols = np.arange(Dw, dtype=np.int64)
        wdigits = (wcols[:, None] // wstr[None, :]) % wdims[None, :]
        F = space.fermion_count_table

        G = np.zeros((Dw, Dw), dtype=np.complex128)
        for ti in term_indices:
            slots, dims, jstr, M, w = self.compiled.term_matrices[ti]
            pos = [((s - r) % S) - win.a for s in slots]
            # JW sign from weight-slots inside the window
            jw_exp = np.zeros(Dw, dtype=np.int64)
            for s in np.nonzero(w)[0]:
                p = ((int(s) - r) % S) - win.a
                if not (0 <= p < nw):
                    continue  # outside: handled by the elementwise prefactor
                jw_exp += F[int(s)][wdigits[:, p]]
            sgn = np.where(jw_exp % 2 == 0, 1.0, -1.0)
            # joint column index of each window column for this term
            c_of_w = np.zeros(Dw, dtype=np.int64)
            for i, p in enumerate(pos):
                c_of_w += wdigits[:, p] * int(jstr[i])
            rr, cc = np.nonzero(np.abs(M) > _AMP_TOL)
            dims_a = np.asarray(dims, dtype=np.int64)
            for rj, cj in zip(rr, cc):
                rdig = (int(rj) // jstr) % dims_a
                cdig = (int(cj) // jstr) % dims_a
                off = int(np.sum((rdig - cdig) * wstr[pos]))
                sel = c_of_w == int(cj)
                src = wcols[sel]
                G[src + off, src] += M[rj, cj] * sgn[sel]
        return G

    def describe(self) -> str:
        lines = [f"frames: {[r for _, r in self.frames]}"]
        for w in self.windows:
            lines.append(f"  f{w.frame} slots[{w.a}:{w.b}) D={w.D} "
                         f"terms={len(w.terms)}")
        lines.append(f"  roll fallback terms: {len(self.roll_terms)}")
        return "\n".join(lines)


def supports_contract(compiled: CompiledOperator,
                      max_label_space: int = 1 << 27,
                      max_window: int = 1024) -> bool:
    """True when the window engine fully covers this operator: label space
    small enough and every leftover (roll-fallback) term popcount-safe."""
    from quantum_basis_tpu.ops.apply_fullspace import _popcount_ok

    space = compiled.space
    if int(space.label_space) > max_label_space:
        return False
    if not compiled.term_matrices and compiled.groups:
        return False  # compiled before term_matrices existed
    plan = ContractPlan(compiled, max_window=max_window)
    for ti in plan.roll_terms:
        slots, _, _, _, w = compiled.term_matrices[ti]
        if len(set(int(s) for s in slots)) == 2:
            continue  # pair-window path: no popcount constraint
        if np.any(w) and not _popcount_ok(space, w):
            return False
    return True


# --------------------------------------------------------------------------
# Device engine
# --------------------------------------------------------------------------


class ContractOp:
    """y = H x over the full label space via window contractions.

    Protocol-compatible with :class:`FullSpaceOp` (params/apply/mask/
    to_full/to_sector/nnz_estimate); adds ``dtype`` (float32 default — the
    mixed-precision Krylov path; float64 for exact CPU verification).
    """

    def __init__(self, compiled: CompiledOperator, sector_labels=None,
                 dtype=None, max_window: int = 1024):
        import jax
        import jax.numpy as jnp

        space = compiled.space
        self.space = space
        self.compiled = compiled
        self.dtype = jnp.dtype(dtype or jnp.float32)
        # f32 dots run at HIGHEST: a reduced-precision default (TF32 on the
        # GPU, 10-bit mantissa) is far below the f32 stage's 1e-5 target
        self._precision = (jax.lax.Precision.HIGHEST
                           if self.dtype == jnp.dtype(jnp.float32) else None)
        N = int(space.label_space)
        if N > (1 << 31) - 1:
            raise ValueError("label space exceeds int32 range")
        self.N = N
        self.n = N

        plan = ContractPlan(compiled, max_window=max_window)
        self.plan = plan

        # ---- window tensors: (frame, hi, D, lo, G_re, G_im or None, sidx)
        # terms sharing a window but differing in their OUT-of-window JW
        # weights get separate G's; sidx points at the elementwise sign
        # prefactor array for y += G (sign * x) (None = no prefactor)
        S = space.n_slots
        self._wins = []
        self._signs = []
        sign_idx = {}
        any_im = False
        for win in plan.windows:
            r = plan.rotations[win.frame]
            dims_f = [int(space.dims[(p + r) % S]) for p in range(S)]
            lo = int(np.prod(dims_f[:win.a], dtype=np.int64))
            hi = int(np.prod(dims_f[win.b:], dtype=np.int64))
            by_wout = {}
            for ti in win.terms:
                by_wout.setdefault(plan.w_out(win, ti).tobytes(), []).append(ti)
            for wkey, tis in by_wout.items():
                G = plan.window_G(win, tis)
                g_re = jnp.asarray(G.real, self.dtype)
                g_im = (jnp.asarray(G.imag, self.dtype)
                        if np.max(np.abs(G.imag)) > _AMP_TOL else None)
                any_im = any_im or g_im is not None
                w_arr = np.frombuffer(wkey, dtype=np.int8)
                if not w_arr.any():
                    sidx = None
                else:
                    skey = (win.frame, wkey)
                    if skey not in sign_idx:
                        sign_idx[skey] = len(self._signs)
                        self._signs.append(
                            self._build_sign(win.frame, w_arr))
                    sidx = sign_idx[skey]
                self._wins.append((win.frame, hi, win.D, lo, g_re, g_im,
                                   sidx))

        # ---- frame transpose shapes: rotated label = m*Q + q
        self._frame_shape = {}
        for f, r in plan.frames:
            if r == 0:
                continue
            P = int(np.prod([int(space.dims[s]) for s in range(r)],
                            dtype=np.int64))
            self._frame_shape[f] = (N // P, P)  # (Q, P)

        # ---- pair windows: 2-slot terms too far apart for any contiguous
        # window in any frame (e.g. the x-wrap bonds of a 2xL lattice, whose
        # two slots sit >window apart around the label circle in every
        # rotation). Applied as ONE 5-axis einsum over
        # x.reshape(A, d_hi, M, d_lo, L) — no label-derived index arrays, so
        # nothing for XLA to hoist out of solver loops (hoisted per-pass
        # iota math at N = 2^24 f64 was measured to OOM a 16G chip).
        self._pairs = []
        leftover = []
        for ti in plan.roll_terms:
            slots, dims, jstr, M, w = compiled.term_matrices[ti]
            sup = sorted(set(int(s) for s in slots))
            if len(sup) != 2:
                leftover.append(ti)
                continue
            s_lo, s_hi = sup
            d_lo, d_hi = int(space.dims[s_lo]), int(space.dims[s_hi])
            L = int(space.strides[s_lo])
            Mmid = int(space.strides[s_hi]) // (L * d_lo)
            A = N // (int(space.strides[s_hi]) * d_hi)
            # joint G over (hi, lo) with intra-support JW; out-of-support
            # JW becomes an elementwise sign prefactor exactly as windows do
            w_in = w.copy()
            w_out = w.copy()
            for s in np.nonzero(w)[0]:
                (w_out if int(s) in sup else w_in)[s] = 0
            G = _pair_G(space, slots, dims, jstr, M, w_in, s_lo, s_hi)
            g_re = jnp.asarray(G.real, self.dtype)
            g_im = (jnp.asarray(G.imag, self.dtype)
                    if np.max(np.abs(G.imag)) > _AMP_TOL else None)
            any_im = any_im or g_im is not None
            if not w_out.any():
                sidx = None
            else:
                skey = (0, w_out.astype(np.int8).tobytes())
                if skey not in sign_idx:
                    sign_idx[skey] = len(self._signs)
                    self._signs.append(self._build_sign(0, w_out))
                sidx = sign_idx[skey]
            self._pairs.append((A, d_hi, Mmid, d_lo, L, g_re, g_im, sidx))

        # ---- roll-fallback passes (same math as the roll engine)
        self._passes = []
        for ti in leftover:
            slots, dims, jstr, M, w = compiled.term_matrices[ti]
            self._passes.extend(
                _term_roll_passes(space, slots, dims, jstr, M, w))
        for p in self._passes:
            any_im = any_im or np.max(np.abs(p[3].imag)) > _AMP_TOL
        self.is_complex = any_im

        # ---- diagonal (elementwise from label iota)
        if compiled.diag_terms.q_zero():
            diag_fn = None
        else:
            diag_fn = _diag_elementwise(compiled.diag_terms, space)

        dt = self.dtype

        def build_diag():
            lab = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1)
            d = diag_fn(lab) if diag_fn is not None else jnp.zeros(N)
            return d.astype(dt)

        self.diag_full = jax.jit(build_diag)()

        # ---- sector mask + coordinates
        self.sector_labels = (np.asarray(sector_labels, dtype=np.int64)
                              if sector_labels is not None else None)
        if self.sector_labels is not None:
            m = np.zeros(N, dtype=np.float64)
            m[self.sector_labels] = 1.0
            self.mask = jnp.asarray(m, self.dtype)
        else:
            self.mask = None

        self._jit_apply = jax.jit(self.apply)

    # ------------------------------------------------------------- protocol

    def _build_sign(self, frame, w_arr):
        """Elementwise JW prefactor over FRAME-ordered labels: the product
        of (-1)^{F_s(digit_s)} over the weight slots, built once on device.
        Works for any local dimension (no popcount constraint — this is how
        t-J/Kondo wrap hops become window terms)."""
        import jax
        import jax.numpy as jnp

        space = self.space
        S = space.n_slots
        r = self.plan.rotations[frame]
        dims_f = [int(space.dims[(p + r) % S]) for p in range(S)]
        fstr = np.ones(S, dtype=np.int64)
        for p in range(1, S):
            fstr[p] = fstr[p - 1] * dims_f[p - 1]
        F = space.fermion_count_table
        slots = np.nonzero(w_arr)[0]
        dt = self.dtype
        N = self.N

        def build():
            lab = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1)
            expo = jnp.zeros(N, jnp.int32)
            for s in slots:
                p = (int(s) - r) % S
                d = int(space.dims[s])
                dig = (lab // np.int32(int(fstr[p]))) % np.int32(d)
                odd = jnp.zeros(N, jnp.int32)
                for v in range(d):
                    if int(F[s][v]) % 2:
                        odd = jnp.where(dig == v, 1, odd)
                expo = expo ^ odd
            return (1 - 2 * expo).astype(dt)

        return jax.jit(build)()

    @property
    def params(self):
        """Device arrays passed as jit ARGUMENTS (capturing them as
        constants would trigger XLA constant folding; cf. the same note in
        solvers/restarted.py)."""
        return (self.diag_full,
                tuple((g_re, g_im)
                      for (_, _, _, _, g_re, g_im, _) in self._wins),
                tuple(self._signs),
                tuple((g_re, g_im)
                      for (_, _, _, _, _, g_re, g_im, _) in self._pairs))

    def _contract_frame(self, frame, xr, xi, win_params, signs):
        """Sum of this frame's window contractions of (xr, xi).

        Each window's contribution passes through an optimization_barrier
        before accumulating: without it XLA horizontally batches the
        same-shape window einsums inside solver loops into one
        (hi, n_windows, N) intermediate — measured 14.5 GiB of HLO temps at
        N = 2^24 f32 with ncv=12 live Krylov rows (OOM on a 16 GiB chip).
        The barrier pins the peak at one extra (N,) accumulator per window
        with no measured throughput cost (the windows are issued back to
        back either way).
        """
        import jax
        import jax.numpy as jnp

        yr = None
        yi = None
        for (f, hi, D, lo, _, _, sidx), (g_re, g_im) in zip(self._wins,
                                                            win_params):
            if f != frame:
                continue
            sxr, sxi = xr, xi
            if sidx is not None:
                s = signs[sidx]
                sxr = s * xr
                sxi = s * xi if xi is not None else None
            prec = self._precision

            def one(gmat, x):
                if gmat is None or x is None:
                    return None
                if lo == 1:
                    Y = jnp.matmul(x.reshape(hi, D), gmat.T, precision=prec)
                elif hi == 1:
                    Y = jnp.einsum("mb,nm->nb", x.reshape(D, lo), gmat,
                                   precision=prec)
                else:
                    Y = jnp.einsum("amb,nm->anb", x.reshape(hi, D, lo), gmat,
                                   precision=prec)
                return Y.reshape(-1)

            rr = one(g_re, sxr)
            ri = one(g_re, sxi)
            ir = one(g_im, sxr)
            ii = one(g_im, sxi)
            # (g_re + i g_im)(xr + i xi)
            t_re = rr if ii is None else rr - ii
            t_im = None
            if ri is not None or ir is not None:
                t_im = (ri if ri is not None else 0.0) \
                    + (ir if ir is not None else 0.0)
            yr = t_re if yr is None else yr + t_re
            if t_im is not None:
                yi = t_im if yi is None else yi + t_im
            if yi is None:
                yr = jax.lax.optimization_barrier(yr)
            else:
                yr, yi = jax.lax.optimization_barrier((yr, yi))
        return yr, yi

    def apply(self, params, x):
        import jax
        import jax.numpy as jnp

        diag, win_params, signs, pair_params = params
        xr, xi = x
        N = self.N
        dt = self.dtype

        yr = diag * xr
        yi = None if (xi is None and not self.is_complex) else \
            diag * (xi if xi is not None else jnp.zeros_like(xr))

        frames_used = sorted({w[0] for w in self._wins})
        for f in frames_used:
            if f == 0:
                fr_xr, fr_xi = xr, xi
            else:
                Q, P = self._frame_shape[f]
                fr_xr = xr.reshape(Q, P).T.reshape(-1)
                fr_xi = xi.reshape(Q, P).T.reshape(-1) if xi is not None else None
            tr, ti = self._contract_frame(f, fr_xr, fr_xi, win_params, signs)
            if f != 0:
                Q, P = self._frame_shape[f]
                if tr is not None:
                    tr = tr.reshape(P, Q).T.reshape(-1)
                if ti is not None:
                    ti = ti.reshape(P, Q).T.reshape(-1)
            if tr is not None:
                yr = yr + tr
            if ti is not None:
                yi = (yi if yi is not None else 0.0) + ti

        prec = self._precision
        for (A, d_hi, Mmid, d_lo, L, _, _, sidx), (g_re, g_im) in zip(
                self._pairs, pair_params):
            sxr, sxi = xr, xi
            if sidx is not None:
                s = signs[sidx]
                sxr = s * xr
                sxi = s * xi if xi is not None else None

            def one(gmat, v):
                if gmat is None or v is None:
                    return None
                x5 = v.reshape(A, d_hi, Mmid, d_lo, L)
                return jnp.einsum("abmcl,BCbc->aBmCl", x5, gmat,
                                  precision=prec).reshape(-1)

            rr, ri = one(g_re, sxr), one(g_re, sxi)
            ir, ii = one(g_im, sxr), one(g_im, sxi)
            t_re = rr if ii is None else rr - ii
            yr = yr + t_re
            if ri is not None or ir is not None:
                t_im = (ri if ri is not None else 0.0) \
                    + (ir if ir is not None else 0.0)
                yi = (yi if yi is not None else 0.0) + t_im
            # same anti-batching barrier as _contract_frame
            if yi is None:
                yr = jax.lax.optimization_barrier(yr)
            else:
                yr, yi = jax.lax.optimization_barrier((yr, yi))

        if self._passes:
            # tie the label iota to x so the per-pass index math stays
            # loop-VARIANT inside solver fori/while loops — hoisted as an
            # invariant, every pass's N-sized digit/amp arrays would be
            # live simultaneously (measured 34G at N = 2^24 f64)
            tie = jax.lax.optimization_barrier(xr[0] * 0).astype(jnp.int32)
            lab = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1) \
                + tie
            yr, yi = _apply_roll_passes(self.space, self._passes, lab,
                                        xr, xi, yr, yi, dt)
        return (yr, yi)

    def __call__(self, x):
        return self._jit_apply(self.params, x)

    # ------------------------------------------------------ sector interop

    def to_full(self, x_sector):
        import jax.numpy as jnp

        assert self.sector_labels is not None
        out = []
        for part in x_sector:
            if part is None:
                out.append(None)
                continue
            full = np.zeros(self.N)
            full[self.sector_labels] = np.asarray(part)
            out.append(jnp.asarray(full, self.dtype))
        return tuple(out)

    def to_sector(self, x_full):
        import jax.numpy as jnp

        assert self.sector_labels is not None
        out = []
        for part in x_full:
            out.append(None if part is None else
                       jnp.asarray(np.asarray(part)[self.sector_labels]))
        return tuple(out)

    @property
    def nnz_estimate(self) -> int:
        if self.sector_labels is None:
            return self.N * (1 + self.compiled.nnz_per_row)
        return self.sector_labels.size * (1 + self.compiled.nnz_per_row)


def _pair_G(space, slots, dims, jstr, M, w_in, s_lo, s_hi):
    """Dense (d_hi, d_lo, d_hi, d_lo) tensor G[B, C, b, c] for a term whose
    support is exactly the two slots {s_lo, s_hi}, including intra-support
    Jordan-Wigner signs from the fermion count tables (same sign convention
    as :meth:`ContractPlan.window_G`)."""
    d_lo, d_hi = int(space.dims[s_lo]), int(space.dims[s_hi])
    dims_a = np.asarray(dims, dtype=np.int64)
    F = space.fermion_count_table
    G = np.zeros((d_hi, d_lo, d_hi, d_lo), dtype=np.complex128)
    rr, cc = np.nonzero(np.abs(M) > _AMP_TOL)
    for rj, cj in zip(rr, cc):
        rdig = (int(rj) // jstr) % dims_a
        cdig = (int(cj) // jstr) % dims_a
        r_lo = r_hi = c_lo = c_hi = 0
        for i, s in enumerate(slots):
            if int(s) == s_lo:
                r_lo, c_lo = int(rdig[i]), int(cdig[i])
            else:
                r_hi, c_hi = int(rdig[i]), int(cdig[i])
        sgn = 1.0
        for s in np.nonzero(w_in)[0]:
            v = c_lo if int(s) == s_lo else c_hi
            if int(F[int(s)][v]) % 2:
                sgn = -sgn
        G[r_hi, r_lo, c_hi, c_lo] += M[rj, cj] * sgn
    return G


# --------------------------------------------------------------------------
# Roll-pass fallback (shared math with ops/apply_fullspace.py)
# --------------------------------------------------------------------------


def _term_roll_passes(space, slots, dims, jstr, M, w):
    """Delta-class passes for one term: [(dlt, slots, jstr, col, wmask, dims)]
    — the roll engine's representation, built from the exact joint matrix."""
    from quantum_basis_tpu.ops.apply_fullspace import _popcount_ok

    if np.any(w) and not _popcount_ok(space, w):
        raise ValueError("roll-fallback term has a JW string that is not "
                         "popcount-compatible; use the ELL engines")
    wmask = 0
    for s in np.nonzero(w)[0]:
        d = int(space.dims[s])
        bits = d.bit_length() - 1
        sh = _bit_shift_of_stride(int(space.strides[s]))
        if sh is None:
            raise ValueError("JW slot at non-power-of-2 stride")
        wmask |= ((1 << bits) - 1) << sh

    D = M.shape[0]
    dims_a = np.asarray(dims, dtype=np.int64)
    gstr = np.asarray([space.strides[s] for s in slots], dtype=np.int64)
    deltas = {}
    for rj, cj in zip(*np.nonzero(np.abs(M) > _AMP_TOL)):
        rdig = (int(rj) // jstr) % dims_a
        cdig = (int(cj) // jstr) % dims_a
        dl = int(np.sum((rdig - cdig) * gstr))
        col = deltas.setdefault(dl, np.zeros(D, dtype=np.complex128))
        col[int(cj)] += M[rj, cj]
    return [(dl, np.asarray(slots, np.int64), np.asarray(jstr, np.int64),
             col, wmask, dims_a.copy()) for dl, col in deltas.items()]


def _apply_roll_passes(space, passes, lab, xr, xi, yr, yi, dt):
    """Accumulate masked-roll passes (the roll engine's hot loop) in dtype."""
    import jax
    import jax.numpy as jnp

    def digit(s, d, i, jstr_i):
        stride = int(space.strides[s])
        sh = _bit_shift_of_stride(stride)
        if sh is not None and d & (d - 1) == 0:
            return (lab >> sh) & (d - 1)
        return (lab // np.int32(stride)) % np.int32(d)

    for dl, slots, jstr, col, wmask, dims in passes:
        nz = np.nonzero(np.abs(col) > _AMP_TOL)[0]
        if wmask:
            par = jax.lax.population_count(lab & np.int32(wmask)) & 1
            sgn = (1.0 - 2.0 * par.astype(dt))
        else:
            sgn = None
        c = jnp.zeros(lab.shape, dtype=jnp.int32)
        for i, s in enumerate(slots):
            c = c + digit(int(s), int(dims[i]), i, None) \
                * np.int32(int(jstr[i]))
        a_re = jnp.zeros(lab.shape, dt)
        a_im = None
        for ci in nz:
            v = col[ci]
            sel = c == np.int32(int(ci))
            a_re = jnp.where(sel, dt.type(v.real), a_re)
            if abs(v.imag) > _AMP_TOL:
                if a_im is None:
                    a_im = jnp.zeros(lab.shape, dt)
                a_im = jnp.where(sel, dt.type(v.imag), a_im)
        if sgn is not None:
            a_re = a_re * sgn
            if a_im is not None:
                a_im = a_im * sgn
        tr = a_re * xr
        ti = None
        if xi is not None:
            ti = a_re * xi
        if a_im is not None:
            ti = (ti if ti is not None else 0.0) + a_im * xr
            if xi is not None:
                tr = tr - a_im * xi
        yr = yr + jnp.roll(tr, dl)
        if ti is not None:
            yi = (yi if yi is not None else 0.0) + jnp.roll(ti, dl)
    return yr, yi
