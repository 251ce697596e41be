"""Full-label-space matrix-free apply: Hamiltonian terms as masked rolls.

An apply built from dense elementwise passes only: where arbitrary gathers
run far below memory bandwidth while dense passes run at it, instead of
gathering per matrix entry (ELL) or per image (matrix-free row kernel), this
engine keeps vectors over the ENTIRE mixed-radix label space and expresses
every off-diagonal image class as

    y += roll(amp(label) * jw_sign(label) * x, delta)

where ``delta`` is the CONSTANT label displacement of that image class
(ladder-structured operators displace every source state by the same
per-class stride offset), ``amp`` is a per-joint-column value computed
elementwise from label digits (no tables, no gathers), and the Jordan-Wigner
sign is a popcount over a precomputed bitmask. All passes are dense,
regular, fusable elementwise work.

Trade-off: vectors are label_space long instead of sector-dim long (e.g.
6.2x for the L=24 Sz=0 chain), but each element-touch is a dense pass
instead of a gather. The successor engine in ops/apply_contract.py turns
bond groups into window contractions (matmuls) and is the default; this
engine is its f64 fallback. Sector
states stay exactly in-sector (H conserves the quantum numbers and
out-of-sector amplitudes start and remain zero); random solver restarts are
projected by the sector mask.

Supported when (a) label_space fits int32 and memory, (b) every slot crossed
by a Jordan-Wigner string has a power-of-2 local dimension whose fermion
count is popcount-compatible mod 2 (spin-1/2, spinless fermion, electron).
``supports_fullspace`` reports this; callers fall back to the ELL /
row-gather engines otherwise (e.g. t-J, d=3).

Reference parity: this replaces model::MultMv2 (src/model.cc:941-1121) for
full sectors; there is no analog in the reference — it is a design for
devices with cheap dense bandwidth and expensive random access.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu.ops.compile import CompiledOperator, compile_diagonal

_AMP_TOL = 1e-14


def _popcount_ok(space, w: np.ndarray) -> bool:
    """Can the JW parity for weight vector w be a label popcount?"""
    F = space.fermion_count_table
    for s in np.nonzero(w)[0]:
        d = int(space.dims[s])
        if d & (d - 1):
            return False  # non-power-of-2 digit occupies a bit range unevenly
        for v in range(d):
            if (int(F[s][v]) - int(bin(v).count("1"))) % 2 != 0:
                return False
    return True


def supports_fullspace(compiled: CompiledOperator,
                       max_label_space: int = 1 << 27) -> bool:
    space = compiled.space
    if int(space.label_space) > max_label_space:
        return False
    for g in compiled.groups:
        for t in range(g.n_terms):
            if np.any(g.W[t]) and not _popcount_ok(space, g.W[t]):
                return False
    return True


def _bit_shift_of_stride(stride: int) -> int | None:
    return int(stride).bit_length() - 1 if stride & (stride - 1) == 0 else None


class FullSpaceOp:
    """y = H x over the full label space (split-complex protocol).

    ``sector_labels`` (optional) builds the 0/1 sector mask used to project
    solver-injected random vectors and to convert to/from sector coordinates.
    """

    def __init__(self, compiled: CompiledOperator, sector_labels=None):
        import jax
        import jax.numpy as jnp

        space = compiled.space
        self.space = space
        self.compiled = compiled
        N = int(space.label_space)
        if N > (1 << 31) - 1:
            raise ValueError("label space exceeds int32 range")
        self.N = N
        self.n = N  # solver-facing dimension

        # ---- compile passes: (delta, slots, amp_col (D,), wmask, jstr, dims)
        passes = []
        any_im = False
        for g in compiled.groups:
            T, D, K = g.dlt.shape
            for t in range(T):
                slots = g.slots[t]
                jstr = g.jstrides[t]
                dims = [int(space.dims[s]) for s in slots]
                w = g.W[t]
                if np.any(w) and not _popcount_ok(space, w):
                    raise ValueError("JW string not popcount-compatible; "
                                     "use the ELL / row-gather engines")
                wmask = 0
                for s in np.nonzero(w)[0]:
                    d = int(space.dims[s])
                    bits = d.bit_length() - 1
                    sh = _bit_shift_of_stride(int(space.strides[s]))
                    # power-of-2 dims on a mixed-radix space may still sit at
                    # non-power-of-2 strides; then popcount masking fails
                    if sh is None:
                        raise ValueError("JW slot at non-power-of-2 stride")
                    wmask |= ((1 << bits) - 1) << sh
                amp = g.amp_re[t] + (1j * g.amp_im[t]
                                     if g.amp_im is not None else 0.0)
                deltas = {}
                for c in range(D):
                    for k in range(K):
                        a = amp[c, k]
                        if abs(a) <= _AMP_TOL:
                            continue
                        dl = int(g.dlt[t, c, k])
                        col = deltas.setdefault(
                            dl, np.zeros(D, dtype=np.complex128))
                        col[c] += a
                for dl, col in deltas.items():
                    any_im = any_im or np.max(np.abs(col.imag)) > _AMP_TOL
                    passes.append((dl, np.asarray(slots, np.int64),
                                   np.asarray(jstr, np.int64), col, wmask,
                                   np.asarray(dims, np.int64)))
        self._passes = passes
        self.is_complex = any_im

        # ---- full-space diagonal, built once on device
        if compiled.diag_terms.q_zero():
            diag_fn = None
        else:
            diag_fn = _diag_elementwise(compiled.diag_terms, space)

        def build_diag():
            lab = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1)
            return diag_fn(lab) if diag_fn is not None else jnp.zeros(N)

        self.diag_full = jax.jit(build_diag)()

        # ---- sector mask + coordinates
        self.sector_labels = (np.asarray(sector_labels, dtype=np.int64)
                              if sector_labels is not None else None)
        if self.sector_labels is not None:
            m = np.zeros(N, dtype=np.float64)
            m[self.sector_labels] = 1.0
            self.mask = jnp.asarray(m)
        else:
            self.mask = None

        self._jit_apply = jax.jit(self.apply)

    # ------------------------------------------------------------- protocol

    @property
    def params(self):
        return (self.diag_full,)

    def apply(self, params, x):
        return self._run_passes(params, x, self._passes, with_diag=True)

    def make_chunked_applies(self, n_chunks: int = 6):
        """Jitted partial applies whose outputs SUM to ``apply(params, x)``.

        Chunk 0 carries the diagonal; chunk i covers a contiguous slice of
        the roll passes. Purpose: at N = 2^24 f64 the monolithic apply
        program's temporaries approach the whole chip and fail on a
        fragmented allocator — several small programs with ~1/n of the
        passes allocate in proportionally small blocks (see
        solvers/rqi.py's outer pipeline).
        """
        import jax

        n_chunks = max(1, min(int(n_chunks), max(len(self._passes), 1)))
        groups = np.array_split(np.arange(len(self._passes)), n_chunks)
        fns = []
        for ci, ix in enumerate(groups):
            sub = [self._passes[i] for i in ix]

            def partial(params, x, _sub=sub, _d=(ci == 0)):
                return self._run_passes(params, x, _sub, with_diag=_d)

            fns.append(jax.jit(partial))
        return fns

    def _run_passes(self, params, x, passes, with_diag):
        import jax
        import jax.numpy as jnp

        (diag,) = params
        xr, xi = x
        N = self.N
        lab = jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1)

        def digits_of(slots, jstr, dims):
            c = jnp.zeros(N, dtype=jnp.int32)
            for i, s in enumerate(slots):
                stride = int(self.space.strides[s])
                d = int(dims[i])
                sh = _bit_shift_of_stride(stride)
                if sh is not None and d & (d - 1) == 0:
                    dig = (lab >> sh) & (d - 1)
                else:
                    dig = (lab // np.int32(stride)) % np.int32(d)
                c = c + dig * np.int32(int(jstr[i]))
            return c

        def col_select(slots, jstr, dims, ci):
            """Boolean: does label's joint column equal ci? Built as a
            conjunction of per-slot digit tests (no intermediate c array)."""
            sel = None
            rem = int(ci)
            for i, s in enumerate(slots):
                stride = int(self.space.strides[s])
                d = int(dims[i])
                want = rem % d if i + 1 < len(slots) else rem
                if i + 1 < len(slots):
                    rem //= d
                sh = _bit_shift_of_stride(stride)
                if sh is not None and d & (d - 1) == 0:
                    dig = (lab >> sh) & (d - 1)
                else:
                    dig = (lab // np.int32(stride)) % np.int32(d)
                t = dig == np.int32(want)
                sel = t if sel is None else sel & t
            return sel

        if with_diag:
            yr = diag * xr
            yi = None if (xi is None and not self.is_complex) else \
                diag * (xi if xi is not None else jnp.zeros_like(xr))
        else:
            yr = jnp.zeros_like(xr)
            yi = None if (xi is None and not self.is_complex) else \
                jnp.zeros_like(xr)
        xi_ = xi
        for dl, slots, jstr, col, wmask, dims in passes:
            nz = np.nonzero(np.abs(col) > _AMP_TOL)[0]
            if wmask:
                par = jax.lax.population_count(lab & np.int32(wmask)) & 1
                sgn = 1.0 - 2.0 * par.astype(xr.dtype)
            else:
                sgn = None
            if nz.size == 1 and abs(col[nz[0]].imag) <= _AMP_TOL:
                # fast path (ladder terms): one masked constant, fully fused
                sel = col_select(slots, jstr, dims, int(nz[0]))
                a = float(col[nz[0]].real)
                src = a * xr if sgn is None else (a * sgn) * xr
                tr = jnp.where(sel, src, 0.0)
                ti = None
                if xi_ is not None:
                    srci = a * xi_ if sgn is None else (a * sgn) * xi_
                    ti = jnp.where(sel, srci, 0.0)
            else:
                # general path: digit-decoded column -> where-chain amplitude
                c = digits_of(slots, jstr, dims)
                a_re = jnp.zeros(N)
                a_im = None
                for ci in nz:
                    v = col[ci]
                    sel = c == np.int32(int(ci))
                    a_re = jnp.where(sel, float(v.real), a_re)
                    if abs(v.imag) > _AMP_TOL:
                        if a_im is None:
                            a_im = jnp.zeros(N)
                        a_im = jnp.where(sel, float(v.imag), a_im)
                if sgn is not None:
                    a_re = a_re * sgn
                    if a_im is not None:
                        a_im = a_im * sgn
                tr = a_re * xr
                ti = None
                if xi_ is not None:
                    ti = a_re * xi_
                if a_im is not None:
                    ti = (ti if ti is not None else 0.0) + a_im * xr
                    if xi_ is not None:
                        tr = tr - a_im * xi_
            yr = yr + jnp.roll(tr, dl)
            if ti is not None:
                yi = (yi if yi is not None else 0.0) + jnp.roll(ti, dl)
        return (yr, yi)

    def __call__(self, x):
        return self._jit_apply(self.params, x)

    # ------------------------------------------------------ sector interop

    def to_full(self, x_sector):
        """Sector-coordinate cvec -> full-space cvec (host scatter, once)."""
        import jax.numpy as jnp

        assert self.sector_labels is not None
        out = []
        for part in x_sector:
            if part is None:
                out.append(None)
                continue
            full = np.zeros(self.N)
            full[self.sector_labels] = np.asarray(part)
            out.append(jnp.asarray(full))
        return tuple(out)

    def to_sector(self, x_full):
        """Full-space cvec -> sector coordinates (host gather, once)."""
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


def _diag_elementwise(diag_terms, space):
    """Elementwise diagonal evaluator label -> sum of per-term products.

    Unlike compile_diagonal (which consumes decoded V), this reads digits
    straight out of the label iota so the (label_space,) diagonal can be
    built on device without materializing V for the whole space.
    """
    import jax.numpy as jnp

    terms = []
    const = 0.0
    for t in diag_terms.terms:
        if t.q_identity():
            const += float(np.real(t.coeff))
            continue
        slots = [space.slot(f.site, f.orbital) for f in t.factors]
        # diag fast-path terms are real by construction (compile_operator)
        tabs = [np.asarray(f.mat).real.astype(np.float64) for f in t.factors]
        terms.append((float(np.real(t.coeff)), slots, tabs))

    def evaluate(lab):
        out = jnp.full(lab.shape, const)
        for coeff, slots, tabs in terms:
            prod = jnp.full(lab.shape, coeff)
            for s, tab in zip(slots, tabs):
                stride = int(space.strides[s])
                d = int(space.dims[s])
                sh = _bit_shift_of_stride(stride)
                if sh is not None and d & (d - 1) == 0:
                    dig = (lab >> sh) & (d - 1)
                else:
                    dig = (lab // np.int32(stride)) % np.int32(d)
                val = jnp.zeros(lab.shape)
                for v in range(d):
                    if abs(tab[v]) > _AMP_TOL:
                        val = jnp.where(dig == v, float(tab[v]), val)
                prod = prod * val
            out = out + prod
        return out

    return evaluate
