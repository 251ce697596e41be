"""Lattice translations of full-label-space vectors as block transposes.

The momentum-sector machinery for the full-space engines (the masked-roll
engine in :mod:`quantum_basis_tpu.ops.apply_fullspace` and the window
engine in :mod:`quantum_basis_tpu.ops.apply_contract`): instead of building
the representative basis and paying gather-bound lookups per Hamiltonian
image (the ELL repr path, cf. generate_Ham_sparse_repr / repr MultMv2,
reference src/model.cc:687-836, 1040-1104), solve each momentum sector IN
THE FULL LABEL SPACE with the fast engine, keeping Lanczos inside the sector
with the projector

    P_k = (1/G) sum_R e^{+i k.R} T(R).

The enabling observation: the label-space vector is the state tensor
``(d_{S-1}, ..., d_0)``, and with the lattice's mixed-radix site numbering a
rigid translation by one unit along lattice dimension ``dim`` is a cyclic
shift of a contiguous digit group — on the flat vector, one batched block
transpose

    T_r x = swapaxes(x.reshape(A, P, Q, B), 1, 2).reshape(-1)

with P = d**(r * w) the wrapped top part (w = sites per unit step). No
gathers, no index tables; HBM-bandwidth passes that XLA handles at full
speed. The projector factorizes over dimensions (e^{ik.R} is separable), so
P_k costs sum_d (L_d - 1) translations instead of prod_d L_d.

Fermionic boundary signs: the cyclic shift moves the wrapped block of sites
past the rest, so the permutation parity on a given product state is
``n_P * n_Q`` per independent site block (n_P = fermions wrapped, n_Q =
fermions passed over) — an elementwise sign computed once per (dim, shift)
from per-slot fermion-parity tables (replacing the reference's bubble-sort
swap counting, src/basis.cc:598-609, with a precomputed sign vector).

Eigenvector interop: a normalized full-space eigenvector |psi> in sector k
expands over the repr basis |r,k> = P_k|r>/sqrt(nu_r) with coefficients
c_r = <r,k|psi> = psi[r]/sqrt(nu_r) — one small gather at rep labels.

Reference parity: replaces the momentum-sector matrix-free apply
(src/model.cc:941-1121 repr branch) for lattices whose site numbering is the
plain mixed-radix grid (all named Bravais lattices; tilted TOML clusters
fall back to the ELL path).
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu.utils.codec import radix_decode, radix_encode

_PHASE_TOL = 1e-12


def _digit_layout(lattice):
    """Site-index digits fastest -> slowest: list of (kind, base) where kind
    is a lattice dimension index or 'sub'. None when the lattice does not
    use the plain mixed-radix numbering (e.g. tilted clusters)."""
    if not hasattr(lattice, "_base") or not hasattr(lattice, "_dim_arr"):
        return None
    if type(lattice).__name__ == "TiltedLattice":
        return None
    base = [int(b) for b in lattice._base]
    if lattice._sub_pos == 0:
        kinds = ["sub"] + list(lattice._dim_arr)
    else:
        kinds = list(lattice._dim_arr) + ["sub"]
    return list(zip(kinds, base))


class RollTranslations:
    """Translations of full-space vectors as batched block transposes.

    Raises ValueError when unsupported; use :meth:`supported` to probe.
    """

    def __init__(self, space, lattice):
        layout = _digit_layout(lattice)
        if layout is None:
            raise ValueError("lattice site numbering is not plain mixed-radix")
        self.space = space
        self.lattice = lattice
        self.layout = layout
        n_latt = int(lattice.Nsites)

        # orbital blocks: contiguous slot ranges, uniform local dim, one slot
        # per lattice site (the StateSpace layout guarantees the first two)
        self.blocks = []  # (s0, n_sites, d_local)
        s0 = 0
        for sb, n_sites in space.orbitals:
            if n_sites != n_latt:
                raise ValueError("orbital does not cover every lattice site")
            self.blocks.append((s0, n_sites, int(sb.dim_local)))
            s0 += n_sites
        self.N = int(space.label_space)

        # per lattice dim: digit position + sites per unit step
        self._dim_info = {}
        below = 1
        for pos, (kind, b) in enumerate(layout):
            if kind != "sub":
                self._dim_info[int(kind)] = (pos, below, b)
            below *= b

        self._sign_cache = {}
        self._self_check()

    # ----------------------------------------------------------- validation

    @staticmethod
    def supported(space, lattice) -> bool:
        try:
            RollTranslations(space, lattice)
            return True
        except (ValueError, KeyError):
            return False

    def _self_check(self, n_probe: int = 256):
        """Verify the transpose map against the lattice permutation oracle
        (space.transform over translation_plan) on random labels, for a unit
        shift along every pbc dimension. Cheap and load-bearing: it pins the
        digit-layout assumptions to the actual site numbering. Skipped for
        label spaces too large to hold a dense host vector (the layout is
        size-independent, so small-system coverage transfers)."""
        if self.N > (1 << 22):
            return
        rng = np.random.default_rng(7)
        probes = np.unique(rng.integers(0, self.N, size=min(n_probe, self.N),
                                        dtype=np.int64))
        vals = np.arange(1.0, probes.size + 1)
        for d in self.lattice.trans_dims:
            if int(self.lattice.L[d]) < 2:
                continue
            disp = np.zeros(self.lattice.dim, dtype=np.int64)
            disp[d] = 1
            plan = self.lattice.translation_plan(disp)
            new_labels, parity = self.space.transform(probes, plan)
            x = np.zeros(self.N)
            x[probes] = vals
            sgn = self.sign_host(d, 1)
            y = self.translate(x * sgn if sgn is not None else x, d, 1)
            want = vals * np.where(parity % 2 == 0, 1.0, -1.0)
            if not np.allclose(y[new_labels], want):
                raise ValueError(
                    f"translation self-check failed along dim {d}")

    # ----------------------------------------------------------- transposes
    #
    # Primitive: _bt(x, A, P, Q, B) = swapaxes(x.reshape(A,P,Q,B), 1, 2) — a
    # batched block transpose. A unit translation cyclically shifts one
    # site-digit; the digit's cyclic groups repeat once per combination of
    # HIGHER site-digits, and each such group needs its own _bt (the groups
    # nest inside the higher digits, so a single batched transpose cannot
    # cover them all). The chained _bt's compose into one label permutation;
    # XLA's algebraic simplifier collapses transpose-of-transpose, so the
    # jitted cost is one fused copy, not H passes.

    @staticmethod
    def _bt(x, A, P, Q, B):
        if P == 1 or Q == 1:
            return x
        xp = np if isinstance(x, np.ndarray) else None
        if xp is None:
            import jax.numpy as jnp
            xp = jnp
        return xp.swapaxes(x.reshape(A, P, Q, B), 1, 2).reshape(-1)

    def _specs(self, d: int, r: int):
        """_bt specs for shift r along dim d: one per (orbital block,
        higher-digit combination)."""
        _, w, L = self._dim_info[int(d)]
        r = int(r) % L
        specs = []
        for (s0, n_sites, dl) in self.blocks:
            below_blk = 1
            for s in range(s0):
                below_blk *= int(self.space.dims[s])
            above_blk = 1
            for s in range(s0 + n_sites, self.space.n_slots):
                above_blk *= int(self.space.dims[s])
            grp_sites = L * w
            n_hi = n_sites // grp_sites
            grp = dl ** grp_sites
            P = dl ** (r * w)
            Q = grp // P
            for h in range(n_hi):
                B = below_blk * (grp ** h)
                A = above_blk * (grp ** (n_hi - 1 - h))
                specs.append((A, P, Q, B))
        return specs

    def translate(self, x, d: int, r: int):
        """T_r along dim d applied to a flat vector (numpy or jax). Signs are
        NOT folded in — multiply by :meth:`sign_host`/device sign first."""
        _, w, L = self._dim_info[int(d)]
        r = int(r) % L
        if r == 0:
            return x
        for spec in self._specs(d, r):
            x = self._bt(x, *spec)
        return x

    def translate_disp(self, x, disp):
        """Composite translation by an integer displacement vector."""
        for d in range(self.lattice.dim):
            r = int(disp[d]) % int(self.lattice.L[d])
            if r:
                x = self.translate(x, d, r)
        return x

    # ------------------------------------------------------------ signs

    def sign_host(self, d: int, r: int) -> np.ndarray | None:
        """Elementwise fermionic boundary sign for shift r along dim d, as a
        float64 (+1/-1) numpy array over all labels; None when non-fermionic
        or the shift is trivial. Cached."""
        if not self.space.fermionic:
            return None
        pos, w, L = self._dim_info[int(d)]
        r = int(r) % L
        if r == 0:
            return None
        key = (int(d), r)
        if key in self._sign_cache:
            return self._sign_cache[key]

        space = self.space
        base = np.asarray([b for _, b in self.layout], dtype=np.int64)
        sites = np.arange(self.lattice.Nsites, dtype=np.int64)
        digits = radix_decode(sites, base)
        digit_d = digits[:, pos]
        hi = digits[:, pos + 1:]
        hi_key = (radix_encode(hi, base[pos + 1:])
                  if hi.shape[1] else np.zeros(sites.size, dtype=np.int64))
        wrapped = digit_d >= (L - r)

        F = space.fermion_count_table
        labels = np.arange(self.N, dtype=np.int64)
        pow2 = all(int(dd) & (int(dd) - 1) == 0 for dd in space.dims)
        shifts = [int(s).bit_length() - 1 for s in space.strides]

        def slot_parity(s):
            dl = int(space.dims[s])
            if pow2:
                dig = (labels >> shifts[s]) & (dl - 1)
            else:
                dig = (labels // int(space.strides[s])) % dl
            odd = (F[s, :dl] % 2).astype(np.uint8)
            return odd[dig]

        sign_bit = np.zeros(self.N, dtype=np.uint8)
        for (s0, n_sites, dl) in self.blocks:
            for a in np.unique(hi_key):
                in_block = hi_key == a
                parP = np.zeros(self.N, dtype=np.uint8)
                parQ = np.zeros(self.N, dtype=np.uint8)
                anyP = anyQ = False
                for site in sites[in_block]:
                    s = s0 + int(site)
                    if not np.any(F[s, : int(space.dims[s])] % 2):
                        continue
                    if wrapped[site]:
                        parP ^= slot_parity(s)
                        anyP = True
                    else:
                        parQ ^= slot_parity(s)
                        anyQ = True
                if anyP and anyQ:
                    sign_bit ^= parP & parQ
        out = 1.0 - 2.0 * sign_bit.astype(np.float64)
        self._sign_cache[key] = out
        return out


class MomentumProjector:
    """P_k over the full label space, factorized per lattice dimension.

    ``apply(params, (xr, xi))`` is jit-safe (params carries the device sign
    arrays); ``apply_host`` is the numpy twin used for solver random
    injections. Phase convention P_k = (1/G) sum_R e^{+i k.R} T(R), matching
    basis.translation (validated against the repr-path golden values).
    """

    def __init__(self, rolls: RollTranslations, momentum, dtype=None,
                 force_complex: bool = False):
        import jax.numpy as jnp

        self.rolls = rolls
        self.space = rolls.space
        lattice = rolls.lattice
        self.momentum = tuple(int(x) for x in np.atleast_1d(momentum))
        self.dtype = jnp.dtype(dtype or jnp.float64)

        # per pbc dim: list of (r, sign_index); phases go into ``params`` as
        # TRACED scalars so every momentum sector of a model shares one
        # compiled program (baked-in phase constants made each k-sector a
        # distinct HLO, re-paying the compile of every solver program per
        # sector)
        self.dims = []
        signs_np = []
        phases_np = []  # aligned with terms in iteration order: (cos, sin)
        for d in lattice.trans_dims:
            L = int(lattice.L[d])
            if L < 2:
                continue
            terms = []
            for r in range(1, L):
                disp = np.zeros(lattice.dim)
                disp[d] = r
                ang = 2.0 * np.pi * float(lattice.k_dot_R(self.momentum,
                                                          disp[None, :])[0])
                c, s = float(np.cos(ang)), float(np.sin(ang))
                sgn = rolls.sign_host(d, r)
                sidx = None
                if sgn is not None:
                    sidx = len(signs_np)
                    signs_np.append(sgn)
                terms.append((r, sidx))
                phases_np.append((c, s))
            self.dims.append((d, L, terms))
        self._signs_np = signs_np
        self._phases_np = np.asarray(phases_np, dtype=np.float64).reshape(
            -1, 2)
        self._params_dev = None
        # force_complex keeps the traced structure identical across ALL
        # momenta (k = 0 / L/2 phases are real, which would otherwise emit
        # a distinct — separately compiled — program)
        self.complex_phases = bool(force_complex or
            np.any(np.abs(self._phases_np[:, 1]) > _PHASE_TOL))
        self.is_identity = not self.dims

    @property
    def params(self):
        import jax.numpy as jnp

        if self._params_dev is None:
            self._params_dev = (
                tuple(jnp.asarray(s, self.dtype) for s in self._signs_np),
                jnp.asarray(self._phases_np, self.dtype),
            )
        return self._params_dev

    # ------------------------------------------------------------- device

    def _apply_impl(self, signs, phases, xr, xi):
        """Shared device/host body: per dim, sum the phased signed shifts.

        ``phases`` is the (n_terms, 2) cos/sin array (device or numpy);
        whether the imaginary phase path is emitted is decided by the
        sector-independent ``complex_phases`` flag, keeping the traced
        structure identical for every complex-sector momentum.
        """
        rolls = self.rolls
        t_idx = 0
        cplx = self.complex_phases
        for (d, L, terms) in self.dims:
            acc_r = xr
            acc_i = xi
            for (r, sidx) in terms:
                c = phases[t_idx, 0]
                s = phases[t_idx, 1]
                t_idx += 1
                sxr, sxi = xr, xi
                if sidx is not None:
                    sg = signs[sidx]
                    sxr = sg * xr
                    sxi = sg * xi if xi is not None else None
                tr = rolls.translate(sxr, d, r)
                ti = (rolls.translate(sxi, d, r)
                      if sxi is not None else None)
                # (c + i s) * (tr + i ti)
                pr = c * tr - (s * ti if ti is not None and cplx else 0.0)
                pi = None
                if cplx:
                    pi = s * tr + (c * ti if ti is not None else 0.0)
                elif ti is not None:
                    pi = c * ti
                acc_r = acc_r + pr
                if pi is not None:
                    acc_i = pi if acc_i is None else acc_i + pi
                # serialize term accumulation on device: without the
                # barrier XLA keeps every translation's (N,) temporaries
                # live to schedule them in parallel — at N = 2^24 f64
                # complex the P_k H program needed 15.80G of 15.75G HBM
                # (compile-time OOM); pinning the accumulation order lets
                # buffer assignment reuse the roll scratch per term
                if not isinstance(acc_r, np.ndarray):
                    import jax

                    if acc_i is None:
                        acc_r = jax.lax.optimization_barrier(acc_r)
                    else:
                        acc_r, acc_i = jax.lax.optimization_barrier(
                            (acc_r, acc_i))
            inv = 1.0 / L
            xr = acc_r * inv
            xi = acc_i * inv if acc_i is not None else None
        return xr, xi

    def apply(self, params, x):
        """P_k (xr, xi) -> (yr, yi); xi may be None (yi appears only when
        phases are complex)."""
        signs, phases = params
        return self._apply_impl(signs, phases, x[0], x[1])

    # --------------------------------------------------------------- host

    def apply_host(self, re, im):
        """numpy twin of apply (used for solver start/injection vectors)."""
        re = np.asarray(re, dtype=np.float64)
        im = None if im is None else np.asarray(im, dtype=np.float64)
        return self._apply_impl(self._signs_np, self._phases_np, re, im)


class ProjectedFullOp:
    """y = P_k H x over the full label space — the fast momentum-sector
    matvec (H commutes with T(R), so on sector-k vectors this is exactly the
    sector Hamiltonian; the projection kills numerical drift out of the
    sector each application).

    Protocol-compatible with the full-space engines (params/apply/mask/
    to_full/to_sector/nnz_estimate); ``project_host`` projects solver
    start/injection vectors (QN mask then P_k).
    """

    def __init__(self, base, projector: MomentumProjector):
        self.base = base
        self.projector = projector
        self.space = base.space
        self.N = base.N
        self.n = base.N
        self.dtype = getattr(base, "dtype", None)
        self.is_complex = bool(getattr(base, "is_complex", False)
                               or projector.complex_phases)
        self.mask = base.mask
        self.sector_labels = base.sector_labels

    @property
    def params(self):
        return (self.base.params, self.projector.params)

    def apply(self, params, x):
        bp, pp = params
        y = self.base.apply(bp, x)
        yr, yi = self.projector.apply(pp, y)
        if yi is None and self.is_complex:
            import jax.numpy as jnp

            yi = jnp.zeros_like(yr)
        return (yr, yi)

    def __call__(self, x):
        return self.apply(self.params, x)

    def project_host(self, re, im):
        if self.mask is not None:
            m = np.asarray(self.mask, dtype=np.float64)
            re = re * m
            im = im * m if im is not None else None
        if self.is_complex and im is None:
            im = np.zeros_like(re)
        return self.projector.apply_host(re, im)

    def to_full(self, x_sector):
        return self.base.to_full(x_sector)

    def to_sector(self, x_full):
        return self.base.to_sector(x_full)

    @property
    def nnz_estimate(self) -> int:
        return self.base.nnz_estimate
