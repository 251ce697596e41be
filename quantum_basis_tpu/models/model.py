"""Model orchestration: orbitals + Hamiltonian -> bases, spectra, measurements.

The JAX counterpart of the reference's ``model<T>`` god-object
(reference: src/model.cc, src/qbasis.h:1263-1646), with the same user-facing
flow:

    m = Model(lattice)
    m.add_orbital(lattice.n_sites, "spin-1/2")
    m.add_Ham(...)                          # symbolic Mopr algebra
    m.enumerate_basis_full([Sz], [0.0])
    m.locate_E0_lanczos()                   # -> m.eigenvals_full
    m.measure_full_static(Sz0Sz1, 0, 0)

Sectors are kept per integer index ``sec`` exactly like the reference's
per-sector arrays (default 5 sectors, src/model.cc:75-103). The momentum
("repr") machinery lives in :mod:`quantum_basis_tpu.basis.translation` and is
driven from here.
"""

from __future__ import annotations

import itertools

import numpy as np

from quantum_basis_tpu.basis.enumerate import enumerate_basis
from quantum_basis_tpu.basis.index import BasisIndex
from quantum_basis_tpu.basis.site_basis import SiteBasis
from quantum_basis_tpu.basis.state import StateSpace
from quantum_basis_tpu.ops import cplx as cx
from quantum_basis_tpu.ops.apply import DeviceBasis, MatvecFull, mopr_x_vec
from quantum_basis_tpu.config import next_program_key
from quantum_basis_tpu.ops.compile import compile_operator
from quantum_basis_tpu.ops.dense import dense_matrix
from quantum_basis_tpu.ops.operators import Mopr, Opr, OprProd
from quantum_basis_tpu.solvers.lanczos import lanczos_dynamics, lanczos_ground
from quantum_basis_tpu.utils.rng import vec_randomize

_DENSE_CUTOFF = 600  # sectors at/below this size are solved densely on host
_POLISH_N = 1 << 22  # above this full-space N, f64 polish = 2-vector Lanczos


def _fullspace_engine(compiled, dtype, labels=None):
    """The window-contraction engine (matmuls at HIGHEST in f32 — the
    mixed-precision Krylov hot path); the masked-roll engine as the f64
    fallback for operators the contraction engine does not support; else
    None."""
    import jax.numpy as jnp

    from quantum_basis_tpu.ops.apply_contract import (ContractOp,
                                                      supports_contract)
    from quantum_basis_tpu.ops.apply_fullspace import (FullSpaceOp,
                                                       supports_fullspace)

    if supports_contract(compiled):
        return ContractOp(compiled, labels, dtype=dtype)
    if dtype != jnp.dtype(jnp.float32) and supports_fullspace(compiled):
        return FullSpaceOp(compiled, labels)
    return None


class Sector:
    """One quantum-number (and optionally momentum) sector: basis + matvec."""

    _serial_counter = itertools.count()

    def __init__(self):
        # monotonic identity: re-enumerating a sector slot creates a new
        # Sector with a new serial, so caches keyed on it can never hand
        # back device state built against a previous basis
        self.serial = next(Sector._serial_counter)
        self.labels: np.ndarray | None = None
        self.dbasis: DeviceBasis | None = None
        self.matvec = None
        self.dim = 0
        self.momentum = None
        self.evals: list = []   # per-sector stored eigenpairs (the reference
        self.evecs: list = []   # keeps per-sector arrays, src/model.cc:75-103)


class _SectorOpView:
    """Per-momentum view over a SHARED ProjectedFullOp template.

    The template's traced structure is momentum-independent (phases are
    params, complex structure forced), so every sector runs the same
    compiled programs; the view only swaps the params and the host-side
    projector. ``program_key`` lets solvers reuse their jitted device ops
    across views (solvers/restarted.py::_device_ops, solvers/rqi.py).
    """

    def __init__(self, template, params, project_host, momentum):
        self._template = template
        self.apply = template.apply
        self.params = params
        self.N = template.N
        self.n = template.N
        self.dtype = template.dtype
        self.is_complex = True
        self.mask = template.mask
        self.sector_labels = template.sector_labels
        self.program_key = template.program_key
        self.project_host = project_host
        self.momentum = tuple(int(x) for x in np.atleast_1d(momentum))

    def __call__(self, x):
        return self.apply(self.params, x)

    def to_full(self, x_sector):
        return self._template.to_full(x_sector)

    def to_sector(self, x_full):
        return self._template.to_sector(x_full)

    @property
    def nnz_estimate(self) -> int:
        return self._template.nnz_estimate


def _bind_project_host(proj, mask_np):
    """Host projection for solver start/injection vectors: QN mask then P_k."""

    def ph(re, im):
        re = re * mask_np
        im = im * mask_np if im is not None else None
        if proj.complex_phases and im is None:
            im = np.zeros_like(re)
        return proj.apply_host(re, im)

    return ph


class Model:
    def __init__(self, lattice=None, n_secs: int = 5, mesh=None):
        """``mesh``: an optional ``jax.sharding.Mesh`` with one axis; when
        set, sector solves route residency and matvecs through the sharded
        engines automatically (EllShardedHalo / MatvecSharded, auto-picked
        from halo_stats — see :meth:`_mesh_engine`), with Lanczos
        reductions lowering to psum collectives. The reference's model
        object is the single entry point for everything
        (src/model.cc:74-177); the mesh keeps that true across devices."""
        self.mesh = mesh
        self.lattice = lattice
        self._orbitals: list[tuple[SiteBasis, int]] = []
        self._space: StateSpace | None = None
        self.Ham = Mopr()
        self.Ham_vrnl = Mopr()  # Trugman-basis generator (qbasis.h:1269)
        self._compiled = None
        self.sec_full: dict[int, Sector] = {}
        self.sec_repr: dict[int, object] = {}
        self.sec_vrnl: dict[int, object] = {}
        self.eigenvals_full: list[float] = []
        self.eigenvecs_full: list = []  # cvec tuples over sector basis
        self.eigenvals_repr: list[float] = []
        self.eigenvecs_repr: list = []
        self.eigenvals_vrnl: list[float] = []
        self.eigenvecs_vrnl: list = []
        self._e0_sec = 0  # sector of the stored ground state
        self._tset = None
        self._repr_cache = None  # (key, sector labels, orbit reps)
        self._ct = None
        self._vrnl_skel = None  # (key, VrnlMatrix) cache across momenta

    # ------------------------------------------------------------- building

    def add_orbital(self, n_sites: int, name, Nmax: int | None = None):
        """Declare one orbital covering ``n_sites`` sites (cf. model::add_orbital)."""
        if self._space is not None:
            raise RuntimeError("cannot add orbitals after the Hilbert space is built")
        sb = name if isinstance(name, SiteBasis) else SiteBasis.named(name, Nmax=Nmax)
        self._orbitals.append((sb, int(n_sites)))

    @property
    def space(self) -> StateSpace:
        if self._space is None:
            self._space = StateSpace(self._orbitals)
        return self._space

    def add_Ham(self, op):
        """Accumulate a term into H (accepts Opr / OprProd / Mopr)."""
        if isinstance(op, Opr):
            op = Mopr([OprProd(1.0, [op])])
        elif isinstance(op, OprProd):
            op = Mopr([op])
        self.Ham += op
        self._compiled = None
        self._ham_fp = None

    @property
    def compiled_Ham(self):
        if self._compiled is None:
            self._compiled = compile_operator(self.Ham, self.space)
        return self._compiled

    def _ham_fingerprint(self) -> int:
        """Content CRC of the compiled Hamiltonian — folded into every
        solve-stage checkpoint key so a stale ``out_Qckpt/`` written by a
        model with different couplings (same sector dim) is ignored instead
        of silently returned. Same pattern as the Wannier eigenvector cache
        below (cf. the reference's cache re-validation,
        src/model.cc:2163-2187)."""
        fp = getattr(self, "_ham_fp", None)
        if fp is None:
            from quantum_basis_tpu.ops.compile import operator_fingerprint

            fp = self._ham_fp = operator_fingerprint(self.compiled_Ham)
        return fp

    def compile_op(self, op):
        if isinstance(op, Opr):
            op = Mopr([OprProd(1.0, [op])])
        elif isinstance(op, OprProd):
            op = Mopr([op])
        return compile_operator(op, self.space)

    # ----------------------------------------------------------- full basis

    def enumerate_basis_full(self, conserve_lst=None, val_lst=None, sec: int = 0):
        """Enumerate the (sector-filtered) full basis; build device residency.

        cf. model::enumerate_basis_full (src/model.cc:253-271).
        """
        labels = None
        if self.mesh is not None and conserve_lst:
            # distributed enumeration: dnc tiles over the mesh + sample-
            # sort merge; None when a conserved op is not separable
            from quantum_basis_tpu.parallel import (
                enumerate_basis_dnc_sharded)

            labels = enumerate_basis_dnc_sharded(
                self.space, conserve_lst, val_lst, self.mesh)
        if labels is None:
            labels = enumerate_basis(self.space, conserve_lst, val_lst)
        s = Sector()
        s.labels = labels
        s.dim = int(labels.size)
        from quantum_basis_tpu.basis.lin_table import digit_split

        index = BasisIndex(labels, self.space.label_space,
                           lin_split=digit_split(self.space))
        s.dbasis = DeviceBasis(self.space, labels, index,
                               work_per_row=max(self.compiled_Ham.nnz_per_row, 1))
        s.matvec = MatvecFull(self.compiled_Ham, s.dbasis)
        self.sec_full[sec] = s
        return s.dim

    def dim_full(self, sec: int = 0) -> int:
        return self.sec_full[sec].dim

    # --------------------------------------------------- explicit sparse path

    @staticmethod
    def _check_hermiticity(ell, n, complex_vec, check):
        """check in {False, True/"probe", "exact"}: probe = randomized
        O(SpMV) test; "exact" = the reference's full O(nnz) verification
        (src/sparse.cc:235-256)."""
        from quantum_basis_tpu.ops.sparse import (hermiticity_exact,
                                                  hermiticity_probe)

        if not check:
            return
        if check == "exact":
            hermiticity_exact(ell)
        else:
            hermiticity_probe(ell, n, complex_vec)

    def generate_Ham_sparse_full(self, sec: int = 0, check=True):
        """Extract the explicit ELL matrix for a full sector and switch the
        sector's matvec to it (cf. generate_Ham_sparse_full,
        src/model.cc:619-685 — like the reference, the explicit matrix is an
        optional speedup over the matrix-free apply). ``check``: False,
        "probe" (randomized, default) or "exact" (O(nnz) verification)."""
        from quantum_basis_tpu.ops.sparse import build_sparse_full

        s = self.sec_full[sec]
        from quantum_basis_tpu.ops.apply import MatvecFull

        if not isinstance(s.matvec, MatvecFull):
            s.matvec = MatvecFull(self.compiled_Ham, s.dbasis)
        ell = build_sparse_full(s.matvec)
        self._check_hermiticity(ell, s.dim, ell.is_complex, check)
        s.matvec_free = s.matvec  # keep the matrix-free path accessible
        s.matvec = ell
        return ell

    def generate_Ham_sparse_repr(self, sec: int = 0, check=True):
        """Explicit ELL matrix in a momentum sector (cf.
        generate_Ham_sparse_repr, src/model.cc:687-836). ``check`` as in
        :meth:`generate_Ham_sparse_full`."""
        from quantum_basis_tpu.ops.apply_repr import MatvecRepr
        from quantum_basis_tpu.ops.sparse import build_sparse_repr

        s = self.sec_repr[sec]
        if not isinstance(s.matvec, MatvecRepr):
            s.matvec = MatvecRepr(self.compiled_Ham, s.dbasis)
        ell = build_sparse_repr(s.matvec)
        self._check_hermiticity(ell, s.dim, True, check)
        s.matvec_free = s.matvec
        s.matvec = ell
        return ell

    # -------------------------------------------------------------- solvers

    def _dense_solve(self, sector: Sector, nev: int, complex_h: bool):
        H = dense_matrix(self.compiled_Ham, sector.labels)
        assert np.max(np.abs(H - H.conj().T)) < 1e-9, "H not Hermitian"
        evals, evecs = np.linalg.eigh(H)
        vecs = []
        for k in range(min(nev, sector.dim)):
            v = evecs[:, k]
            import jax.numpy as jnp

            vecs.append((jnp.asarray(v.real.copy()),
                         jnp.asarray(v.imag.copy()) if complex_h else None))
        return evals[:nev].tolist(), vecs

    def _fullspace_op(self, sector, max_blowup: float = 64.0, dtype=None):
        """Full-label-space engine for this sector (:func:`_fullspace_engine`)
        when supported and the label-space blowup is worth it; None
        otherwise. Cached per dtype."""
        import jax.numpy as jnp

        from quantum_basis_tpu.ops.apply import MatvecFull

        dtype = jnp.dtype(dtype or jnp.float64)
        cache = getattr(sector, "_fs_cache", None)
        if cache is None:
            cache = sector._fs_cache = {}
        if dtype in cache:
            return cache[dtype]
        if not isinstance(sector.matvec, MatvecFull):
            return None  # explicit sparse was requested; honor it
        if self.space.label_space > max_blowup * max(sector.dim, 1):
            return None
        op = cache[dtype] = _fullspace_engine(self.compiled_Ham, dtype,
                                              sector.labels)
        return op

    def _qn_mask_device(self, dtype):
        """0/1 quantum-number sector mask over the full label space, built
        elementwise ON DEVICE from the conserved diagonal operators (no
        host->device transfer of label-space arrays). Uses the conserve list
        recorded by enumerate_basis_repr."""
        import jax
        import jax.numpy as jnp

        from quantum_basis_tpu.basis.enumerate import _QN_TOL
        from quantum_basis_tpu.ops.compile import compile_diagonal

        conserve_lst, val_lst = getattr(self, "_repr_conserve", ([], []))
        N = int(self.space.label_space)
        if not conserve_lst:
            return jnp.ones(N, dtype)
        evals = [compile_diagonal(m, self.space) for m in conserve_lst]
        vals = [float(v) for v in val_lst]
        C = min(N, 1 << 20)
        nb = (N + C - 1) // C
        space = self.space

        def chunk(start):
            lab = start + jax.lax.broadcasted_iota(jnp.int64, (C, 1), 0)[:, 0]
            V = space.decode(lab)
            ok = lab < N
            for ev, v in zip(evals, vals):
                ok = ok & (jnp.abs(ev(V) - v) < _QN_TOL)
            return ok.astype(dtype)

        def build():
            starts = jnp.arange(nb, dtype=jnp.int64) * C
            return jax.lax.map(chunk, starts).reshape(-1)[:N]

        return jax.jit(build)()

    def _qn_mask_host(self) -> np.ndarray:
        """numpy twin of the QN mask (for solver injection projection).
        Built from the materialized sector labels when available (direct
        repr method); otherwise pulled from the device mask."""
        N = int(self.space.label_space)
        cache = self._repr_cache
        conserve_lst, _ = getattr(self, "_repr_conserve", ([], []))
        if not conserve_lst:
            return np.ones(N)
        if cache is not None and cache[1] is not None \
                and cache[1] is not cache[2]:
            m = np.zeros(N)
            m[cache[1]] = 1.0
            return m
        import jax.numpy as jnp

        return np.asarray(self._qn_mask_device(jnp.float64))

    def _fullspace_repr_op(self, sector, max_blowup: float = 256.0,
                           dtype=None):
        """Momentum-sector solve operator in the FULL label space:
        P_k H with the fast full-space engine + the roll/transpose momentum
        projector (ops/translate_fullspace.py). None when unsupported (tilted
        lattices, oversized blowup, engine constraints) — callers then fall
        back to the gather-bound ELL repr path. Cached per dtype.

        The blowup budget is larger than the full-sector path's because the
        alternative (ELL gathers) is ~2 orders of magnitude slower per nnz.

        ONE operator template is built per dtype and SHARED by every
        momentum sector: the projector phases are traced params and the
        projector is forced onto the complex-structure program, so all k
        share one jitted/compiled executable. Per sector this returns a
        lightweight view carrying the sector's params/host-projector —
        without the sharing, every sector re-pays the XLA compile of every
        solver program (a fresh ``jax.jit`` object recompiles an identical
        program from scratch).
        """
        import jax.numpy as jnp

        from quantum_basis_tpu.ops.translate_fullspace import (
            MomentumProjector, ProjectedFullOp, RollTranslations)

        dtype = jnp.dtype(dtype or jnp.float64)
        cache = getattr(sector, "_fsrepr_cache", None)
        if cache is None:
            cache = sector._fsrepr_cache = {}
        if dtype in cache:
            return cache[dtype]
        shared = getattr(self, "_fsrepr_shared", None)
        if shared is None:
            shared = self._fsrepr_shared = {}
        op = None
        if self.space.label_space <= max_blowup * max(sector.dim, 1):
            rolls = getattr(self, "_rolls", False)
            if rolls is False:
                rolls = None
                if RollTranslations.supported(self.space, self.lattice):
                    rolls = RollTranslations(self.space, self.lattice)
                self._rolls = rolls
            template = shared.get(dtype, False)
            if template is False:
                template = None
                base = None
                if rolls is not None:
                    base = _fullspace_engine(self.compiled_Ham, dtype)
                if base is not None:
                    base.mask = self._qn_mask_device(
                        dtype if dtype == jnp.dtype(jnp.float32)
                        else jnp.float64)
                    proj = MomentumProjector(rolls, sector.momentum,
                                             dtype=dtype, force_complex=True)
                    template = ProjectedFullOp(base, proj)
                    # monotonic key, NOT id(): an id can be recycled after
                    # gc, which would hand a new template another
                    # template's cached jitted ops (solver caches key on
                    # program_key; see solvers/restarted.py::_device_ops)
                    template.program_key = (next_program_key(), str(dtype))
                shared[dtype] = template
            if template is not None:
                proj_k = MomentumProjector(rolls, sector.momentum,
                                           dtype=dtype, force_complex=True)
                mh = self._qn_mask_host()
                op = _SectorOpView(
                    template, (template.base.params, proj_k.params),
                    _bind_project_host(proj_k, mh), sector.momentum)
        cache[dtype] = op
        return op

    def locate_E0_lanczos(self, which: str = "full", nev: int = 1, ncv: int = 1,
                          maxit: int = 2000, sec: int = 0, seed: int = 1):
        """Ground state (and optionally E1) via restarted Lanczos.

        cf. model::locate_E0_lanczos (src/model.cc:1123-1316). The engine is
        the fully-reorthogonalized thick-restart solver: its CGS2 projections
        are (ncv, n) matmuls and — unlike the reference's 2-vector
        recurrence + CG refinement pipeline — it delivers both values and
        vectors to solver tolerance without a separate refinement stage.
        ``nev`` in {1, 2} = energies wanted, ``ncv`` <= nev = vectors kept.
        """
        if which == "vrnl":
            return self._locate_E0_vrnl(nev, ncv, maxit, sec, seed)
        if which != "full":
            return self._locate_E0_lanczos_repr(nev, ncv, maxit, sec, seed)
        sector = self.sec_full[sec]
        complex_h = sector.matvec.is_complex
        if sector.dim <= _DENSE_CUTOFF:
            evals, vecs = self._dense_solve(sector, max(nev, ncv), complex_h)
            self.eigenvals_full = evals
            self.eigenvecs_full = vecs[:ncv]
            sector.evals, sector.evecs = evals, vecs
            self._e0_sec = sec
            return
        if self.mesh is not None:
            return self._locate_E0_mesh(sector, "full", nev, ncv, maxit,
                                        sec, seed)

        from quantum_basis_tpu.solvers.restarted import eigs_smallest

        key = f"lczsE0_full_sec{sec}_nev{nev}_h{self._ham_fingerprint():08x}"
        done = self._ckpt_stage_load(key, complex_h)
        if done is not None:
            evals, vecs = done
        else:
            from quantum_basis_tpu import config

            fs = self._fullspace_op(sector)
            ncv_ = max(12, 2 * nev + 6)
            v0 = None
            fs32 = None
            if fs is not None and config.mixed_precision:
                # mixed-precision stage 1 (SURVEY §7.2 #2): bulk Krylov in
                # f32 on the contraction engine; its Ritz vector warm-starts
                # the f64 polish below (RQI when fs32 exists)
                import jax.numpy as jnp

                fs32 = self._fullspace_op(sector, dtype=jnp.float32)
                if fs32 is not None:
                    cv32 = fs32.is_complex or complex_h
                    v0 = self._f32_stage_cached(
                        fs32, nev, ncv_, maxit, seed, cv32, key)
            if fs is not None:
                evals, vecs_full = self._solve_fullspace(
                    fs, nev, max(12, 2 * nev + 6), maxit, seed,
                    fs.is_complex or complex_h, key + "_krylov", v0,
                    fs32=fs32)
                vecs = [fs.to_sector(v) for v in vecs_full]
            else:
                evals, vecs = eigs_smallest(
                    sector.matvec, sector.dim, nev=nev, ncv=max(12, 2 * nev + 6),
                    maxit=maxit, seed=seed, complex_vec=complex_h,
                    ckpt_key=key + "_krylov",
                )
            self._ckpt_stage_save(key, evals, vecs)
        self.eigenvals_full = evals[:nev]
        self.eigenvecs_full = vecs[:max(ncv, 1)]
        sector.evals, sector.evecs = list(evals), list(vecs)
        self._e0_sec = sec

    @staticmethod
    def _f32_stage_cached(fs32, nev, ncv, maxit, seed, complex_vec, key):
        """f32 Krylov bulk stage with a persisted result record: a
        preempted/retried run reloads the f32 Ritz vector instead of
        re-paying the whole stage (cf. the stage bits of ckpt_lczsE0,
        reference src/model.cc:2521-2749)."""
        from quantum_basis_tpu import config
        from quantum_basis_tpu.solvers.restarted import eigs_smallest
        from quantum_basis_tpu.utils.ckpt import active_store

        store = active_store()
        rkey = key + "_f32res"
        if store is not None:
            rec = store.load(rkey)
            if rec is not None and rec["re"].shape == (fs32.N,):
                import jax.numpy as jnp

                re = jnp.asarray(rec["re"])
                im = jnp.asarray(rec["im"]) if complex_vec else None
                return (re, im)
        _, v32 = eigs_smallest(
            fs32, fs32.N, nev=nev, ncv=ncv, maxit=maxit, seed=seed,
            complex_vec=complex_vec, mask=fs32.mask,
            tol=config.mixed_precision_f32_tol, ckpt_key=key + "_f32",
            verify_degenerate=False)
        if not v32:
            return None
        v0 = v32[0]
        if store is not None:
            store.save(rkey, {
                "re": np.asarray(v0[0]),
                "im": (np.asarray(v0[1]) if v0[1] is not None
                       else np.zeros(1)),
            })
        return v0

    @staticmethod
    def _solve_fullspace(fs, nev, ncv, maxit, seed, complex_vec, ckpt_key,
                         v0, fs32=None):
        """Full-space sector solve: thick restart, or — warm-started at
        large N — the mixed-precision RQI polish.

        The thick-restart basis holds ncv+1 full-space rows, and its CGS2
        matmuls at N = 2^24 generate multi-GiB XLA temporaries (sized for a
        16 GB device; not yet re-derived for 80 GB, ROADMAP Reach 8). Past
        ``_POLISH_N`` the f64 stage therefore runs at 3-4 full-space f64
        vectors: the Jacobi-Davidson RQI polish (solvers/rqi.py — f64
        residuals, f32 correction solves) when the f32 engine twin is
        available, else the
        rolling 2-vector Lanczos kernel (solvers/lanczos.py, the
        reference's own sr_val0 design, src/lanczos.cc:193-264), both from
        the f32 stage's Ritz vector.
        """
        from quantum_basis_tpu.solvers.restarted import eigs_smallest

        if v0 is not None and nev == 1 and fs.N > _POLISH_N:
            import jax.numpy as jnp

            from quantum_basis_tpu.ops import cplx as cx
            from quantum_basis_tpu.solvers.lanczos import lanczos_ground

            re = np.asarray(v0[0], dtype=np.float64)
            im = (np.asarray(v0[1], dtype=np.float64)
                  if v0[1] is not None else None)
            ph = getattr(fs, "project_host", None)
            if ph is not None:
                re, im = ph(re, im)
            elif fs.mask is not None:
                m = np.asarray(fs.mask, dtype=np.float64)
                re = re * m
                im = im * m if im is not None else None
            if complex_vec and im is None:
                im = np.zeros_like(re)
            v0c = (jnp.asarray(re), jnp.asarray(im) if im is not None
                   else None)
            v0c = cx.scale(v0c, 1.0 / float(cx.norm(v0c)))
            if fs32 is not None:
                from quantum_basis_tpu.solvers.restarted import _solver_log
                from quantum_basis_tpu.solvers.rqi import rqi_polish

                out = rqi_polish(
                    fs, v0c, fs32=fs32,
                    ckpt_key=(ckpt_key + "_rqi" if ckpt_key else None),
                    log=lambda i, th, rn, ni: _solver_log(
                        "rqi", i, [th], [rn]))
                if out["converged"]:
                    return [out["E0"]], [out["vector"]]
                # RQI stalled (e.g. f32 gap resolution): fall back to the
                # f64 2-vector kernel warm-started from its best iterate
                v0c = out["vector"]
                v0c = cx.scale(v0c, 1.0 / float(cx.norm(v0c)))
            # long unrestarted cycles: restarting every ~60 steps discards
            # the Krylov subspace each cycle, which for small spectral gaps
            # (kagome: ~1e-3) turns convergence from ~600 total steps into
            # ~25 restarted cycles (measured: rnorm stuck at 1.7e-7 after
            # 2000 matvecs with inner=60; contraction per unrestarted step
            # is e^{-2 sqrt(gap/spread)})
            out = lanczos_ground(fs, v0c, maxit=maxit, inner=120,
                                 ckpt_key=(ckpt_key + "_polish"
                                           if ckpt_key else None))
            # diagnosis for slow sectors (a sector that takes this
            # stall->fallback path costs several times its peers): RQI
            # stalls when the sector gap sits at/below the f32 correction
            # resolution; log the gap estimate from the fallback cycle's
            # tridiagonal so the cause is on record
            try:
                from quantum_basis_tpu.solvers.restarted import _solver_log
                from quantum_basis_tpu.solvers.tridiag import tridiag_eigvals

                if out.get("alphas") is not None \
                        and len(out["alphas"]) >= 2:
                    ev = tridiag_eigvals(out["alphas"], out["betas"])[:2]
                    _solver_log(
                        "rqi", -1,
                        [out["E0"]],
                        [out["residual"],
                         float(ev[1] - ev[0])])  # [resid, gap estimate]
            except Exception:
                pass
            # hard-fail on non-convergence, mirroring eigs_smallest: the
            # gate is lanczos_ground's own residual threshold (a rigorous
            # eigenvalue error bound for Hermitian H). Without this check a
            # maxit-exhausted polish would silently publish an unconverged
            # E0 into sector.evals.
            from quantum_basis_tpu.config import residual_gate

            r_gate = residual_gate(out["E0"])
            if out["residual"] >= r_gate:
                err = RuntimeError(
                    f"full-space Lanczos polish unconverged after "
                    f"{out['niter']} matvecs: E0={out['E0']:.12f}, "
                    f"residual {out['residual']:.3e} >= gate {r_gate:.3e} "
                    f"(checkpoint retained; re-run to resume)")
                err.E0 = out["E0"]
                err.residual = out["residual"]
                raise err
            return [out["E0"]], [out["vector"]]
        return eigs_smallest(fs, fs.N, nev=nev, ncv=ncv, maxit=maxit,
                             seed=seed, complex_vec=complex_vec,
                             mask=fs.mask, ckpt_key=ckpt_key, v0=v0)

    # ------------------------------------------------- stage checkpointing

    def _ckpt_stage_load(self, key, complex_h):
        """Load a completed solve stage (cf. ckpt_lczsE0_init,
        src/model.cc:2521-2749); None if absent/invalid."""
        from quantum_basis_tpu.utils.ckpt import active_store

        store = active_store()
        if store is None:
            return None
        rec = store.load(key)
        if rec is None:
            return None
        import jax.numpy as jnp

        nev = int(rec["nev"])
        evals = [float(x) for x in rec["evals"]]
        vecs = []
        for i in range(nev):
            vr = jnp.asarray(rec[f"v{i}_re"])
            vi = jnp.asarray(rec[f"v{i}_im"]) if complex_h else None
            vecs.append((vr, vi))
        return evals, vecs

    def _ckpt_stage_save(self, key, evals, vecs):
        from quantum_basis_tpu.utils.ckpt import active_store

        store = active_store()
        if store is None:
            return
        payload = {"nev": len(vecs), "evals": np.asarray(evals)}
        for i, (vr, vi) in enumerate(vecs):
            payload[f"v{i}_re"] = np.asarray(vr)
            payload[f"v{i}_im"] = np.asarray(vi) if vi is not None else np.zeros(1)
        store.save(key, payload)

    def locate_E0_iram(self, which: str = "full", nev: int = 2, ncv: int = 6,
                       maxit: int = 1000, sec: int = 0, seed: int = 1):
        """Several lowest eigenpairs via thick-restart Lanczos (ARPACK repl.)."""
        from quantum_basis_tpu.solvers.restarted import eigs_smallest

        if which == "vrnl":
            return self._locate_E0_vrnl(nev, max(ncv, nev), maxit, sec, seed)
        sector = self.sec_full[sec] if which == "full" else self.sec_repr[sec]
        if sector.dim <= _DENSE_CUTOFF and which == "full":
            complex_h = sector.matvec.is_complex
            evals, vecs = self._dense_solve(sector, nev, complex_h)
            self.eigenvals_full = evals
            self.eigenvecs_full = vecs
            sector.evals, sector.evecs = evals, vecs
            self._e0_sec = sec
            return
        fs = self._fullspace_op(sector) if which == "full" else None
        if fs is not None:
            evals, vecs_full = eigs_smallest(
                fs, fs.N, nev=nev, ncv=ncv, maxit=maxit, seed=seed,
                complex_vec=fs.is_complex or sector.matvec.is_complex,
                mask=fs.mask)
            vecs = [fs.to_sector(v) for v in vecs_full]
        else:
            mv = self._repr_ell(sector) if which == "repr" else sector.matvec
            evals, vecs = eigs_smallest(mv, sector.dim, nev=nev,
                                        ncv=ncv, maxit=maxit, seed=seed,
                                        complex_vec=mv.is_complex)
        sector.evals, sector.evecs = list(evals), list(vecs)
        if which == "full":
            self.eigenvals_full = evals
            self.eigenvecs_full = vecs
            self._e0_sec = sec
        else:
            self.eigenvals_repr = evals
            self.eigenvecs_repr = vecs

    def locate_Emax_iram(self, which: str = "full", nev: int = 2, ncv: int = 8,
                         maxit: int = 1000, sec: int = 0, seed: int = 1):
        """Largest eigenpairs (cf. model::locate_Emax_iram,
        src/model.cc:1386-1421) via thick-restart Lanczos which='LA'."""
        from quantum_basis_tpu.solvers.restarted import eigs_smallest

        sector = self.sec_full[sec] if which == "full" else self.sec_repr[sec]
        complex_h = (sector.matvec.is_complex if which == "full" else True)
        mv = self._repr_ell(sector) if which == "repr" else sector.matvec
        evals, vecs = eigs_smallest(
            mv, sector.dim, nev=nev, ncv=max(ncv, 2 * nev + 4),
            maxit=maxit, seed=seed, complex_vec=complex_h, which="LA",
        )
        if which == "full":
            self.eigenvals_full = evals
            self.eigenvecs_full = vecs
        else:
            self.eigenvals_repr = evals
            self.eigenvecs_repr = vecs
        sector.evals, sector.evecs = list(evals), list(vecs)
        return evals

    def locate_Es(self, e_lo: float, e_hi: float, which: str = "full",
                  sec: int = 0, nev_max: int = 10, degree: int = 200,
                  maxit: int = 40, seed: int = 7):
        """Interior eigenpairs in [e_lo, e_hi] — the FEAST replacement
        (cf. model::locate_Es_feast, src/model.cc:1424-1466), via
        Chebyshev-filtered subspace iteration (all SpMVs, no factorization).
        """
        from quantum_basis_tpu.solvers.chebyshev import eigs_window

        sector = self.sec_full[sec] if which == "full" else self.sec_repr[sec]
        complex_h = (sector.matvec.is_complex if which == "full" else True)
        mv = self._repr_ell(sector) if which == "repr" else sector.matvec
        evals, vecs = eigs_window(
            mv, sector.dim, e_lo, e_hi, nev_max=nev_max,
            degree=degree, n_iter=maxit, seed=seed, complex_vec=complex_h,
        )
        if which == "full":
            self.eigenvals_full = evals
            self.eigenvecs_full = vecs
        else:
            self.eigenvals_repr = evals
            self.eigenvecs_repr = vecs
        sector.evals, sector.evecs = list(evals), list(vecs)
        return evals

    # ---------------------------------------------------------- measurement

    def measure_full_static(self, oprs, sec: int, which: int = 0) -> complex:
        """<phi| O_k ... O_1 |phi> (chained); cf. model::measure_full_static
        (src/model.cc:1663-1694). ``oprs`` is one Mopr or a list applied
        right-to-left.
        """
        sector = self.sec_full[sec]
        phi = sector.evecs[which] if sector.evecs else self.eigenvecs_full[which]
        if not isinstance(oprs, (list, tuple)):
            oprs = [oprs]
        y = phi
        for op in reversed(list(oprs)):
            y = mopr_x_vec(self.compile_op(op), sector.dbasis, sector.dbasis, y)
        re, im = cx.vdot(phi, y)
        return complex(float(re), 0.0 if im is None else float(im))

    def measure_full_dynamic(self, A, sec_old: int, sec_new: int, m_steps: int,
                             which: int = 0, ckpt_key=None):
        """Continued-fraction data for G_A(z) = <phi|A† (z-H)^{-1} A|phi>.

        Returns (norm, alphas, betas): |v> = A|phi>, norm = ||v||, then a
        fixed-step Lanczos on the target sector records a/b
        (cf. model::measure_full_dynamic, src/model.cc:1696-1712).
        """
        src = self.sec_full[sec_old]
        dst = self.sec_full[sec_new]
        phi = src.evecs[which] if src.evecs else self.eigenvecs_full[which]
        v = mopr_x_vec(self.compile_op(A), src.dbasis, dst.dbasis, phi)
        nrm = float(cx.norm(v))
        if nrm < 1e-12:  # A|phi> vanishes (reference: src/model.cc:1704-1706)
            return 0.0, np.zeros(0), np.zeros(0)
        v = cx.scale(v, 1.0 / nrm)
        alphas, betas = lanczos_dynamics(dst.matvec, v, m_steps,
                                         ckpt_key=ckpt_key)
        return nrm, alphas, betas

    def measure_full_dynamic_kpm(self, A, sec_old: int, sec_new: int,
                                 n_moments: int, which: int = 0, bounds=None):
        """Operator-resolved KPM data for the dynamical structure factor.

        |v> = A|phi>, norm = ||v||, then Chebyshev moments
        mu_m = <v| T_m(Hs) |v> / norm^2 on the TARGET sector's H — the KPM
        counterpart of :meth:`measure_full_dynamic` (the reference has no
        KPM dynamics; its src/kpm.cc:45-99 stops at spectral bounds).
        Returns (norm, mu, e_min, e_max); reconstruct with
        :func:`quantum_basis_tpu.postprocess.sqw_kpm`.
        """
        from quantum_basis_tpu.solvers.chebyshev import kpm_moments

        src = self.sec_full[sec_old]
        dst = self.sec_full[sec_new]
        phi = src.evecs[which] if src.evecs else self.eigenvecs_full[which]
        v = mopr_x_vec(self.compile_op(A), src.dbasis, dst.dbasis, phi)
        nrm = float(cx.norm(v))
        if nrm < 1e-12:
            return 0.0, np.zeros(0), 0.0, 0.0
        mu, e_min, e_max = kpm_moments(dst.matvec, v, n_moments,
                                       bounds=bounds)
        return nrm, mu, e_min, e_max

    def measure_repr_dynamic_kpm(self, A, sec_old: int, sec_new: int,
                                 n_moments: int, which: int = 0, bounds=None):
        """KPM moments of A|phi> in momentum sectors (repr counterpart of
        :meth:`measure_full_dynamic_kpm`; cf. model::measure_repr_dynamic,
        src/model.cc:1896-1912, which only records continued fractions)."""
        from quantum_basis_tpu.ops.apply_repr import mopr_x_vec_repr
        from quantum_basis_tpu.solvers.chebyshev import kpm_moments

        src = self.sec_repr[sec_old]
        dst = self.sec_repr[sec_new]
        phi = src.evecs[which] if src.evecs else self.eigenvecs_repr[which]
        v = mopr_x_vec_repr(self.compile_op(self._coerce_mopr(A)),
                            src.dbasis, dst.dbasis, phi)
        nrm = float(cx.norm(v))
        if nrm < 1e-12:
            return 0.0, np.zeros(0), 0.0, 0.0
        v = cx.scale(v, 1.0 / nrm)
        # fast path: run the Chebyshev recurrence on the projected
        # full-space engine (the flagship momentum machinery) instead of
        # the sector-dimension ELL — same moments (the repr basis embeds
        # isometrically in the full space; dual-path-tested). Size-gated
        # BEFORE building: fs.N is the label-space size, known without
        # constructing the template (projector params and QN masks are
        # waste on the fallback path).
        from quantum_basis_tpu import config as _cfg

        import jax.numpy as jnp

        fs = None
        if self.space.label_space <= _cfg.kpm_fullspace_max_N:
            fs = self._fullspace_repr_op(dst)
        if fs is not None:
            vf = self._repr_to_full(dst, v)
            dt = getattr(fs, "dtype", jnp.float64)
            vf = (vf[0].astype(dt),
                  vf[1].astype(dt) if vf[1] is not None else None)
            mu, e_min, e_max = kpm_moments(fs, vf, n_moments,
                                           bounds=bounds,
                                           chunk=_cfg.kpm_fullspace_chunk)
        else:
            mu, e_min, e_max = kpm_moments(self._repr_ell(dst), v,
                                           n_moments, bounds=bounds)
        return nrm, np.asarray(mu, dtype=np.float64), e_min, e_max

    def _repr_to_full(self, sector, c):
        """Expand repr coefficients to the full label space:
        |psi> = sum_r c_r |r,k> with |r,k> = P_k|r>/sqrt(nu_r), built as
        P_k applied to the seed vector (c_r/sqrt(nu_r)) at the
        representative labels (the inverse of ReprBasis.from_full)."""
        import jax.numpy as jnp

        rb = sector.dbasis
        fs = self._fullspace_repr_op(sector)
        N = fs.N
        w = 1.0 / np.sqrt(rb.nus)
        seed_re = np.zeros(N)
        seed_re[rb.labels_np] = np.asarray(c[0]) * w
        seed_im = np.zeros(N)
        if c[1] is not None:
            seed_im[rb.labels_np] = np.asarray(c[1]) * w
        re, im = fs.project_host(seed_re, seed_im)
        vf = (jnp.asarray(re), jnp.asarray(im) if im is not None else None)
        return cx.scale(vf, 1.0 / float(cx.norm(vf)))

    def transform_vec_full(self, plan, sec: int, x):
        """y = U(plan) x with U|i> = sgn |plan(i)> — permutation action on a
        sector vector incl. fermion parity (cf. model::transform_vec_full,
        src/model.cc:1550-1600). ``x`` numpy (complex ok); the transformed
        state must stay in the sector."""
        s = self.sec_full[sec]
        x = np.asarray(x)
        new_labels, parity = self.space.transform(s.labels, np.asarray(plan))
        j = np.searchsorted(s.labels, new_labels)
        j = np.clip(j, 0, max(s.dim - 1, 0))
        if not np.all(s.labels[j] == new_labels):
            raise ValueError("plan maps some states out of the sector")
        sign = 1.0 - 2.0 * parity.astype(np.float64)
        y = np.zeros(s.dim, dtype=np.promote_types(x.dtype, np.float64))
        y[j] = sign * x
        return y

    def projectQ_full(self, momentum, sec: int, x, check: bool = True):
        """P_k x with P_k = (1/G) sum_R e^{+2 pi i k.R} T(R) — the momentum
        projector in the full basis (cf. model::projectQ_full,
        src/model.cc:1602-1660, incl. its momentum-eigenvector self-check).
        ``momentum`` is integer per pbc dimension; returns complex numpy.
        """
        s = self.sec_full[sec]
        x = np.asarray(x, dtype=np.complex128)
        disps, plans = self.lattice.translation_group()
        m = np.asarray(momentum, dtype=np.float64)
        L = np.asarray(self.lattice.L, dtype=np.float64)
        kfrac = np.zeros(self.lattice.dim)
        kfrac[: m.size] = m / L[: m.size]
        y = np.zeros(s.dim, dtype=np.complex128)
        for disp, plan in zip(disps, plans):
            phase = np.exp(2j * np.pi * float(np.dot(kfrac, disp)))
            y += phase * self.transform_vec_full(plan, sec, x)
        y /= len(plans)
        if check and np.linalg.norm(y) > 1e-12:
            # verify momentum eigenvector under each unit translation
            # (reference self-check, src/model.cc:1634-1650)
            for d in range(self.lattice.dim):
                if self.lattice.bc[d] != "pbc":
                    continue
                e = np.zeros(self.lattice.dim, dtype=np.int64)
                e[d] = 1
                ty = self.transform_vec_full(
                    self.lattice.translation_plan(e), sec, y)
                want = np.exp(-2j * np.pi * kfrac[d]) * y
                err = np.linalg.norm(ty - want) / np.linalg.norm(y)
                assert err < 1e-9, f"projectQ: not a k-eigenvector (d={d}, {err:.2e})"
        return y

    # ------------------------------------------------------ momentum sectors

    @property
    def tset(self):
        """TranslationSet over the pbc dimensions of the lattice."""
        if self._tset is None:
            from quantum_basis_tpu.basis.translation import TranslationSet

            self._tset = TranslationSet(self.space, self.lattice)
        return self._tset

    def enumerate_basis_repr(self, momentum, conserve_lst=None, val_lst=None,
                             sec: int = 0, method: str = "direct"):
        """Momentum-sector basis of representatives; build device residency.

        cf. model::enumerate_basis_repr (src/model.cc:274-487). Two paths,
        mirroring the reference's two algorithms:

        - ``method="direct"``: device-side orbit classification over the
          materialized quantum-number sector (the reference's dual-check
          path made primary — SURVEY §7 step 8);
        - ``method="dnc"``: sublattice divide-and-conquer streaming (the
          Weisse-table equivalent, O(sqrt(label_space)) host memory;
          basis/weisse.py). Identical output, for sectors too large to
          materialize.
        """
        from quantum_basis_tpu.basis.translation import enumerate_reps
        from quantum_basis_tpu.ops.apply_repr import MatvecRepr, ReprBasis

        def mopr_key(m):
            return tuple(sorted(
                ((complex(np.round(t.coeff, 12)), t._key()) for t in m.terms),
                key=repr,
            ))

        key = (tuple(mopr_key(m) for m in (conserve_lst or [])),
               tuple(float(v) for v in (val_lst or [])), method)
        if self._repr_cache is None or self._repr_cache[0] != key:
            if method == "dnc":
                if self.mesh is not None:
                    # distribute the streamed tiles over the mesh; merge
                    # with the distributed sample sort (SURVEY §5.8)
                    from quantum_basis_tpu.parallel import (
                        enumerate_reps_dnc_sharded)

                    reps = enumerate_reps_dnc_sharded(
                        self.tset, conserve_lst, val_lst, self.mesh)
                else:
                    from quantum_basis_tpu.basis.weisse import (
                        enumerate_reps_dnc)

                    reps = enumerate_reps_dnc(self.tset, conserve_lst,
                                              val_lst)
                labels = reps  # full sector never materialized
            else:
                labels = enumerate_basis(self.space, conserve_lst, val_lst)
                reps = enumerate_reps(self.tset, labels)
            self._repr_cache = (key, labels, reps)
        _, labels, reps = self._repr_cache
        self._repr_conserve = (list(conserve_lst or []), list(val_lst or []))

        s = Sector()
        rbasis = ReprBasis(self.space, self.tset, labels, momentum,
                           reps_all=reps,
                           work_per_row=max(self.compiled_Ham.nnz_per_row, 1))
        s.labels = rbasis.labels_np
        s.dim = rbasis.n
        s.dbasis = rbasis
        s.matvec = MatvecRepr(self.compiled_Ham, rbasis)
        s.momentum = rbasis.momentum
        self.sec_repr[sec] = s
        return s.dim

    def dim_repr(self, sec: int = 0) -> int:
        return self.sec_repr[sec].dim

    def set_mesh(self, mesh):
        """Attach/replace the device mesh; clears per-sector sharded
        engines so the next solve rebuilds them on the new mesh."""
        self.mesh = mesh
        for s in list(self.sec_full.values()) + list(self.sec_repr.values()):
            if hasattr(s, "_mesh_mv"):
                del s._mesh_mv

    def _mesh_engine(self, sector, which: str):
        """Auto-router for the multi-device engines (SURVEY §2.2/§5.8).

        Builds the explicit ELL once (the reference likewise builds CSR
        once and reuses it per MultMv, src/sparse.cc:113-328), constructs
        the halo all-to-all engine, and keeps it when its per-apply
        exchange volume beats the all-gather strategy
        (``halo_stats()["traffic_ratio"] < 1``); otherwise falls back to
        the gather-kernel :class:`MatvecSharded` (full sectors; repr
        sectors always use the ELL halo engine — there is no repr gather
        kernel variant). Returns (matvec, row-validity mask of n_pad).
        """
        cached = getattr(sector, "_mesh_mv", None)
        if cached is not None and cached[0] is self.mesh:
            return cached[1], cached[2]
        from quantum_basis_tpu.ops.sparse import build_sparse_full
        from quantum_basis_tpu.parallel import EllShardedHalo, MatvecSharded

        if which == "repr":
            ell = self._repr_ell(sector)
        else:
            if getattr(sector, "_ell", None) is None:
                sector._ell = build_sparse_full(sector.matvec)
            ell = sector._ell
        mv = EllShardedHalo(ell, self.mesh)
        stats = mv.halo_stats()
        if which != "repr" and stats["traffic_ratio"] >= 1.0:
            # halo exchange would move more than replicating the vector:
            # matrix-free all-gather engine wins (and drops the ELL copy)
            mv = MatvecSharded(self.compiled_Ham, sector.dbasis, self.mesh)
        row_mask = np.zeros(mv.n_pad)
        row_mask[: sector.dim] = 1.0
        sector._mesh_mv = (self.mesh, mv, row_mask)
        return mv, row_mask

    def _locate_E0_mesh(self, sector, which: str, nev, ncv, maxit, sec,
                        seed):
        """Sector solve over the attached device mesh (public-API route —
        no hand drivers): thick-restart Lanczos on the sharded engine,
        reductions psum'd by GSPMD, fingerprinted stage checkpointing."""
        from quantum_basis_tpu.solvers.restarted import eigs_smallest

        complex_h = (getattr(sector.matvec, "is_complex", False)
                     or which == "repr")
        kstr = "_".join(str(x) for x in np.atleast_1d(
            sector.momentum).tolist()) if sector.momentum is not None else ""
        ndev = int(np.prod(list(self.mesh.shape.values())))
        key = (f"lczsE0_{which}_sec{sec}_K{kstr}_nev{nev}_mesh{ndev}"
               f"_h{self._ham_fingerprint():08x}")
        done = self._ckpt_stage_load(key, complex_h)
        if done is None:
            mv, row_mask = self._mesh_engine(sector, which)
            evals, vecs_p = eigs_smallest(
                mv, mv.n_pad, nev=nev, ncv=max(12, 2 * nev + 6),
                maxit=maxit, seed=seed, complex_vec=complex_h,
                mask=row_mask, ckpt_key=key + "_krylov")
            import jax.numpy as jnp

            vecs = []
            for v in vecs_p:
                re, im = mv.unpad(v)
                vecs.append((jnp.asarray(re),
                             jnp.asarray(im) if im is not None else None))
            self._ckpt_stage_save(key, evals, vecs)
        else:
            evals, vecs = done
        if which == "repr":
            self.eigenvals_repr = evals[:nev]
            self.eigenvecs_repr = vecs[:max(ncv, 1)]
        else:
            self.eigenvals_full = evals[:nev]
            self.eigenvecs_full = vecs[:max(ncv, 1)]
            self._e0_sec = sec
        sector.evals, sector.evecs = list(evals), list(vecs)

    def _repr_ell(self, sector):
        """Explicit-sparse f64 engine for momentum sectors off the projected
        full-space path: the gather ELL, extracted once and cached (one
        extraction pass replaces per-iteration orbit scans)."""
        from quantum_basis_tpu.ops.apply_repr import MatvecRepr
        from quantum_basis_tpu.ops.sparse import EllMatrix, build_sparse_repr

        if isinstance(sector.matvec, EllMatrix):
            return sector.matvec
        if getattr(sector, "_ell", None) is None:
            mv = sector.matvec
            if not isinstance(mv, MatvecRepr):
                mv = MatvecRepr(self.compiled_Ham, sector.dbasis)
            sector._ell = build_sparse_repr(mv)
        return sector._ell

    def _dense_solve_repr(self, sector, nev: int):
        """Small momentum sectors: materialize H_k from the one-pass ELL
        extraction (the old unit-vector probing cost n full applies)."""
        import jax.numpy as jnp

        n = sector.dim
        ell = self._repr_ell(sector)
        H = np.zeros((n, n), dtype=np.complex128)
        rows = np.repeat(np.arange(n), ell.width) if ell.width else np.empty(0, int)
        cols = np.asarray(ell.cols).reshape(-1)
        vals = (np.asarray(ell.vre)
                + 1j * (np.asarray(ell.vim) if ell.vim is not None else 0.0)
                ).reshape(-1)
        np.add.at(H, (rows, cols), vals)
        H[np.arange(n), np.arange(n)] += np.asarray(ell.diag)
        herm_err = np.max(np.abs(H - H.conj().T))
        assert herm_err < 1e-9, f"H_k not Hermitian: {herm_err}"
        evals, evecs = np.linalg.eigh(H)
        vecs = [(jnp.asarray(evecs[:, i].real.copy()),
                 jnp.asarray(evecs[:, i].imag.copy()))
                for i in range(min(nev, n))]
        return evals[:nev].tolist(), vecs

    def symmetrize_op(self, op):
        """Translation-symmetrize: O_t = (1/G) sum_R T(R) O T(-R).

        cf. measure_repr_static's internal symmetrization
        (src/model.cc:1859-1893) — done here in the host symbolic algebra
        via Mopr.transform over all translation plans.
        """
        op = self._coerce_mopr(op)
        disps, plans = self.lattice.translation_group()
        out = Mopr()
        for plan in plans:
            out += op.transform(plan)
        return (1.0 / len(plans)) * out

    @staticmethod
    def _coerce_mopr(op):
        if isinstance(op, Opr):
            return Mopr([OprProd(1.0, [op])])
        if isinstance(op, OprProd):
            return Mopr([op])
        return op

    def measure_repr_static(self, op, sec: int, which: int = 0) -> complex:
        """<phi_k| O |phi_k> in a momentum sector.

        cf. model::measure_repr_static (src/model.cc:1859-1893): the
        operator is translation-symmetrized (P_k O P_k = P_k O_t P_k, and
        O_t commutes with translations so the repr matvec machinery
        applies), then split into Hermitian and anti-Hermitian parts so the
        Hermitian row-gather kernel can evaluate both.
        """
        from quantum_basis_tpu.ops.apply_repr import MatvecRepr

        sector = self.sec_repr[sec]
        phi = sector.evecs[which] if sector.evecs else self.eigenvecs_repr[which]
        Ot = self.symmetrize_op(op)
        Oh = 0.5 * (Ot + Ot.dagger())
        Oa = (-0.5j) * (Ot - Ot.dagger())
        out = 0.0 + 0.0j
        cache = getattr(self, "_repr_meas_cache", None)
        if cache is None:
            cache = self._repr_meas_cache = {}
        for part, factor in ((Oh, 1.0), (Oa, 1.0j)):
            if part.q_zero():
                continue
            from quantum_basis_tpu.ops.compile import operator_fingerprint

            comp = compile_operator(part, self.space)
            # cache the device-resident MatvecRepr per (sector, operator):
            # a correlator sweep re-measures the same O at many distances —
            # rebuilding the matvec re-paid table upload + jit every call
            # sector.serial pins the key to THIS enumeration: same (sec,
            # momentum, dim) after a re-enumeration with different quantum
            # numbers must not reuse a matvec bound to the stale dbasis
            ck = (sector.serial, sec,
                  tuple(np.atleast_1d(sector.momentum).tolist()),
                  sector.dim, operator_fingerprint(comp))
            mv = cache.get(ck)
            if mv is None:
                if len(cache) > 64:
                    cache.clear()
                mv = cache[ck] = MatvecRepr(comp, sector.dbasis)
            y = mv(phi)
            re, im = cx.vdot(phi, y)
            val = float(re)  # Hermitian part: expectation is real
            out = out + factor * val
        return complex(out)

    def measure_repr_dynamic(self, A, sec_old: int, sec_new: int, m_steps: int,
                             which: int = 0, ckpt_key=None):
        """Continued-fraction data across momentum sectors.

        |v> = A |phi_{k}> lands in sector ``sec_new`` (momentum k - q for
        A = sum_x e^{-iq.x} O_x); returns (norm, alphas, betas)
        (cf. model::measure_repr_dynamic, src/model.cc:1896-1912).
        """
        from quantum_basis_tpu.ops.apply_repr import mopr_x_vec_repr

        src = self.sec_repr[sec_old]
        dst = self.sec_repr[sec_new]
        phi = src.evecs[which] if src.evecs else self.eigenvecs_repr[which]
        v = mopr_x_vec_repr(self.compile_op(self._coerce_mopr(A)),
                            src.dbasis, dst.dbasis, phi)
        nrm = float(cx.norm(v))
        v = cx.scale(v, 1.0 / nrm)
        alphas, betas = lanczos_dynamics(dst.matvec, v, m_steps,
                                         ckpt_key=ckpt_key)
        return nrm, alphas, betas

    # ----------------------------------------------- variational (vrnl) sector

    @property
    def center_translator(self):
        """Batched translate-to-center canonicalizer (built lazily)."""
        if self._ct is None:
            from quantum_basis_tpu.basis.vrnl import CenterTranslator

            self._ct = CenterTranslator(self.space, self.lattice)
        return self._ct

    def add_Ham_vrnl(self, op):
        """Accumulate a term into the vrnl basis *generator* (cf.
        model::add_Ham_vrnl, src/qbasis.h:1367-1371 — used only to grow
        Trugman's variational basis, not as the matrix)."""
        self.Ham_vrnl += self._coerce_mopr(op)

    def build_basis_vrnl(self, initial_labels, gs_label: int, momentum_gs,
                         momentum, depth: int, conserve_lst=None,
                         val_lst=None, sec: int = 0):
        """Grow Trugman's variational basis from seed states.

        cf. model::build_basis_vrnl (src/model.cc:489-616). ``initial_labels``
        are integer state labels (the integer encoding of the reference's
        ``mbasis_elem`` list); ``momentum_gs`` / ``momentum`` are fractional
        wave vectors per unit cell (phase convention exp(2*pi*i k.disp), see
        quantum_basis_tpu.basis.vrnl docstring).
        """
        from quantum_basis_tpu.basis.vrnl import VrnlSector, grow_basis_vrnl

        ct = self.center_translator
        gen = compile_operator(self.Ham_vrnl if not self.Ham_vrnl.q_zero()
                               else self.Ham, self.space)
        gs_canon, _, _ = ct.canonicalize(np.asarray([gs_label], dtype=np.int64))
        gs_canon = int(gs_canon[0])
        labels = grow_basis_vrnl(gen, ct, initial_labels, depth,
                                 conserve_lst, val_lst)
        labels = labels[labels != gs_canon]  # basis.remove(gs), model.cc:570

        s = VrnlSector()
        s.labels = labels
        s.dim = int(labels.size)
        s.momentum = np.asarray(momentum, dtype=np.float64)
        s.gs_label = gs_canon
        s.gs_momentum = np.asarray(momentum_gs, dtype=np.float64)
        s.gs_omega = ct.omega_g(gs_canon)
        # gs only participates at its own momentum (src/model.cc:601-612)
        dk = np.mod(s.momentum - s.gs_momentum + 1e-10, 1.0)
        dk = np.minimum(dk, 1.0 - dk)
        s.gs_norm = float(s.gs_omega) if np.linalg.norm(dk) < 1e-8 else 0.0
        self.sec_vrnl[sec] = s
        return s.dim

    def generate_Ham_sparse_vrnl(self, sec: int = 0):
        """Build the vrnl-sector matrix skeleton + device matvec at the
        sector momentum; also computes the variational GS energy
        (cf. generate_Ham_sparse_vrnl, src/model.cc:838-924)."""
        from quantum_basis_tpu.basis.vrnl import VrnlMatrix
        from quantum_basis_tpu.ops.apply_vrnl import MatvecVrnl, _images_canon

        import jax.numpy as jnp

        ct = self.center_translator
        s = self.sec_vrnl[sec]
        key = (s.labels.tobytes(), id(self.compiled_Ham))
        if self._vrnl_skel is None or self._vrnl_skel[0] != key:
            self._vrnl_skel = (key, VrnlMatrix(self.compiled_Ham, ct, s.labels))
        s.vmat = self._vrnl_skel[1]
        s.matvec = MatvecVrnl(s.vmat, s.momentum)

        # variational ground-state energy (src/model.cc:865-888)
        if s.gs_E0 is None:
            gs = np.asarray([s.gs_label], dtype=np.int64)
            e0 = 0.0
            if not self.compiled_Ham.diag_terms.q_zero():
                from quantum_basis_tpu.ops.compile import compile_diagonal

                ev = compile_diagonal(self.compiled_Ham.diag_terms, self.space)
                e0 += float(np.asarray(ev(self.space.decode(gs)))[0])
            cells = self.lattice.Nsites / self.lattice.num_sub
            for amp, canon, disp in _images_canon(self.compiled_Ham, ct,
                                                  jnp.asarray(gs)):
                hit = canon[0] == s.gs_label
                if not np.any(hit):
                    continue
                ang = 2.0 * np.pi * (disp[0] @ s.gs_momentum)
                coeff = (float(s.gs_omega) / cells) * amp[0] * np.exp(1j * ang)
                e0 += float(np.sum(np.where(hit, coeff, 0.0)).real)
            s.gs_E0 = e0
        return s.matvec

    def dim_vrnl(self, sec: int = 0) -> int:
        return self.sec_vrnl[sec].dim

    def _locate_E0_vrnl(self, nev, ncv, maxit, sec, seed):
        s = self.sec_vrnl[sec]
        if s.matvec is None:
            self.generate_Ham_sparse_vrnl(sec)
        if s.dim <= _DENSE_CUTOFF:
            import jax.numpy as jnp

            H = s.vmat.at_momentum(s.momentum)
            evals, evecs = np.linalg.eigh(H)
            vecs = [(jnp.asarray(evecs[:, i].real.copy()),
                     jnp.asarray(evecs[:, i].imag.copy()))
                    for i in range(min(max(nev, ncv, 1), s.dim))]
            evals = evals[: max(nev, 1)].tolist()
        else:
            from quantum_basis_tpu.solvers.restarted import eigs_smallest

            evals, vecs = eigs_smallest(
                s.matvec, s.dim, nev=nev, ncv=max(12, 2 * nev + 6),
                maxit=maxit, seed=seed, complex_vec=True)
        self.eigenvals_vrnl = list(evals)
        self.eigenvecs_vrnl = vecs
        s.evals, s.evecs = list(evals), list(vecs)

    def moprXgs_vrnl(self, Bq, sec: int = 0) -> np.ndarray:
        """B_q |gs> expressed over the vrnl basis (cf. src/model.cc:1915-1984)."""
        from quantum_basis_tpu.ops.apply_vrnl import mopr_x_gs_vrnl

        return mopr_x_gs_vrnl(self._coerce_mopr(Bq), self.sec_vrnl[sec],
                              self.center_translator)

    def moprXvec_vrnl(self, Bq, sec_old: int, sec_new: int, x):
        """(y, pG): B_q applied to a vrnl-sector vector (src/model.cc:1987-2074)."""
        from quantum_basis_tpu.ops.apply_vrnl import mopr_x_vec_vrnl

        return mopr_x_vec_vrnl(self._coerce_mopr(Bq), self.sec_vrnl[sec_old],
                               self.sec_vrnl[sec_new], self.center_translator, x)

    def measure_vrnl_static(self, lhs, sec: int = 0, which: int = 0) -> complex:
        """<phi|lhs|phi> over a vrnl eigenvector (src/model.cc:2077-2129)."""
        from quantum_basis_tpu.ops.apply_vrnl import measure_vrnl_static

        s = self.sec_vrnl[sec]
        vr, vi = s.evecs[which]
        phi = np.asarray(vr) + 1j * (np.asarray(vi) if vi is not None else 0.0)
        return measure_vrnl_static(self._coerce_mopr(lhs), s,
                                   self.center_translator, phi)

    def measure_vrnl_dynamic(self, Bq, sec: int, m_steps: int):
        """Continued-fraction data for the vrnl sector: |v> = B_q|gs>,
        returns (norm, alphas, betas) (cf. src/model.cc:2131-2143)."""
        import jax.numpy as jnp

        s = self.sec_vrnl[sec]
        if s.matvec is None:
            self.generate_Ham_sparse_vrnl(sec)
        v = self.moprXgs_vrnl(Bq, sec)
        nrm = float(np.linalg.norm(v))
        if nrm < 1e-12:
            return 0.0, np.zeros(0), np.zeros(0)
        v = v / nrm
        cvec = (jnp.asarray(v.real.copy()), jnp.asarray(v.imag.copy()))
        alphas, betas = lanczos_dynamics(s.matvec, cvec, m_steps)
        return nrm, alphas, betas

    def wannier_mat_vrnl(self, Ar_list, momenta_list, locate_state,
                         sec: int = 0, nev: int = 8):
        """mu[k1, k2] = <phi(k1)| B_{k1-k2} |phi(k2)> over a k-grid.

        cf. model::WannierMat_vrnl (src/model.cc:2145-2310): per momentum the
        vrnl matrix is re-phased (O(nnz), no basis rebuild), diagonalized, a
        band state selected by ``locate_state(model, idx)``; then the overlap
        matrix with B_q built from ``Ar_list`` = [(r_i, A_{r_i}), ...] with
        Hermitian completion.  Eigen-solves are cached in-memory per momentum.
        """
        s = self.sec_vrnl[sec]
        if s.vmat is None:
            self.generate_Ham_sparse_vrnl(sec)
        momenta = [np.asarray(k, dtype=np.float64) for k in momenta_list]
        nk = len(momenta)

        band: list[np.ndarray] = []
        import jax.numpy as jnp

        from quantum_basis_tpu.utils.ckpt import active_store

        store = active_store()  # per-k eigenvector disk cache, matching the
        # reference's eigenvecs_[k].dat files (src/model.cc:2163-2187)

        # Content fingerprint of the vrnl Hamiltonian: without it a stale
        # out_Qckpt/ from a run with different couplings (same dim/sec/k)
        # would be silently trusted. The reference re-validates cached
        # eigenvector files too (src/model.cc:2163-2187).
        import zlib

        fp = 0
        for arr in (s.vmat.rows, s.vmat.cols, s.vmat.amp_re, s.vmat.amp_im,
                    s.vmat.disp, s.vmat.diag):
            fp = zlib.crc32(np.ascontiguousarray(arr).tobytes(), fp)

        base_momentum = s.momentum
        for idx, k in enumerate(momenta):
            ckey = ("wannier_vrnl_sec%d_dim%d_h%08x_k%s"
                    % (sec, s.dim, fp, "_".join(f"{v:+.6f}" for v in k)))
            rec = store.load(ckey) if store is not None else None
            if rec is not None and rec["evecs"].shape[0] == s.dim:
                evals, evecs = rec["evals"], rec["evecs"]
            else:
                H = s.vmat.at_momentum(k)
                evals, evecs = np.linalg.eigh(H)
                if store is not None:
                    store.save(ckey, {"evals": evals, "evecs": evecs})
            s.momentum = k
            s.evals = evals[:nev].tolist()
            s.evecs = [(jnp.asarray(evecs[:, i].real.copy()),
                        jnp.asarray(evecs[:, i].imag.copy()))
                       for i in range(min(nev, s.dim))]
            which = int(locate_state(self, idx))
            band.append(evecs[:, which].copy())
        mu = np.zeros((nk, nk), dtype=np.complex128)
        for i1 in range(nk):
            for i2 in range(i1, nk):
                q = momenta[i1] - momenta[i2]
                Bq = Mopr()
                for r, A in Ar_list:
                    phase = np.exp(2j * np.pi * float(np.dot(q, np.asarray(r))))
                    Bq += complex(phase) * self._coerce_mopr(A)
                s.momentum = momenta[i2]
                y, _ = self.moprXvec_vrnl(Bq, sec, sec, band[i2])
                mu[i1, i2] = np.vdot(band[i1], y)
                mu[i2, i1] = np.conj(mu[i1, i2])
        s.momentum = base_momentum
        return mu

    def _locate_E0_lanczos_repr(self, nev, ncv, maxit, sec, seed):
        sector = self.sec_repr[sec]
        if sector.dim <= _DENSE_CUTOFF:
            evals, vecs = self._dense_solve_repr(sector, max(nev, ncv, 1))
            self.eigenvals_repr = evals
            self.eigenvecs_repr = vecs[:max(ncv, 1)]
            sector.evals, sector.evecs = evals, vecs
            return
        if self.mesh is not None:
            return self._locate_E0_mesh(sector, "repr", nev, ncv, maxit,
                                        sec, seed)

        from quantum_basis_tpu.solvers.restarted import eigs_smallest

        kstr = "_".join(str(x) for x in getattr(sector, "momentum", ()))
        key = (f"lczsE0_repr_sec{sec}_K{kstr}_nev{nev}"
               f"_h{self._ham_fingerprint():08x}")
        done = self._ckpt_stage_load(key, True)
        if done is not None:
            evals, vecs = done
        else:
            from quantum_basis_tpu import config

            fs = self._fullspace_repr_op(sector)
            ncv_ = max(12, 2 * nev + 6)
            if fs is not None:
                # momentum-filtered full-space solve (the fast repr path,
                # ops/translate_fullspace.py) with optional f32 bulk stage
                import jax.numpy as jnp

                v0 = None
                fs32 = None
                if config.mixed_precision:
                    fs32 = self._fullspace_repr_op(sector, dtype=jnp.float32)
                    if fs32 is not None:
                        v0 = self._f32_stage_cached(
                            fs32, nev, ncv_, maxit, seed, fs32.is_complex,
                            key)
                evals, vecs_full = self._solve_fullspace(
                    fs, nev, ncv_, maxit, seed, fs.is_complex,
                    key + "_krylov", v0, fs32=fs32)
                vecs = [sector.dbasis.from_full(v) for v in vecs_full]
            else:
                evals, vecs = eigs_smallest(
                    self._repr_ell(sector), sector.dim, nev=nev, ncv=ncv_,
                    maxit=maxit, seed=seed, complex_vec=True,
                    ckpt_key=key + "_krylov",
                )
            self._ckpt_stage_save(key, evals, vecs)
        self.eigenvals_repr = evals[:nev]
        self.eigenvecs_repr = vecs[:max(ncv, 1)]
        sector.evals, sector.evecs = list(evals), list(vecs)
