"""Thick-restart Lanczos with full reorthogonalization — the ARPACK-NG
replacement (reference: src/lanczos.cc:393-603 ``iram``/``call_arpack``).

Design: a fixed-size device basis buffer V (ncv+1, N) in split-complex form;
each step performs CGS2 reorthogonalization (two matmuls V @ w and
V^T h), so the projected Rayleigh matrix is exact; at each restart the best
``keep`` Ritz vectors are compacted by one (keep, m) x (m, N) matmul and the
iteration continues thick-restarted [Wu & Simon, SIAM J. Matrix Anal. 22(2)].
Degenerate levels are resolved by roundoff injection across restarts exactly
as ARPACK does (the reference warns about degeneracy at
src/lanczos.cc:599-601; the golden t-J test requires finding a degenerate
pair, which this solver reproduces).

All device work is static-shaped: row counts are handled with 0/1 masks so
one jitted step/restart serves the whole run.
"""

from __future__ import annotations

import time

import numpy as np

from quantum_basis_tpu.ops import cplx as cx
from quantum_basis_tpu.utils.rng import vec_randomize

_BREAKDOWN = 1e-13
_SAVE_PERIOD = 60.0  # min seconds between restart-boundary ckpt writes


class _DeviceOps:
    """jitted masked basis-buffer operations for one (ncv, n, cplx) shape."""

    def __init__(self, matvec, n, ncv, complex_vec):
        import jax
        import jax.numpy as jnp

        from quantum_basis_tpu.solvers.lanczos import _mv_protocol

        self.ncv = ncv
        self.n = n
        self.cplx = complex_vec
        self.dtype = jnp.dtype(getattr(matvec, "dtype", jnp.float64))
        mv_apply, self.mv_params = _mv_protocol(matvec)

        # f32 buffers: force true-f32 dots (a reduced-precision default —
        # bf16 or TF32 inputs, ~1e-3 relative error — would destroy Krylov
        # orthogonality)
        prec = (jax.lax.Precision.HIGHEST
                if self.dtype == jnp.dtype(jnp.float32) else None)
        from quantum_basis_tpu import config
        f64 = (self.dtype == jnp.dtype(jnp.float64)
               and config.f64_reduce_dots)

        def mm(a, b):
            """a @ b — under ``config.f64_reduce_dots`` f64 goes through
            broadcast-multiply + reduce instead of dot_general (for a
            backend whose f64 dot_general is not exact, which would cap
            CGS2 orthogonality above the solver tolerance). For the
            (ncv+1, N) shapes here it is bandwidth-bound either way."""
            if not f64:
                return jnp.matmul(a, b, precision=prec)
            if a.ndim == 2 and b.ndim == 1:          # (rows, N) @ (N,)
                return jnp.sum(a * b[None, :], axis=1)
            if a.ndim == 1 and b.ndim == 2:          # (rows,) @ (rows, N)
                return jnp.sum(a[:, None] * b, axis=0)
            if a.ndim == 2 and b.ndim == 2:          # (keep, rows) @ (rows, N)
                # row-at-a-time: each row is one fused multiply+reduce; a
                # broadcast 3-d form would stage a (keep, rows, N) temp
                return jax.lax.map(
                    lambda row: jnp.sum(row[:, None] * b, axis=0), a)
            return jnp.matmul(a, b, precision=prec)

        def vv(a, b):
            """<a, b> with the same f64-safe lowering."""
            if f64:
                return jnp.sum(a * b)
            return jnp.vdot(a, b, precision=prec)

        def proj(Vre, Vim, wr, wi, mask):
            """h = V^dagger w (masked rows): returns (hr, hi).

            The row mask applies to the CONTRACTED result (length ncv+1),
            never to V: ``(V * mask[:, None]) @ w == (V @ w) * mask`` but
            the left form materializes masked (ncv+1, N) copies of the
            whole basis — four per CGS2 step, which XLA's while-loop remat
            stacked into a 14.5 GiB temp at N = 2^24 (OOM on a 16 GiB chip).
            """
            hr = mm(Vre, wr) * mask
            hi = None
            if self.cplx:
                hr = hr + mm(Vim, wi) * mask
                hi = (mm(Vre, wi) - mm(Vim, wr)) * mask
            return hr, hi

        def subtract(Vre, Vim, wr, wi, hr, hi, mask):
            """w -= V^T h (masked)."""
            hr = hr * mask
            wr = wr - mm(hr, Vre)
            if self.cplx:
                hi = hi * mask
                wr = wr + mm(hi, Vim)
                wi = wi - mm(hr, Vim) - mm(hi, Vre)
            return wr, wi

        def _row(V, j):
            """Row j of V via dynamic_slice — NOT a onehot matmul: the
            onehot outer-product row select/update materialized (ncv+1, N)
            broadcast temps per step, which XLA's while-loop remat turned
            into multi-GiB compressed/uncompressed buffer pairs at
            N = 2^24 (OOM on a 16 GiB chip)."""
            return jax.lax.dynamic_slice_in_dim(V, j, 1, 0)[0]

        def _set_row(V, j, v):
            return jax.lax.dynamic_update_slice_in_dim(V, v[None, :], j, 0)

        def step(Vre, Vim, j, params):
            """One Lanczos/Arnoldi step from row j: returns updated V, h, b.

            ``params`` carries the matvec's device arrays as jit ARGUMENTS
            (capturing them as constants triggers XLA constant folding over
            the whole x-independent index arithmetic — minutes of compile).
            """
            rows = Vre.shape[0]
            mask = (jnp.arange(rows) <= j).astype(self.dtype)
            vr = _row(Vre, j)
            vi = _row(Vim, j) if self.cplx else None
            # barrier: keep the row select out of the matvec fusion
            if self.cplx:
                vr, vi = jax.lax.optimization_barrier((vr, vi))
            else:
                vr = jax.lax.optimization_barrier(vr)
            yr, yi = mv_apply(params, (vr, vi))
            if self.cplx:
                yr, yi = jax.lax.optimization_barrier((yr, yi))
            else:
                yr = jax.lax.optimization_barrier(yr)
            h1r, h1i = proj(Vre, Vim, yr, yi, mask)
            yr, yi = subtract(Vre, Vim, yr, yi, h1r, h1i, mask)
            h2r, h2i = proj(Vre, Vim, yr, yi, mask)
            yr, yi = subtract(Vre, Vim, yr, yi, h2r, h2i, mask)
            hr = h1r + h2r
            hi = (h1i + h2i) if self.cplx else jnp.zeros_like(h1r)
            b = jnp.sqrt(vv(yr, yr)
                         + (vv(yi, yi) if self.cplx else 0.0))
            inv = jnp.where(b > _BREAKDOWN, 1.0 / jnp.maximum(b, _BREAKDOWN), 0.0)
            Vre = _set_row(Vre, j + 1, yr * inv)
            if self.cplx:
                Vim = _set_row(Vim, j + 1, yi * inv)
            return Vre, Vim, hr, hi, b

        def compact(Vre, Vim, Sre, Sim, m):
            """Thick restart: rows <- [S^T V ; v_m], S is (ncv+1, keep)."""
            vr = _row(Vre, m)
            vi = _row(Vim, m) if self.cplx else jnp.zeros_like(vr)
            Yre = mm(Sre.T, Vre)
            Yim = None
            if self.cplx:
                Yre = Yre - mm(Sim.T, Vim)
                Yim = mm(Sre.T, Vim) + mm(Sim.T, Vre)
            k = Sre.shape[1]
            newVre = jnp.zeros_like(Vre).at[:k].set(Yre).at[k].set(vr)
            newVim = None
            if self.cplx:
                newVim = jnp.zeros_like(Vim).at[:k].set(Yim).at[k].set(vi)
            return newVre, newVim

        def insert_random(Vre, Vim, rr, ri, j, row):
            """Orthogonalize a random vector against rows 0..j, put at row."""
            mask = (jnp.arange(Vre.shape[0]) <= j).astype(self.dtype)
            h1r, h1i = proj(Vre, Vim, rr, ri, mask)
            rr, ri = subtract(Vre, Vim, rr, ri, h1r, h1i, mask)
            h2r, h2i = proj(Vre, Vim, rr, ri, mask)
            rr, ri = subtract(Vre, Vim, rr, ri, h2r, h2i, mask)
            b = jnp.sqrt(vv(rr, rr)
                         + (vv(ri, ri) if self.cplx else 0.0))
            inv = 1.0 / jnp.maximum(b, _BREAKDOWN)
            Vre = _set_row(Vre, row, rr * inv)
            if self.cplx:
                Vim = _set_row(Vim, row, ri * inv)
            return Vre, Vim, b

        def expand(Vre, Vim, m0, params):
            """Fused inner loop: steps m0..ncv-1 in ONE device dispatch.

            Eliminates the per-step host sync (one projected-column
            np.asarray round-trip per step); the whole Hm block comes back
            in one transfer. Returns
            (Vre, Vim, Hr, Hi, bvec): Hr[:, j] (+ i Hi) is the CGS2
            projection column of step j, bvec[j] its beta. A breakdown
            (beta < 1e-11) zeroes the next vector so later columns are
            zeros; the host detects it from bvec and falls back to the
            stepwise path with random reinjection.
            """
            rows = ncv + 1
            Hr = jnp.zeros((rows, rows), self.dtype)
            Hi = jnp.zeros((rows, rows), self.dtype)
            bvec = jnp.zeros(rows, self.dtype)

            def body(j, carry):
                Vre, Vim, Hr, Hi, bvec = carry
                Vre, Vim, hr, hi, b = step(Vre, Vim, j, params)
                Hr = Hr.at[:, j].set(hr)
                Hi = Hi.at[:, j].set(hi)
                bvec = bvec.at[j].set(b.astype(self.dtype))
                return (Vre, Vim, Hr, Hi, bvec)

            return jax.lax.fori_loop(m0, ncv, body,
                                     (Vre, Vim, Hr, Hi, bvec))

        self.step = jax.jit(step, donate_argnums=(0, 1) if complex_vec else (0,))
        self.expand = jax.jit(expand, donate_argnums=(0, 1) if complex_vec else (0,))
        self.compact = jax.jit(compact)
        self.insert_random = jax.jit(insert_random)


from collections import OrderedDict

_DOPS_CACHE: OrderedDict = OrderedDict()
_DOPS_CACHE_MAX = 8  # each entry pins compiled executables (HBM + host)


def _device_ops(matvec, n, ncv, complex_vec):
    """_DeviceOps, shared across matvecs that declare a ``program_key``.

    A fresh ``jax.jit`` object recompiles an identical program from scratch
    (measured), so per-sector solver instances would re-pay the full XLA
    compile per momentum sector. Matvec views over a shared operator
    template (models/model.py::_SectorOpView) carry the template's
    ``program_key``; their traced structure is identical and the per-sector
    arrays travel through ``params``, so the jitted ops can be reused.

    LRU-bounded: entries pin compiled executables for their lifetime, so
    solving many models sequentially must not accumulate them forever.
    Eviction is safe because program_keys are monotonic (config.
    next_program_key) — an evicted key can never be reissued to a
    different operator.
    """
    pk = getattr(matvec, "program_key", None)
    if pk is None:
        return _DeviceOps(matvec, n, ncv, complex_vec)
    key = (pk, int(n), int(ncv), bool(complex_vec))
    ops = _DOPS_CACHE.get(key)
    if ops is None:
        ops = _DOPS_CACHE[key] = _DeviceOps(matvec, n, ncv, complex_vec)
        while len(_DOPS_CACHE) > _DOPS_CACHE_MAX:
            _DOPS_CACHE.popitem(last=False)
    else:
        _DOPS_CACHE.move_to_end(key)
    return ops


class DeflatedMatvec:
    """P H P + sigma (I - P) with P projecting out given eigenvectors.

    Spectrum = original spectrum minus the deflated copies, plus ``sigma``
    on the deflated span; ``sigma`` is chosen on the far side of the search
    window so deflated directions never contaminate the target eigenpairs
    (the moral equivalent of the reference's fake_pos diagonal,
    src/model.cc:723-727). Works with any solver via .apply/.params.
    """

    def __init__(self, base, vecs, sigma: float):
        from quantum_basis_tpu.solvers.lanczos import _mv_protocol

        self._base_apply, self._base_params = _mv_protocol(base)
        self.vecs = tuple((v[0], v[1]) for v in vecs)
        self.sigma = float(sigma)
        self.is_complex = getattr(base, "is_complex", False)
        self.dtype = getattr(base, "dtype", None)
        # forward sector projection so deflate-verify restarts stay in-sector
        ph = getattr(base, "project_host", None)
        if ph is not None:
            self.project_host = ph

    @property
    def params(self):
        return (self._base_params, self.vecs)

    def apply(self, params, x):
        base_params, vecs = params
        from quantum_basis_tpu.solvers.lanczos import _project_out

        px = _project_out(x, vecs)
        y = self._base_apply(base_params, px)
        py = _project_out(y, vecs)
        # + sigma * (x - px)
        d = cx.sub(x, px)
        return cx.add(py, cx.scale(d, self.sigma))

    def __call__(self, x):
        return self.apply(self.params, x)


def eigs_smallest(matvec, n, nev=2, ncv=12, maxit=1000, tol=1e-10, seed=1,
                  complex_vec=False, which="SA", deg_tol=1e-9, ckpt_key=None,
                  mask=None, v0=None, verify_degenerate=True):
    """nev smallest ('SA') or largest ('LA') eigenpairs of Hermitian matvec.

    Returns (eigenvalues list, eigenvectors list of split-complex cvecs).

    Degenerate multiplets: a single-vector Krylov space only sees one copy
    of each degenerate level (the reference's IRAM warns the same,
    src/lanczos.cc:599-601). After nominal convergence this runs a
    deflate-and-verify pass — project out the converged vectors, restart
    from a fresh random vector, and if a new value lands strictly inside
    the found window it is a missed copy: insert and verify again.
    ``verify_degenerate=False`` skips that pass — right when only a warm
    start is wanted (the mixed-precision f32 bulk stage), where the pass
    costs a second full solve + compile for nothing.
    """
    vals, vecs = _eigs_core(matvec, n, nev, ncv, maxit, tol, seed,
                            complex_vec, which, ckpt_key=ckpt_key, mask=mask,
                            v0=v0)
    sgn = 1.0 if which == "SA" else -1.0
    guard = 0
    while verify_degenerate and len(vals) >= nev and guard < 8:
        guard += 1
        spread = abs(vals[-1] - vals[0])
        sigma = (max(vals) + 10.0 + 3.0 * spread) if which == "SA" else \
                (min(vals) - 10.0 - 3.0 * spread)
        dmv = DeflatedMatvec(matvec, vecs, sigma)
        extra_vals, extra_vecs = _eigs_core(
            dmv, n, 1, max(8, ncv // 2), maxit, tol, seed + 1000 + guard,
            complex_vec, which, mask=mask,
        )
        if not extra_vals:
            break
        v_extra = extra_vals[0]
        # inside the found window (strictly better than the worst kept)?
        if sgn * v_extra < sgn * vals[-1] - deg_tol:
            merged = sorted(
                zip(vals + [v_extra], vecs + [extra_vecs[0]]),
                key=lambda p: sgn * p[0],
            )[:nev]
            vals = [p[0] for p in merged]
            vecs = [p[1] for p in merged]
        else:
            break
    return vals, vecs


def _solver_log(purpose, it, theta, resid):
    """Per-restart convergence line (reference: log_Lanczos_<purpose>.txt,
    src/lanczos.cc:102-128); enabled by config.solver_log_dir."""
    from quantum_basis_tpu import config

    if not config.solver_log_dir:
        return
    import os

    os.makedirs(config.solver_log_dir, exist_ok=True)
    path = os.path.join(config.solver_log_dir, f"log_{purpose}.txt")
    with open(path, "a") as f:
        th = " ".join(f"{t:.12f}" for t in theta)
        rs = " ".join(f"{r:.3e}" for r in resid)
        stamp = time.strftime("%H:%M:%S")
        f.write(f"{stamp} [{os.getpid()}] {it:8d}  theta: {th}  resid: {rs}\n")


def _eigs_core(matvec, n, nev=2, ncv=12, maxit=1000, tol=1e-10, seed=1,
               complex_vec=False, which="SA", ckpt_key=None, mask=None,
               v0=None):
    """Thick-restart Lanczos core (single starting vector).

    With ``ckpt_key`` set and checkpointing enabled (config.enable_ckpt),
    the full restart-boundary state (V basis, projected matrix, counters)
    is persisted after every thick restart and restored on re-entry —
    the reference's Lanczos-step-level checkpointing (src/ckpt.cc:13-340)
    at restart granularity.
    """
    import jax.numpy as jnp

    from quantum_basis_tpu.utils.ckpt import active_store

    ncv = int(min(max(ncv, nev + 2), n))
    rows = ncv + 1
    Hm = np.zeros((rows, rows), dtype=np.complex128)

    phost = getattr(matvec, "project_host", None)

    def _proj(re, im):
        """Project injected random vectors onto the sector support (used by
        the full-space engine, where out-of-sector noise must never enter
        the Krylov space). When the matvec carries a ``project_host`` (the
        momentum-sector full-space path), it subsumes the mask."""
        if phost is not None:
            re, im = phost(re, im)
        elif mask is not None:
            mnp = np.asarray(mask)
            re = re * mnp
            if im is not None:
                im = im * mnp
        else:
            return re, im
        nrm = np.sqrt(np.sum(re * re)
                      + (np.sum(im * im) if im is not None else 0.0))
        re = re / max(nrm, 1e-300)
        if im is not None:
            im = im / max(nrm, 1e-300)
        return re, im

    ops = _device_ops(matvec, n, ncv, complex_vec)
    from quantum_basis_tpu.solvers.lanczos import _mv_protocol
    mv_params = _mv_protocol(matvec)[1]  # THIS matvec's params (the cached
    # ops may have been built from a different sector's view)
    dt = ops.dtype
    if v0 is not None:
        # warm start (e.g. the f64 polish stage of a mixed-precision solve
        # resuming from the f32 stage's Ritz vector)
        re = np.asarray(v0[0], dtype=np.float64)
        im = (np.asarray(v0[1], dtype=np.float64) if complex_vec else None)
        if im is None and complex_vec:
            im = np.zeros_like(re)
        re, im = _proj(re, im)
        nrm = np.sqrt(np.sum(re * re)
                      + (np.sum(im * im) if im is not None else 0.0))
        re = re / max(nrm, 1e-300)
        if im is not None:
            im = im / max(nrm, 1e-300)
    else:
        re, im = _proj(*vec_randomize(n, seed=seed,
                                      complex_valued=complex_vec))
    Vre = jnp.zeros((rows, n), dt).at[0].set(jnp.asarray(re, dt))
    Vim = (jnp.zeros((rows, n), dt).at[0].set(jnp.asarray(im, dt))
           if complex_vec else None)
    m = 0           # index of current vector (column being generated)
    k_locked = 0    # thick-restart block size currently in Hm
    it = 0

    store = active_store() if ckpt_key else None
    if store is not None:
        rec = store.load(ckpt_key)
        if rec is not None and rec["Vre"].shape == (rows, n):
            Vre = jnp.asarray(rec["Vre"], dt)
            Vim = jnp.asarray(rec["Vim"], dt) if complex_vec else None
            Hm = rec["Hm"].astype(np.complex128)
            m = int(rec["m"])
            it = int(rec["it"])
    rng_seed = seed + 101
    last_save = 0.0  # monotonic time of the last restart-boundary save
    sort_sign = 1.0 if which == "SA" else -1.0

    def masks(m):
        mask = np.zeros(rows)
        mask[: m + 1] = 1.0
        onehot = np.zeros(rows)
        onehot[m] = 1.0
        return jnp.asarray(mask, dt), jnp.asarray(onehot, dt)

    while it < maxit:
        # expand Krylov space to ncv columns — ONE device dispatch for the
        # whole m..ncv block (ops.expand), one host sync per restart
        while m < ncv:
            if complex_vec:
                Vre, Vim, Hr_d, Hi_d, b_d = ops.expand(
                    Vre, Vim, np.int32(m), mv_params)
            else:
                Vre, _, Hr_d, Hi_d, b_d = ops.expand(
                    Vre, jnp.zeros((1, 1)), np.int32(m), mv_params)
            Hr = np.asarray(Hr_d, dtype=np.float64)
            Hi = (np.asarray(Hi_d, dtype=np.float64) if complex_vec
                  else np.zeros_like(Hr))
            bs = np.asarray(b_d, dtype=np.float64)
            stop = next((j for j in range(m, ncv) if bs[j] < 1e-11), ncv)
            for j in range(m, min(stop + 1, ncv)):
                col = Hr[:, j] + 1j * Hi[:, j]
                Hm[: j + 1, j] = col[: j + 1]
                Hm[j, : j + 1] = np.conj(col[: j + 1])
                b_np = bs[j] if bs[j] >= 1e-11 else 0.0
                Hm[j + 1, j] = b_np
                Hm[j, j + 1] = b_np
                it += 1
            m = min(stop + 1, ncv)
            if stop < ncv:
                # invariant subspace at step `stop` (the fused loop zeroed
                # the following rows): inject a random orthogonal direction
                # at row stop+1 and resume the fused expansion from there
                rr, ri = _proj(*vec_randomize(n, seed=rng_seed,
                                              complex_valued=complex_vec))
                rng_seed += 7
                Vre, Vim, bnorm = ops.insert_random(
                    Vre,
                    Vim if Vim is not None else jnp.zeros((1, 1)),
                    jnp.asarray(rr, Vre.dtype),
                    (jnp.asarray(ri, Vre.dtype) if ri is not None
                     else jnp.zeros(n, Vre.dtype)),
                    np.int32(stop), np.int32(stop + 1),
                ) if complex_vec else _insert_real(ops, Vre, rr,
                                                   np.int32(stop),
                                                   np.int32(stop + 1))
                if float(bnorm) < _BREAKDOWN * 10 or m >= n:
                    break

        # Rayleigh-Ritz on the active m x m block
        mm = min(m, ncv)
        A = Hm[:mm, :mm]
        theta, S = np.linalg.eigh(sort_sign * (A + A.conj().T) / 2.0)
        theta = sort_sign * theta
        # residual estimates: |Hm[mm, :mm] @ S[:, i]| (coupling to row mm)
        coup = Hm[mm, :mm] if mm < rows else np.zeros(mm)
        resid = np.abs(coup @ S)
        _solver_log("lanczos", it, theta[: min(nev, mm)],
                    resid[: min(nev, mm)])
        scale = max(np.max(np.abs(theta)), 1.0)
        nconv = 0
        for i in range(min(nev, mm)):
            if resid[i] < tol * scale:
                nconv += 1
            else:
                break
        if nconv >= nev or mm >= n:
            # final: return Ritz pairs
            keep = min(nev, mm)
            Sk = S[:, :keep]
            Spad = np.zeros((rows, keep), dtype=np.complex128)
            Spad[:mm] = Sk
            Yre, Yim = _compact(ops, Vre, Vim, Spad, np.int32(m), complex_vec)
            vecs = []
            for i in range(keep):
                vr = Yre[i]
                vi = Yim[i] if complex_vec else None
                vecs.append((vr, vi))
            if store is not None:
                store.delete(ckpt_key)
            return theta[:keep].tolist(), vecs

        # thick restart: keep best `keep` Ritz vectors + current residual dir
        keep = min(nev + max(2, nev), mm - 1)
        Sk = S[:, :keep]
        Spad = np.zeros((rows, keep), dtype=np.complex128)
        Spad[:mm] = Sk
        Vre, Vim = _compact_inplace(ops, Vre, Vim, Spad, np.int32(m),
                                    complex_vec)
        Hm[:, :] = 0.0
        Hm[:keep, :keep] = np.diag(theta[:keep])
        u = coup @ Sk  # coupling of v_m to kept Ritz vectors
        Hm[keep, :keep] = np.conj(u)
        Hm[:keep, keep] = u
        m = keep
        k_locked = keep
        if store is not None and time.monotonic() - last_save > _SAVE_PERIOD:
            # time-throttled AND size-capped: at large N the (ncv+1, N)
            # basis is GBs per record and the device->host pull stalls the
            # run. Past config.ckpt_max_bytes the
            # in-progress record is skipped — the stage/completion records
            # still persist, so a crash redoes at most this stage.
            from quantum_basis_tpu import config as _cfg

            itemsize = 4 if Vre.dtype == np.dtype("float32") else 8
            rec_bytes = (2 if complex_vec else 1) * rows * n * itemsize
            if rec_bytes <= _cfg.ckpt_max_bytes:
                store.save(ckpt_key, {
                    "Vre": np.asarray(Vre),
                    "Vim": np.asarray(Vim) if complex_vec else np.zeros((1, 1)),
                    "Hm": Hm, "m": m, "it": it,
                })
            last_save = time.monotonic()
    raise RuntimeError(f"thick-restart Lanczos failed to converge in {maxit} steps")


def _insert_real(ops, Vre, rr, j, row):
    import jax.numpy as jnp

    Vre, _, b = ops.insert_random(Vre, jnp.zeros((1, 1)),
                                  jnp.asarray(rr, Vre.dtype),
                                  jnp.zeros(Vre.shape[1], Vre.dtype),
                                  j, row)
    return Vre, None, b


def _compact(ops, Vre, Vim, Spad, m, complex_vec):
    import jax.numpy as jnp

    Sre = jnp.asarray(Spad.real, Vre.dtype)
    Sim = jnp.asarray(Spad.imag, Vre.dtype)
    Yre, Yim = ops.compact(Vre, Vim if Vim is not None else jnp.zeros((1, 1)),
                           Sre, Sim, m)
    return Yre, Yim


def _compact_inplace(ops, Vre, Vim, Spad, m, complex_vec):
    Yre, Yim = _compact(ops, Vre, Vim, Spad, m, complex_vec)
    return Yre, Yim
