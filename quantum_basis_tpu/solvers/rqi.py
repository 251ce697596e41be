"""Mixed-precision Rayleigh-quotient iteration (Jacobi-Davidson polish).

The f64 eigenpair polish used above ``_POLISH_N`` — the mixed-precision
successor of the reference's CG eigenvector refinement (``eigenvec_CG``,
reference src/lanczos.cc:281-341). The reference runs its whole refinement
in double; this solver splits the work by precision instead:

- one f64 matvec per OUTER iteration evaluates the Rayleigh quotient
  theta = <x|H|x> and the exact residual r = Hx - theta x (the rigorous
  eigenvalue error bound |theta - lambda| <= ||r|| for Hermitian H);
- the INNER loop approximately solves the Jacobi-Davidson correction
  equation  (I - xx*)(H - theta)(I - xx*) t = r  with projected CG running
  entirely on the f32 engine. Restricted to the complement of x near
  convergence, H - theta is positive definite (smallest eigenvalue ~ the
  spectral gap), so plain CG applies; negative curvature from f32 noise or
  a not-yet-converged theta just terminates the inner solve early with a
  partial (still useful) correction.

The update x <- normalize(x - t) is applied in f64; the correction t only
needs RELATIVE f32 accuracy (it is solved against the normalized residual
and scaled back), so the final attainable residual is set by the f64 outer
evaluation, not by f32 — the standard inexact-RQI/JD argument. Per outer
iteration the residual contracts by roughly the inner solve's relative
accuracy, so a warm f32 Ritz start (residual ~1e-4) reaches 1e-9..1e-10 in
a handful of outer f64 applies + a few hundred f32 applies each — minutes
instead of the hours the pure-f64 restarted Lanczos needed on the
small-gap flagship (kagome-24: measured stall at rnorm 1.7e-7).

Momentum sectors work unchanged: ``ProjectedFullOp.apply`` re-projects
P_k after every H application, so CG iterates stay in the sector.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu.config import lanczos_precision
from quantum_basis_tpu.ops import cplx as cx

_TINY = 1e-300

from collections import OrderedDict

# (program keys, complex) -> (outer_fn, inner_fn); LRU-bounded — entries pin
# compiled executables, and monotonic program_keys (config.next_program_key)
# make eviction safe (an evicted key is never reissued to a new operator).
_PROGRAM_CACHE: OrderedDict = OrderedDict()
_PROGRAM_CACHE_MAX = 8


def _make_outer(fs64, complex_vec):
    """x -> (theta, normalized x, residual r, ||r||), all f64.

    Memory discipline at N = 2^24 f64 on a 16 GB chip: ONE fused
    normalize+apply+reduce program OOM'd at compile (15.80G), and an
    apply+reduce split still OOM'd at runtime for the complex momentum
    sectors — the f64-complex P_k H program's temporaries alone approach
    the chip. For a REAL Hamiltonian (every Heisenberg-class model) the
    pipeline therefore decomposes into SEPARATE dispatches, each with the
    peak of its own program only:

        normalize (small) -> H re -> H im (the proven full-sector real
        apply, twice) -> projector+Rayleigh+residual (roll-scale temps).

    Complex Hamiltonians keep the apply+reduce split.
    """
    import jax
    import jax.numpy as jnp

    template = getattr(fs64, "_template", fs64)
    base_op = getattr(template, "base", None)
    projector = getattr(template, "projector", None)
    decompose = (complex_vec and base_op is not None
                 and projector is not None
                 and not bool(getattr(base_op, "is_complex", True)))

    if decompose:
        def norm_part(xr, xi):
            x = (xr, xi)
            inv = 1.0 / jnp.maximum(cx.norm(x), _TINY)
            return xr * inv, xi * inv

        def h_real(bp, v):
            y, _ = base_op.apply(bp, (v, None))
            return y

        def proj_reduce(pp, nxr, nxi, hr, hi):
            yr, yi = projector.apply(pp, (hr, hi))
            if yi is None:
                yi = jnp.zeros_like(yr)
            x = (nxr, nxi)
            y = (yr, yi)
            th = cx.vdot_re(x, y)
            r = cx.axpy(-th, x, y)
            return th, r[0], r[1], cx.norm(r)

        norm_jit = jax.jit(norm_part, donate_argnums=(0, 1))
        h_jit = jax.jit(h_real)
        pr_jit = jax.jit(proj_reduce, donate_argnums=(3, 4))

        # chunked H at large N: several small programs allocate in small
        # blocks (fragmentation-tolerant) instead of one near-chip-sized one
        chunk_fns = None
        if hasattr(base_op, "make_chunked_applies") \
                and base_op.N >= (1 << 23):
            chunk_fns = base_op.make_chunked_applies(6)

        def h_apply(bp, v):
            if chunk_fns is None:
                return h_jit(bp, v)
            y = None
            for f in chunk_fns:
                part = f(bp, (v, None))[0]
                y = part if y is None else y + part
            return y

        def outer(params, xr, xi):
            bp, pp = params
            nxr, nxi = norm_jit(xr, xi)
            hr = h_apply(bp, nxr)
            hi = h_apply(bp, nxi)
            th, rr, ri, rn = pr_jit(pp, nxr, nxi, hr, hi)
            return th, nxr, nxi, rr, ri, rn

        return outer

    def apply_part(params, xr, xi):
        x = (xr, xi if complex_vec else None)
        x = cx.scale(x, 1.0 / jnp.maximum(cx.norm(x), _TINY))
        y = fs64.apply(params, x)
        if complex_vec and y[1] is None:
            y = (y[0], jnp.zeros_like(y[0]))
        z = jnp.zeros((1,), xr.dtype)
        return (x[0], x[1] if complex_vec else z,
                y[0], y[1] if complex_vec else z)

    def reduce_part(nxr, nxi, yr, yi):
        x = (nxr, nxi if complex_vec else None)
        y = (yr, yi if complex_vec else None)
        th = cx.vdot_re(x, y)
        r = cx.axpy(-th, x, y)
        z = jnp.zeros((1,), nxr.dtype)
        return (th, r[0], r[1] if complex_vec else z, cx.norm(r))

    apply_jit = jax.jit(apply_part)
    reduce_jit = jax.jit(reduce_part, donate_argnums=(2, 3))

    def outer(params, xr, xi):
        nxr, nxi, yr, yi = apply_jit(params, xr, xi)
        th, rr, ri, rn = reduce_jit(nxr, nxi, yr, yi)
        return th, nxr, nxi, rr, ri, rn

    return outer


def _make_inner(fs32, complex_vec):
    """jit: projected-CG solve of (I-xx*)(H32 - theta)(I-xx*) t = b.

    ``b`` is normalized inside; the returned t is for the NORMALIZED rhs
    (the caller rescales). ``nsteps`` arrives traced so changing the inner
    budget reuses the executable. Returns (t_re, t_im, rel_res, k).
    """
    import jax
    import jax.numpy as jnp

    def pair(r, i):
        return (r, i if complex_vec else None)

    def proj(x_ref, v):
        return cx.project_out_one(x_ref, v) if complex_vec else \
            cx.axpy(-cx.vdot_re(x_ref, v), x_ref, v)

    def inner(p32, xr, xi, br, bi, th32, nsteps):
        x_ref = pair(xr, xi)
        b = proj(x_ref, pair(br, bi))
        bn = cx.norm(b)
        b = cx.scale(b, 1.0 / jnp.maximum(bn, _TINY))

        def Aop(v):
            y = fs32.apply(p32, v)
            if complex_vec and y[1] is None:
                y = (y[0], jnp.zeros_like(y[0]))
            y = cx.axpy(-th32, v, y)
            return proj(x_ref, y)

        t0 = cx.zeros_like(b)
        rs0 = cx.vdot_re(b, b)

        def cond(c):
            k, _, _, _, rs, done = c
            return (k < nsteps) & (~done)

        def body(c):
            k, t, r, p, rs, _ = c
            Ap = Aop(p)
            pAp = cx.vdot_re(p, Ap)
            ok = pAp > 1e-30
            alpha = jnp.where(ok, rs / jnp.maximum(pAp, 1e-30), 0.0)
            t2 = cx.axpy(alpha, p, t)
            r2 = cx.axpy(-alpha, Ap, r)
            rs2 = cx.vdot_re(r2, r2)
            beta = jnp.where(ok, rs2 / jnp.maximum(rs, 1e-30), 0.0)
            p2 = cx.axpy(beta, p, r2)
            # b is unit: rs2 IS the squared relative residual. 1e-10 is
            # below anything f32 can reach — the loop runs to nsteps or
            # negative curvature.
            done = (~ok) | (rs2 < 1e-10)
            return (k + 1, t2, r2, p2, rs2, done)

        k, t, r, p, rs, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), t0, b, b, rs0, jnp.asarray(False)))
        z = jnp.zeros((1,), br.dtype)
        return (t[0], t[1] if complex_vec else z, jnp.sqrt(rs), k, bn)

    return jax.jit(inner)


def _save_capped(store, key, payload):
    """Respect config.ckpt_max_bytes: at very large N the per-outer
    device->host pull of the iterate stalls the run; past the cap the
    in-progress record is skipped —
    the stage-level records still persist, so a crash redoes this stage
    only (same policy as the thick-restart solver's boundary saves)."""
    from quantum_basis_tpu import config

    nbytes = sum(a.nbytes for a in payload.values()
                 if isinstance(a, np.ndarray))
    if nbytes > config.ckpt_max_bytes:
        return
    store.save(key, payload)


def _rqi_rec(best, x_re, x_im, outer, complex_vec, pending):
    """Checkpoint record: the iterate to resume from (x_*) and the best
    evaluated iterate (best_*) as separate fields; ``pending`` marks x_* as
    not-yet-evaluated so the metadata never claims best's rnorm for it."""
    return {
        "x_re": np.asarray(x_re),
        "x_im": (np.asarray(x_im) if complex_vec else np.zeros(1)),
        "outer": outer, "pending": bool(pending),
        "best_re": np.asarray(best[2]),
        "best_im": (np.asarray(best[3]) if complex_vec else np.zeros(1)),
        "best_theta": best[1], "best_rnorm": best[0],
    }


def rqi_polish(fs64, v0, fs32=None, tol=None, max_outer: int = 60,
               inner: int = 240, inner_max: int = 1920, ckpt_key=None,
               log=None):
    """Polish eigenpair ``v0`` of ``fs64`` to f64 residual tolerance.

    fs64/fs32: full-space operators (.apply/.params protocol) in f64/f32;
    fs32 is required (this solver IS the mixed-precision path — callers
    without an f32 twin use lanczos_ground instead).

    Returns dict with E0, vector, residual (exact f64 ||Hx - E0 x||),
    converged, n_outer, n_inner (total f32 matvecs).
    """
    import jax.numpy as jnp

    assert fs32 is not None, "rqi_polish requires the f32 engine twin"
    complex_vec = (v0[1] is not None) or bool(getattr(fs64, "is_complex",
                                                      False))
    # share the jitted outer/inner programs across operators that declare a
    # program_key (per-momentum views over one template, models/model.py) —
    # a fresh jax.jit object recompiles the identical program from scratch
    pk = (getattr(fs64, "program_key", None),
          getattr(fs32, "program_key", None))
    if pk[0] is not None and pk[1] is not None:
        key = (pk, complex_vec)
        fns = _PROGRAM_CACHE.get(key)
        if fns is None:
            fns = _PROGRAM_CACHE[key] = (_make_outer(fs64, complex_vec),
                                         _make_inner(fs32, complex_vec))
            while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_MAX:
                _PROGRAM_CACHE.popitem(last=False)
        else:
            _PROGRAM_CACHE.move_to_end(key)
        outer_fn, inner_fn = fns
    else:
        outer_fn = _make_outer(fs64, complex_vec)
        inner_fn = _make_inner(fs32, complex_vec)
    p64, p32 = fs64.params, fs32.params

    def as_f64(v):
        return (jnp.asarray(v[0], jnp.float64),
                jnp.asarray(v[1], jnp.float64)
                if complex_vec and v[1] is not None else
                (jnp.zeros_like(jnp.asarray(v[0], jnp.float64))
                 if complex_vec else None))

    xr, xi = as_f64(v0)
    z64 = jnp.zeros((1,), jnp.float64)
    if xi is None:
        xi = z64

    from quantum_basis_tpu.utils.ckpt import active_store

    store = active_store() if ckpt_key else None
    n_outer0 = 0
    best = None  # (rnorm, theta, x_re HOST, x_im HOST)
    if store is not None:
        rec = store.load(ckpt_key)
        if rec is not None and rec["x_re"].shape == np.asarray(xr).shape:
            xr = jnp.asarray(rec["x_re"])
            if complex_vec:
                xi = jnp.asarray(rec["x_im"])
            n_outer0 = min(int(rec["outer"]), max_outer - 1)
            # best is persisted SEPARATELY from the (possibly unevaluated)
            # pending iterate in x_re: if a correction step diverged before
            # the crash, resume evaluates the pending x but still falls
            # back to best rather than losing it.
            if "best_re" in rec:
                best = (float(rec["best_rnorm"]), float(rec["best_theta"]),
                        np.asarray(rec["best_re"]),
                        np.asarray(rec["best_im"]) if complex_vec else None)

    # HBM discipline at N = 2^24 f64 (16 GB chip): between phases ALL
    # vector state lives on HOST — the f64 outer and f32 inner programs
    # each start against a device holding only operator params. Keeping
    # residual/correction/best buffers device-resident alongside the next
    # outer apply OOM'd repeatedly (the apply program's temporaries alone
    # approach the chip); the ~0.5 GB host round-trips cost seconds per
    # outer against 2-4 outers total.
    z32 = None

    def _f32(a):
        import jax

        return jax.device_put(jnp.asarray(np.asarray(a, np.float32)))

    n_inner_tot = 0
    cur_inner = int(inner)
    prev_rn = None
    theta = None
    it = n_outer0
    x_h = (np.asarray(xr), np.asarray(xi) if complex_vec else None)
    xr = xi = None
    for it in range(n_outer0, max_outer):
        xr_d = jnp.asarray(x_h[0])
        xi_d = jnp.asarray(x_h[1]) if complex_vec else jnp.zeros(
            (1,), jnp.float64)
        th, nxr, nxi, rr, ri, rn_dev = outer_fn(p64, xr_d, xi_d)
        theta, rn = float(th), float(rn_dev)
        x_h = (np.asarray(nxr), np.asarray(nxi) if complex_vec else None)
        r_h = (np.asarray(rr), np.asarray(ri) if complex_vec else None)
        del xr_d, xi_d, nxr, nxi, rr, ri, th, rn_dev
        if tol is None:
            tol = max(1e3 * lanczos_precision * max(abs(theta), 1.0), 5e-10)
        if log is not None:
            log(it, theta, rn, cur_inner)
        if best is None or rn < best[0]:
            best = (rn, theta, x_h[0], x_h[1])
        if store is not None:
            _save_capped(store, ckpt_key,
                         _rqi_rec(best, best[2], best[3], it + 1,
                                  complex_vec, pending=False))
        if rn < tol:
            break
        if prev_rn is not None and rn > 0.5 * prev_rn:
            # outer contraction stalling -> buy a more accurate correction
            cur_inner = min(2 * cur_inner, inner_max)
        prev_rn = rn
        if z32 is None:
            z32 = jnp.zeros((1,), jnp.float32)
        t_re, t_im, rel, k_dev, bn = inner_fn(
            p32, _f32(x_h[0]), _f32(x_h[1]) if complex_vec else z32,
            _f32(r_h[0]), _f32(r_h[1]) if complex_vec else z32,
            jnp.float32(theta), jnp.int32(cur_inner))
        n_inner_tot += int(k_dev)
        s = float(bn)
        t_h = (np.asarray(t_re, dtype=np.float64),
               np.asarray(t_im, dtype=np.float64) if complex_vec else None)
        del t_re, t_im, r_h
        # x <- x - t*||b32||  (t solved against the normalized rhs), on host
        x_h = (x_h[0] - s * t_h[0],
               (x_h[1] - s * t_h[1]) if complex_vec else None)
        del t_h
        if store is not None:
            # persist the UPDATED iterate immediately: a crash between the
            # inner solve and the next outer evaluation must not discard
            # the correction (observed: per-attempt OOM at the second
            # outer made every resume restart from the same stale x).
            # pending=True: x_re holds an iterate that has NOT been
            # evaluated yet — its quality is unknown; best travels in the
            # best_* fields.
            _save_capped(store, ckpt_key,
                         _rqi_rec(best, x_h[0], x_h[1], it + 1,
                                  complex_vec, pending=True))

    rn, theta, xr_h, xi_h = best
    xr = jnp.asarray(xr_h)
    xi = jnp.asarray(xi_h) if complex_vec else None
    converged = rn < (tol if tol is not None else np.inf)
    if store is not None and converged:
        store.delete(ckpt_key)
    vec = (xr, xi if complex_vec else None)
    return {
        "E0": theta,
        "vector": vec,
        "residual": rn,
        "residual_bound": rn,
        "converged": bool(converged),
        "n_outer": it + 1,
        "n_inner": n_inner_tot,
    }
