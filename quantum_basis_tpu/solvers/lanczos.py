"""Memory-lean Lanczos — ground states, gaps, dynamics, spectral bounds.

Native JAX re-design of the reference's multi-purpose ``lanczos`` kernel
(reference: src/lanczos.cc:134-266) and its drivers:

- ``lanczos_ground``  = "sr_val0/sr_vec0" (+ deflated "sr_val1/sr_vec1"):
  2-vector rolling iteration, run in *explicitly restarted cycles*: each
  cycle scans a fixed number of steps, recovers the Ritz vector by a second
  deterministic pass (the reference's own approach), then restarts the
  recurrence from that Ritz vector. Convergence is judged on the EXPLICIT
  residual ||H y - theta y||, which is trustworthy even when the rolling
  recurrence loses orthogonality (for a Hermitian H, |theta - lambda| <=
  ||r|| holds unconditionally — including degenerate levels). A plain
  unrestarted run with the reference's stagnation test can drift below the
  true eigenvalue by ~1e-6 at large m (classic Paige loss-of-orthogonality);
  restarting bounds each cycle's Krylov length so the drift never exceeds
  the explicit-residual gate.
- ``lanczos_dynamics`` = "dnmcs": fixed-step a/b recording for
  continued-fraction resolvents (orthogonality loss is benign there);
- ``energy_scale``     = kpm.cc spectral bounds (128 steps +10% slack).

Device loop structure: steps are fused into one ``lax.scan`` per cycle so
the host syncs once per cycle, amortizing dispatch and transfer latency.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu.config import lanczos_precision
from quantum_basis_tpu.ops import cplx as cx
from quantum_basis_tpu.solvers.tridiag import tridiag_eig, tridiag_eigvals

_TINY = 1e-300


def _mv_protocol(matvec):
    """(apply_fn, params): matvec objects expose .apply/.params so their
    device arrays are threaded through outer jits as arguments (embedding
    them as jit constants triggers pathological XLA constant folding)."""
    if hasattr(matvec, "apply") and hasattr(matvec, "params"):
        return matvec.apply, matvec.params
    return (lambda params, x: matvec(x)), ()


def _project_out(w, deflate):
    """w - sum_d <d, w> d  (split-complex)."""
    for d in deflate:
        pr, pi = cx.vdot(d, w)
        dr, di = d
        wr, wi = w
        wr = wr - pr * dr + (pi * di if di is not None and pi is not None else 0.0)
        if wi is not None:
            wi = wi - pr * (di if di is not None else 0.0) - (
                pi * dr if pi is not None else 0.0
            )
        w = (wr, wi)
    return w


def _make_step(mv_apply):
    """The 2-vector Lanczos recurrence step shared by all drivers.

    Each step re-orthogonalizes w against the cycle's start vector (the
    "anchor"): once the ground state converges, orthogonality loss is
    concentrated along the dominant Ritz direction — which, after the first
    restart, IS the start vector — so this one extra dot+axpy per step
    suppresses the classic Paige drift at 2-vector memory cost."""
    import jax.numpy as jnp

    def step(carry, _):
        v_prev, v_cur, b_prev, anchor, deflate, params = carry
        w = mv_apply(params, v_cur)
        w = cx.axpy(-b_prev, v_prev, w)
        a = cx.vdot_re(v_cur, w)
        w = cx.axpy(-a, v_cur, w)
        w = _project_out(w, (anchor,) + deflate)
        b = cx.norm(w)
        inv = jnp.where(b > _TINY, 1.0 / jnp.maximum(b, _TINY), 0.0)
        v_next = cx.scale(w, inv)
        return (v_cur, v_next, b, anchor, deflate, params), (a, b)

    return step


def _make_cycle(matvec, inner: int):
    """jit one Lanczos cycle: ``inner`` steps collecting (a, b) coefficients,
    and the fused second pass accumulating y = sum_m s_m v_m."""
    import jax
    import jax.numpy as jnp

    mv_apply, _ = _mv_protocol(matvec)
    step = _make_step(mv_apply)

    def first_pass(v0, deflate, params):
        carry = (cx.zeros_like(v0), v0, 0.0, v0, tuple(deflate), params)
        _, (a_arr, b_arr) = jax.lax.scan(step, carry, None, length=inner)
        return a_arr, b_arr

    def accum_step(carry, sm):
        v_prev, v_cur, b_prev, y, anchor, deflate, params = carry
        y = cx.axpy(sm, v_cur, y)
        (v_cur2, v_next, b, anchor, deflate, params), _ = step(
            (v_prev, v_cur, b_prev, anchor, deflate, params), None
        )
        return (v_cur2, v_next, b, y, anchor, deflate, params), None

    def second_pass(v0, s_coeff, deflate, params):
        """y = sum_m s_m v_m, re-orthogonalized against deflate, normalized;
        also returns theta = <y|H|y> and the explicit residual ||H y - theta y||.
        The anchor term: s_0 v_0 is added first, later w's are projected
        against v_0, matching the first pass exactly (deterministic replay)."""
        y0 = cx.zeros_like(v0)
        carry = (cx.zeros_like(v0), v0, 0.0, y0, v0, tuple(deflate), params)
        carry, _ = jax.lax.scan(accum_step, carry, s_coeff)
        y = _project_out(carry[3], deflate)
        y = cx.scale(y, 1.0 / jnp.maximum(cx.norm(y), _TINY))
        hy = mv_apply(params, y)
        theta = cx.vdot_re(y, hy)
        r = cx.axpy(-theta, y, hy)
        return y, theta, cx.norm(r)

    return jax.jit(first_pass), jax.jit(second_pass)


def lanczos_ground(
    matvec,
    v0,
    maxit: int = 3000,
    inner: int = 100,
    tol: float = lanczos_precision,
    deflate=(),
    want_vector: bool = True,
    log=None,
    ckpt_key=None,
):
    """Lowest eigenpair of Hermitian ``matvec`` from start vector ``v0``.

    Returns dict with E0, niter, residual (explicit ||Hy - E0 y||), and the
    Ritz ``vector``. ``deflate`` projects out converged eigenvectors each
    step — the reference's "sr_val1" mode for first excited states
    (src/lanczos.cc:218-226). ``maxit`` counts matrix applications.
    """
    import jax.numpy as jnp

    v0 = (v0[0], v0[1])
    v0 = _project_out(v0, deflate)
    v0 = cx.scale(v0, 1.0 / float(cx.norm(v0)))
    first_pass, second_pass = _make_cycle(matvec, inner)
    mv_params = _mv_protocol(matvec)[1]

    # the residual gate: |theta - lambda| <= ||r|| for Hermitian operators,
    # so r_tol directly bounds the eigenvalue error (degeneracy-safe).
    r_tol_abs = None  # set after first theta: max(1e3*tol*scale, 5e-10)

    v = v0
    theta = None
    best = None  # (theta, vector, explicit residual) across cycles
    used = 0
    alphas_last = betas_last = None

    from quantum_basis_tpu.utils.ckpt import active_store

    store = active_store() if ckpt_key else None
    if store is not None:
        rec = store.load(ckpt_key)
        if rec is not None and rec["v_re"].shape == np.asarray(v0[0]).shape:
            v = (jnp.asarray(rec["v_re"]),
                 jnp.asarray(rec["v_im"]) if v0[1] is not None else None)
            best = (float(rec["theta"]),
                    (jnp.asarray(rec["b_re"]),
                     jnp.asarray(rec["b_im"]) if v0[1] is not None else None),
                    float(rec["rnorm"]))
            used = int(rec["used"])
    while used < maxit:
        a_arr, b_arr = first_pass(v, tuple(deflate), mv_params)
        a_np, b_np = np.asarray(a_arr), np.asarray(b_arr)
        # truncate at Krylov breakdown (invariant subspace reached)
        brk = np.nonzero(b_np < 1e-12)[0]
        mcut = int(brk[0]) + 1 if brk.size else inner
        alphas_last, betas_last = a_np[:mcut], b_np[:mcut]
        # optimal-prefix selection: the cheap per-prefix residual estimate
        # |b_m s_{m-1}| locates where within the cycle the Ritz pair was
        # best — later steps may be pure orthogonality-loss noise.
        best_m, best_est, best_s0 = mcut, np.inf, None
        for m in range(2, mcut + 1):
            ev_m, sv_m = tridiag_eig(a_np[:m], b_np[:m])
            est = abs(b_np[m - 1] * sv_m[m - 1, 0])
            if est < best_est:
                best_m, best_est, best_s0 = m, est, np.ascontiguousarray(sv_m[:, 0])
        if best_s0 is None:
            _, sv_m = tridiag_eig(alphas_last, betas_last)
            best_s0 = np.ascontiguousarray(sv_m[:, 0])
        s0 = np.zeros(inner)  # zero-pad to fixed length: single jit signature
        s0[: best_m] = best_s0
        v, theta_dev, rnorm_dev = second_pass(
            v, jnp.asarray(s0), tuple(deflate), mv_params
        )
        theta = float(theta_dev)
        rnorm = float(rnorm_dev)
        used += 2 * inner + 1  # first pass + second pass + residual matvec
        if log is not None:
            log(used, theta, rnorm)
        if best is None or rnorm < best[2]:
            best = (theta, v, rnorm)
        if store is not None:
            # capped like every other per-iteration save: past
            # config.ckpt_max_bytes the device->host pull stalls every
            # cycle; stage records still persist
            from quantum_basis_tpu import config as _cfg

            rec = {
                "v_re": np.asarray(v[0]),
                "v_im": np.asarray(v[1]) if v[1] is not None else np.zeros(1),
                "b_re": np.asarray(best[1][0]),
                "b_im": np.asarray(best[1][1]) if best[1][1] is not None else np.zeros(1),
                "theta": best[0], "rnorm": best[2], "used": used,
            }
            if sum(a.nbytes for a in rec.values()
                   if isinstance(a, np.ndarray)) <= _cfg.ckpt_max_bytes:
                store.save(ckpt_key, rec)
        if r_tol_abs is None:
            r_tol_abs = max(1e3 * tol * max(abs(theta), 1.0), 5e-10)
        if rnorm < r_tol_abs:
            break

    theta, v, rnorm = best
    if store is not None and r_tol_abs is not None and rnorm < r_tol_abs:
        store.delete(ckpt_key)
    out = {
        "E0": theta,
        "niter": used,
        "residual": rnorm,
        "residual_bound": rnorm,
        "alphas": alphas_last,
        "betas": betas_last,
    }
    if want_vector:
        out["vector"] = v
    return out


def lanczos_dynamics(matvec, v_start, m_steps: int, ckpt_key=None,
                     ckpt_chunk: int = 64):
    """Fixed-step Lanczos recording (alphas, betas) — the "dnmcs" mode used
    for continued-fraction dynamical correlation functions
    (reference: model::measure_full_dynamic, src/model.cc:1696-1712).

    ``v_start`` must be normalized by the caller (its norm enters S(q,w)).
    With ``ckpt_key`` set and config.enable_ckpt, the run checkpoints every
    ``ckpt_chunk`` steps — the carried state is just (v_prev, v_cur, b) plus
    the coefficients so far, the same record the reference's "dnmcs"
    checkpoint writes (src/ckpt.cc:13-340) — and resumes mid-run.
    """
    from quantum_basis_tpu.utils.ckpt import active_store

    store = active_store() if ckpt_key else None
    if store is None:
        first_pass, _ = _make_cycle(matvec, m_steps)
        mv_params = _mv_protocol(matvec)[1]
        a_arr, b_arr = first_pass(v_start, (), mv_params)
        return np.asarray(a_arr), np.asarray(b_arr)

    import jax
    import jax.numpy as jnp

    mv_apply, mv_params = _mv_protocol(matvec)
    step = _make_step(mv_apply)

    def chunk_run(v_prev, v_cur, b_prev, anchor, params, nsteps):
        carry = (v_prev, v_cur, b_prev, anchor, (), params)
        carry, (a, b) = jax.lax.scan(step, carry, None, length=nsteps)
        return carry[0], carry[1], carry[2], a, b

    runs = {}  # one jit per distinct chunk length (at most two)

    def run_chunk(v_prev, v_cur, b_prev, anchor, nsteps):
        if nsteps not in runs:
            runs[nsteps] = jax.jit(
                lambda vp, vc, bp, an, pp: chunk_run(vp, vc, bp, an, pp,
                                                     nsteps))
        return runs[nsteps](v_prev, v_cur, b_prev, anchor, mv_params)

    complex_vec = v_start[1] is not None

    def pack(v):
        return (np.asarray(v[0]),
                np.asarray(v[1]) if v[1] is not None else np.zeros(1))

    def unpack(re, im):
        return (jnp.asarray(re), jnp.asarray(im) if complex_vec else None)

    k0 = 0
    alphas = np.zeros(0)
    betas = np.zeros(0)
    v_prev = cx.zeros_like(v_start)
    v_cur = v_start
    b_prev = 0.0
    # Fingerprint of the start vector: a same-key record from a run against
    # a different source vector (same dim) must not be resumed — the a/b
    # coefficients would describe a different resolvent.
    import zlib

    v_fp = zlib.crc32(np.ascontiguousarray(np.asarray(v_start[0])).tobytes())
    if v_start[1] is not None:
        v_fp = zlib.crc32(
            np.ascontiguousarray(np.asarray(v_start[1])).tobytes(), v_fp)
    rec = store.load(ckpt_key)
    if rec is not None and rec["v_cur_re"].shape == np.asarray(
            v_start[0]).shape and int(rec["m_steps"]) == m_steps \
            and int(rec.get("v_fp", v_fp)) == v_fp:
        k0 = int(rec["k"])
        alphas = np.asarray(rec["alphas"])
        betas = np.asarray(rec["betas"])
        v_prev = unpack(rec["v_prev_re"], rec["v_prev_im"])
        v_cur = unpack(rec["v_cur_re"], rec["v_cur_im"])
        b_prev = float(rec["b_prev"])

    k = k0
    while k < m_steps:
        n = min(ckpt_chunk, m_steps - k)
        v_prev, v_cur, b_dev, a_arr, b_arr = run_chunk(
            v_prev, v_cur, b_prev, v_start, n)
        b_prev = float(b_dev)
        alphas = np.concatenate([alphas, np.asarray(a_arr)])
        betas = np.concatenate([betas, np.asarray(b_arr)])
        k += n
        if k < m_steps:
            pr, pi = pack(v_prev)
            cr, ci = pack(v_cur)
            store.save(ckpt_key, {
                "k": k, "m_steps": m_steps, "b_prev": b_prev,
                "v_fp": v_fp,
                "alphas": alphas, "betas": betas,
                "v_prev_re": pr, "v_prev_im": pi,
                "v_cur_re": cr, "v_cur_im": ci,
            })
    store.delete(ckpt_key)
    return alphas, betas


def energy_scale(matvec, v0, m_steps: int = 128, slack: float = 0.1):
    """Spectral bounds [E_min, E_max] via a short Lanczos run, widened by
    ``slack`` — replaces kpm.cc's ``energy_scale`` (src/kpm.cc:45-99); used
    to rescale H for Chebyshev/KPM iterations.
    """
    v0 = cx.scale(v0, 1.0 / float(cx.norm(v0)))
    alphas, betas = lanczos_dynamics(matvec, v0, m_steps)
    keep = np.nonzero(betas < 1e-12)[0]
    mcut = int(keep[0]) + 1 if keep.size else m_steps
    evals = tridiag_eigvals(alphas[:mcut], betas[:mcut])
    e_min, e_max = float(evals[0]), float(evals[-1])
    width = max(e_max - e_min, 1e-10)
    return e_min - slack * width, e_max + slack * width
