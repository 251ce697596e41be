"""Conjugate-gradient eigenvector refinement.

JAX port of the reference's ``eigenvec_CG`` (src/lanczos.cc:281-341):
given a converged eigenvalue E0, drive (H - E0) v -> 0 by CG with the
restart-on-renormalize logic of the reference (re-normalize v, recompute
r = (E0 - H) v, restart the Krylov direction). The whole iteration is one
``lax.while_loop`` — no host round-trips; BLAS1 ops are fused by XLA.

Use cases match the reference: polish an eigenvector from a coarser solve
(e.g. a mixed-precision Lanczos run) to full f64 solver tolerance, or
recover V0/V1 from checkpointed energies without storing Krylov bases.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu.ops import cplx as cx


def eigenvec_cg(matvec, E0: float, v0, maxit: int = 1000, tol: float = 2e-12,
                ckpt_key=None, ckpt_every: int = 500):
    """Refine v0 toward the E0 eigenvector.

    matvec follows the (params, apply) protocol; v0 is a split-complex cvec.
    Returns (v, residual_norm, iterations). The residual is
    ||(H - E0) v|| with ||v|| = 1 (the reference's `accu`).

    With ``ckpt_key`` set and config.enable_ckpt, the run checkpoints every
    ``ckpt_every`` iterations (reference: the CG branch of
    src/ckpt.cc:343-516). Only the current iterate v and the count are
    saved — on resume CG restarts its Krylov direction from v, which the
    reference's own restart-on-renormalize logic does periodically anyway.
    """
    import jax
    import jax.numpy as jnp

    from quantum_basis_tpu.utils.ckpt import active_store

    store = active_store() if ckpt_key else None

    params = matvec.params
    complex_vec = v0[1] is not None

    def as_pair(x):
        return (x[0], x[1] if complex_vec else jnp.zeros_like(x[0]))

    def hs(x):
        """(H - E0) x."""
        xx = (x[0], x[1] if complex_vec else None)
        y = matvec.apply(params, xx)
        y = (y[0], y[1] if y[1] is not None else
             (jnp.zeros_like(y[0]) if complex_vec else None))
        out = cx.axpy(-float(E0), xx, y)
        return as_pair(out)

    def restart(v):
        rn = cx.norm(v)
        v = cx.scale(v, 1.0 / jnp.maximum(rn, 1e-300))
        r = cx.scale(hs(v), -1.0)                       # r = (E0 - H) v
        return v, r, r, cx.norm(r)

    def body(carry):
        m, v, r, p, gamma, _ = carry

        def do_restart(_):
            vn, rn_, pn, g = restart(v)
            # done if the fresh residual is already converged, or v was
            # already unit-norm (reference: break without restart)
            was_unit = jnp.abs(cx.norm(v) - 1.0) <= tol
            done = (g < tol) | was_unit
            return m + 1, vn, rn_, pn, g, done

        def do_step(_):
            pp = hs(p)
            delta_re, delta_im = cx.vdot(p, pp)
            delta = delta_re  # Hermitian H: <p, (H-E0)p> is real
            alpha = gamma * gamma / delta
            vn = cx.axpy(alpha, p, v)
            rn_ = cx.axpy(-alpha, pp, r)
            g2 = cx.norm(rn_)
            beta = g2 / jnp.maximum(gamma, 1e-300)
            pn = cx.add(rn_, cx.scale(p, beta * beta))
            return m + 1, vn, rn_, pn, g2, jnp.asarray(False)

        return jax.lax.cond(gamma < tol, do_restart, do_step, None)

    m_start = 0
    if store is not None:
        rec = store.load(ckpt_key)
        # Resume only when the record matches THIS problem: shape AND the
        # eigenvalue it was polishing toward. A same-key record from a run
        # with a different E0/Hamiltonian would converge to a wrong vector.
        if (rec is not None
                and rec["v_re"].shape == np.asarray(v0[0]).shape
                and abs(float(rec.get("E0", E0)) - float(E0))
                <= 1e-8 * max(1.0, abs(float(E0)))):
            m_start = int(rec["m"])
            v0 = (jnp.asarray(rec["v_re"]),
                  jnp.asarray(rec["v_im"]) if complex_vec else None)

    v0p = as_pair((v0[0], v0[1]))
    v, r, p, gamma = restart(v0p)
    init = (jnp.asarray(m_start + 1), v, r, p, gamma, jnp.asarray(False))

    @jax.jit
    def run(init, m_end):
        def cond(carry):
            m, _, _, _, _, done = carry
            return (~done) & (m < m_end)

        return jax.lax.while_loop(cond, body, init)

    def save_state(m_now, vc):
        store.save(ckpt_key, {
            "m": m_now, "E0": float(E0),
            "v_re": np.asarray(vc[0]),
            "v_im": (np.asarray(vc[1]) if complex_vec else np.zeros(1)),
        })

    carry = init
    while True:
        m_end = maxit if store is None else min(
            int(carry[0]) + ckpt_every, maxit)
        carry = run(carry, jnp.asarray(m_end))
        m_now, done = int(carry[0]), bool(carry[5])
        if done or m_now >= maxit:
            if store is not None and not done:
                save_state(m_now, carry[1])  # unconverged: keep for resume
            break
        if store is not None:
            save_state(m_now, carry[1])
            # resuming restarts the direction: do the same now so the saved
            # and in-memory trajectories agree (deterministic replay)
            v, r, p, gamma = restart(carry[1])
            carry = (carry[0], v, r, p, gamma, carry[5])

    m, v, r, p, gamma, done_flag = carry
    if store is not None and bool(done_flag):
        store.delete(ckpt_key)
    rn = cx.norm(v)
    v = cx.scale(v, 1.0 / float(rn))
    res = float(cx.norm(hs(v)))
    out = (v[0], v[1] if complex_vec else None)
    return out, res, int(m)
