"""Dot-product lowering guarantees + the mixed-precision RQI polish.

Under ``config.f64_reduce_dots`` (for a backend whose f64 ``dot_general``
is not exact) every precision-critical f64 dot product must lower to
elementwise-multiply + reduce, and every f32 matmul of the solve path must
run at Precision.HIGHEST. These tests pin both by inspecting the jaxpr, so
a refactor that drops either fails on the CPU rather than on the device.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from quantum_basis_tpu.ops import cplx as cx


@pytest.fixture
def force_reduce_dots():
    """Force the f64 reduce lowering (off by default: native-f64 backends
    keep the exact dot_general)."""
    from quantum_basis_tpu import config

    old = config.f64_reduce_dots
    config.f64_reduce_dots = True
    yield
    config.f64_reduce_dots = old


def _jaxpr_str(fn, *args):
    return str(jax.make_jaxpr(fn)(*args))


def test_cx_vdot_f64_lowers_to_reduce(force_reduce_dots):
    a = jnp.zeros(16, jnp.float64)
    assert "dot_general" not in _jaxpr_str(
        lambda x, y: cx.vdot_re((x, None), (y, None)), a, a)
    assert "dot_general" not in _jaxpr_str(
        lambda x, y: cx.vdot((x, x), (y, y)), a, a)
    assert "dot_general" not in _jaxpr_str(
        lambda x: cx.norm((x, x)), a)


def test_cx_vdot_f32_keeps_dot_general():
    """The f32 engine path wants matmul units: f32 dots stay dot_general."""
    a = jnp.zeros(16, jnp.float32)
    assert "dot_general" in _jaxpr_str(
        lambda x, y: cx.vdot_re((x, None), (y, None)), a, a)


def test_restarted_deviceops_f64_avoids_dot_general(force_reduce_dots):
    """The CGS2 projection/subtraction/compaction of the thick-restart
    solver must not emit dot_general at f64 under the reduce lowering."""
    from quantum_basis_tpu.solvers.restarted import _DeviceOps

    class _Id:
        def apply(self, params, x):
            return x

        params = ()

    n, ncv = 64, 6
    ops = _DeviceOps(_Id(), n, ncv, False)
    V = jnp.zeros((ncv + 1, n), jnp.float64)
    jx = str(jax.make_jaxpr(
        lambda V: ops.step.__wrapped__(V, jnp.zeros((1, 1)), 0, ()))(V))
    assert "dot_general" not in jx
    S = jnp.zeros((ncv + 1, 3), jnp.float64)
    jc = str(jax.make_jaxpr(
        lambda V, S: ops.compact.__wrapped__(V, jnp.zeros((1, 1)), S,
                                             jnp.zeros_like(S), 4))(V, S))
    assert "dot_general" not in jc


def test_rqi_polish_reaches_f64_tolerance():
    """Mixed-precision RQI: f32 warm start + f64 residual/f32 correction
    must reach ~1e-10-class residuals, beating the warm start by orders of
    magnitude."""
    from tests.models_zoo import heisenberg_chain
    from quantum_basis_tpu.ops.apply_fullspace import FullSpaceOp
    from quantum_basis_tpu.ops.apply_contract import ContractOp
    from quantum_basis_tpu.solvers.restarted import eigs_smallest
    from quantum_basis_tpu.solvers.rqi import rqi_polish

    m, c = heisenberg_chain(12, "1/2")
    m.enumerate_basis_full([c["Sz"]], [0.0])
    s = m.sec_full[0]
    fs = FullSpaceOp(m.compiled_Ham, s.labels)
    fs32 = ContractOp(m.compiled_Ham, s.labels, dtype=jnp.float32)
    _, v32 = eigs_smallest(fs32, fs32.N, nev=1, ncv=12, maxit=2000, seed=1,
                           complex_vec=False, mask=fs32.mask, tol=3e-6)
    out = rqi_polish(fs, v32[0], fs32=fs32)
    assert out["converged"], out
    assert out["residual"] < 3e-9, out["residual"]
    # golden: E0(L=12 chain, Sz=0)
    assert abs(out["E0"] - (-5.387390917445)) < 1e-9


def test_rqi_polish_momentum_sector_complex():
    """Complex (k != 0) sector through the projected full-space ops."""
    from tests.models_zoo import heisenberg_chain

    m, c = heisenberg_chain(12, "1/2")
    m.enumerate_basis_repr([3], [c["Sz"]], [0.0])
    sec = m.sec_repr[0]
    fs = m._fullspace_repr_op(sec)
    fs32 = m._fullspace_repr_op(sec, dtype=jnp.float32)
    if fs is None or fs32 is None:
        pytest.skip("projected full-space path unsupported here")
    from quantum_basis_tpu.solvers.restarted import eigs_smallest
    from quantum_basis_tpu.solvers.rqi import rqi_polish

    _, v32 = eigs_smallest(fs32, fs32.N, nev=1, ncv=12, maxit=2000, seed=1,
                           complex_vec=True, mask=fs32.mask, tol=3e-6)
    out = rqi_polish(fs, v32[0], fs32=fs32)
    assert out["converged"], out
    assert out["residual"] < 3e-9
    # cross-check against the direct repr ELL solve
    m2, c2 = heisenberg_chain(12, "1/2")
    m2.enumerate_basis_repr([3], [c2["Sz"]], [0.0])
    m2.locate_E0_lanczos(which="repr", maxit=2000)
    assert abs(out["E0"] - float(m2.eigenvals_repr[0])) < 1e-8


def test_momentum_sector_program_sharing():
    """All momentum sectors must share ONE operator template (and thus one
    set of compiled solver programs): a fresh jax.jit object recompiles an
    identical program from scratch for every sector."""
    from tests.models_zoo import heisenberg_chain
    from quantum_basis_tpu.solvers.restarted import _device_ops

    m, c = heisenberg_chain(12, "1/2")
    views = []
    for k in (1, 2, 3):
        m.enumerate_basis_repr([k], [c["Sz"]], [0.0])
        fs = m._fullspace_repr_op(m.sec_repr[0])
        if fs is None:
            pytest.skip("projected full-space path unsupported here")
        views.append(fs)
    assert views[0]._template is views[1]._template is views[2]._template
    assert views[0].program_key == views[2].program_key
    # k=0 (real phases) joins the same complex-structure template
    m.enumerate_basis_repr([0], [c["Sz"]], [0.0])
    v0 = m._fullspace_repr_op(m.sec_repr[0])
    assert v0._template is views[0]._template
    assert v0.is_complex
    ops_a = _device_ops(views[0], views[0].N, 8, True)
    ops_b = _device_ops(views[1], views[1].N, 8, True)
    assert ops_a is ops_b
    ops_c = _device_ops(views[1], views[1].N, 9, True)  # new shape -> new ops
    assert ops_c is not ops_a


# ---------------------------------------------------------------------------
# f32 matmuls on the solve path run at Precision.HIGHEST: a reduced-precision
# matmul (TF32 on the GPU, 10-bit mantissa) cannot reach the f32 stage's
# 1e-5 target.
# ---------------------------------------------------------------------------


def _f32_dot_precisions(fn, *args):
    """Precision params of every f32 dot_general in fn's jaxpr, nested
    jaxprs (scan/while/cond/pjit bodies) included."""
    from jax.extend.core import ClosedJaxpr, Jaxpr

    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if (eqn.primitive.name == "dot_general"
                    and eqn.invars[0].aval.dtype == jnp.float32):
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if isinstance(sub, ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, Jaxpr):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _all_highest(precisions):
    return bool(precisions) and all(
        p is not None and all(q == jax.lax.Precision.HIGHEST for q in p)
        for p in precisions)


def test_kron_dense_f32_dots_run_at_highest():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from examples.square_fermi_hubbard import build_factorized

    pm, _ = build_factorized(2, 2)
    op = pm.op(jnp.float32)
    assert op.layout == "dense"
    x = jnp.zeros(op.N, jnp.float32)
    precs = _f32_dot_precisions(lambda v: op.apply(op.params, (v, None))[0], x)
    assert len(precs) == 2 and _all_highest(precs), precs


def test_contract_f32_dots_run_at_highest():
    from tests.models_zoo import heisenberg_chain
    from quantum_basis_tpu.ops.apply_contract import ContractOp

    m, c = heisenberg_chain(10, "1/2")
    m.enumerate_basis_full([c["Sz"]], [0.0])
    op = ContractOp(m.compiled_Ham, m.sec_full[0].labels, dtype=jnp.float32)
    x = jnp.zeros(op.N, jnp.float32)
    precs = _f32_dot_precisions(
        lambda v: op.apply(op.params, (v, None))[0], x)
    assert _all_highest(precs), precs


def test_restarted_deviceops_f32_dots_run_at_highest():
    """CGS2 projections, subtraction and compaction of the thick-restart
    solver at f32 (the mixed-precision bulk stage)."""
    from quantum_basis_tpu.solvers.restarted import _DeviceOps

    class _Id:
        dtype = jnp.float32

        def apply(self, params, x):
            return x

        params = ()

    n, ncv = 64, 6
    ops = _DeviceOps(_Id(), n, ncv, True)
    V = jnp.zeros((ncv + 1, n), jnp.float32)
    precs = _f32_dot_precisions(
        lambda V: ops.step.__wrapped__(V, V, 0, ()), V)
    S = jnp.zeros((ncv + 1, 3), jnp.float32)
    precs += _f32_dot_precisions(
        lambda V, S: ops.compact.__wrapped__(V, V, S, jnp.zeros_like(S), 4),
        V, S)
    assert _all_highest(precs), precs
