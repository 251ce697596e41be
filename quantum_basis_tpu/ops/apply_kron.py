"""Tensor-factorized sector apply — dense matmuls instead of gathers.

Many sector Hamiltonians factorize over a tensor product of two smaller
conserved subsectors:

    H = H_a (x) I_b  +  I_a (x) H_b  +  sum_m D_a,m (x) D_b,m

with ``D_*`` diagonal. The canonical case is the Fermi-Hubbard model in the
species-major Jordan-Wigner ordering (all spin-up modes before all
spin-down modes): the up-hopping acts only on the up-occupation factor, the
down-hopping only on the down factor, and the U term is a diagonal product
``U sum_i n_i^up (x) n_i^dn``.  The 4x4 half-filled sector — dim
C(16,8)^2 = 165,636,900, far beyond anything the reference attempts
(its anchor is 4x2, examples/trans_absent/latt_square/square_Fermi_Hubbard
.cc:113) — then never materializes 1.66e8 basis labels at all: the state
vector IS a (12870, 12870) matrix ``psi`` and one H application is

    y = A psi + psi B^T + (a_diag (+) b_diag + scale * P) o psi

two dense matmuls plus one elementwise pass (~4.3e12 multiply-adds per
apply at 4x4), or the same operator as ELL row/column gathers.

Layouts (``layout=``):

- ``"dense"`` (default): ``A``/``B^T`` stored dense and applied as matmuls
  at Precision.HIGHEST, in f32 (the bulk Krylov engine) and f64.
- ``"ell"``: the factor ELL matrices applied as per-slot row/column
  gathers + elementwise multiply-add — the plain reference the dense
  layout is checked against, and the layout for factors too large to hold
  densely.

Both layouts share the elementwise diagonal.

Eigenvalues are basis-ordering independent, so results cross-check against
the site-major 'electron' encoding of the generic engines at 1e-8
(tests/test_kron.py) and against the reference's 4x2 golden values.

Reference parity: replaces model::MultMv2 (src/model.cc:941-1121) for
factorizable sectors. No analog exists in the reference.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu.config import next_program_key


def _ell_to_dense(ell, dtype):
    """Densify an EllMatrix's off-diagonal part (host side, once)."""
    na = ell.n
    dense = np.zeros((na, na), dtype=np.float64)
    if ell.width:
        cols = np.asarray(ell.cols, dtype=np.int64)
        vals = np.asarray(ell.vre, dtype=np.float64)
        rows = np.broadcast_to(np.arange(na, dtype=np.int64)[:, None],
                               cols.shape)
        # padding entries carry val 0.0 at col 0: harmless under add
        np.add.at(dense, (rows.reshape(-1), cols.reshape(-1)),
                  vals.reshape(-1))
    return dense.astype(dtype)


def _compact_coupling(P):
    """Store the (na, nb) diagonal-coupling matrix small: int8 when its
    entries are small integers (occupation products), else float32."""
    P = np.asarray(P)
    if P.dtype == np.int8:
        return P
    rP = np.rint(P)
    if np.max(np.abs(P - rP)) < 1e-9 and np.max(np.abs(rP)) <= 127:
        return rP.astype(np.int8)
    return P.astype(np.float32)


class KronOp:
    """y = H x for H = A (x) I + I (x) B + diagonal couplings.

    ``A``/``B``: real :class:`~quantum_basis_tpu.ops.sparse.EllMatrix` over
    the two factor bases (``B=None`` reuses ``A``; requires A symmetric,
    which holds for any real Hermitian factor). ``coupling``: optional
    (na, nb) array (the precomputed sum of diagonal outer products),
    multiplied by ``coupling_scale``.

    ``layout='dense'`` applies A/B^T as dense matmuls at HIGHEST precision,
    ``layout='ell'`` as ELL gathers + elementwise FMAs. Default: dense,
    except f64 under ``config.f64_reduce_dots`` (no f64 dot_general), which
    takes ELL.

    Vectors are split-complex ``(re, None)`` of length na*nb, row-major
    ``psi[r_a, c_b]`` — the solver protocol (.apply/.params) is identical
    to every other engine's.
    """

    is_complex = False
    mask = None

    def __init__(self, A, B=None, coupling=None, coupling_scale: float = 1.0,
                 dtype=None, layout: str | None = None):
        import jax.numpy as jnp

        from quantum_basis_tpu import config

        if A.is_complex or (B is not None and B.is_complex):
            raise NotImplementedError("KronOp factors must be real")
        dtype = jnp.dtype(dtype or jnp.float64)
        if layout is None:
            if dtype == jnp.dtype(jnp.float64) and config.f64_reduce_dots:
                layout = "ell"
            else:
                layout = "dense"
        self.layout = layout
        self.dtype = dtype
        self.na = A.n
        self.nb = B.n if B is not None else A.n
        self.N = self.na * self.nb
        self.n = self.N
        self.program_key = (next_program_key(), str(dtype), layout)

        adiag = np.asarray(A.diag, dtype=np.float64)
        bdiag = (np.asarray(B.diag, dtype=np.float64) if B is not None
                 else adiag)
        if layout == "dense":
            Ad = _ell_to_dense(A, np.dtype(str(dtype)))
            if B is None:
                if A.n * A.n <= (1 << 22):  # cheap exact check at test sizes
                    assert np.array_equal(Ad, Ad.T), \
                        "B=None requires symmetric A"
                Bt = Ad  # psi @ A^T == psi @ A for symmetric A; one copy
            else:
                Bt = _ell_to_dense(B, np.dtype(str(dtype))).T.copy()
            self._Aside = (jnp.asarray(Ad),)
            self._Bside = (jnp.asarray(Bt),)
        else:
            def ell_arrays(e):
                return (jnp.asarray(np.asarray(e.cols, dtype=np.int32)),
                        jnp.asarray(np.asarray(e.vre), dtype=dtype))

            self._Aside = ell_arrays(A)
            self._Bside = ell_arrays(B) if B is not None else self._Aside
        self._adiag = jnp.asarray(adiag, dtype=dtype)
        self._bdiag = jnp.asarray(bdiag, dtype=dtype)
        if coupling is not None:
            self._P = jnp.asarray(_compact_coupling(coupling))
            self._pscale = float(coupling_scale)
        else:
            self._P = None
            self._pscale = 0.0
        # stored nonzeros of the assembled H (for nnz/s benchmarks)
        wA = A.width
        wB = B.width if B is not None else wA
        self.nnz_estimate = self.na * self.nb * (wA + wB + 1)

    @property
    def params(self):
        return (self._Aside, self._Bside, self._adiag, self._bdiag, self._P)

    def apply(self, params, x):
        import jax.numpy as jnp
        from jax import lax

        Aside, Bside, adiag, bdiag, P = params
        xr, xi = x
        if xi is not None:
            raise NotImplementedError("KronOp is a real engine")
        psi = xr.reshape(self.na, self.nb)
        if self.layout == "dense":
            prec = lax.Precision.HIGHEST
            (Ad,), (Bt,) = Aside, Bside
            y = jnp.matmul(Ad, psi, precision=prec)
            y = y + jnp.matmul(psi, Bt, precision=prec)
        else:
            (Ac, Av), (Bc, Bv) = Aside, Bside
            y = jnp.zeros_like(psi)
            for k in range(Ac.shape[1]):
                # row r of (A psi): sum_k Av[r,k] * psi[Ac[r,k], :]
                y = y + Av[:, k][:, None] * psi[Ac[:, k], :]
            for k in range(Bc.shape[1]):
                # col c of (psi B^T): sum_k Bv[c,k] * psi[:, Bc[c,k]]
                y = y + Bv[:, k][None, :] * jnp.take(psi, Bc[:, k], axis=1)
        d = adiag[:, None] + bdiag[None, :]
        if P is not None:
            d = d + self.dtype.type(self._pscale) * P.astype(self.dtype)
        y = y + d * psi
        return (y.reshape(-1), None)

    def __call__(self, x):
        import jax

        return jax.jit(self.apply)(self.params, x)


def diagonal_product_coupling(space_a, labels_a, space_b, labels_b, pairs):
    """P = sum_m u_m (x) w_m for diagonal operator pairs (op_a, op_b).

    Each op is an all-diagonal Mopr on its factor space; u_m/w_m are its
    per-basis-state values. Returns the dense (na, nb) coupling matrix
    (computed as one (na, M) @ (M, nb) product). For the Hubbard U term the
    pairs are (n_i^up, n_i^dn) per site and P[r, c] is the number of doubly
    occupied sites — integer-valued, stored int8 downstream.
    """
    from quantum_basis_tpu.ops.compile import compile_diagonal

    Va = space_a.decode(np.asarray(labels_a, dtype=np.int64))
    Vb = space_b.decode(np.asarray(labels_b, dtype=np.int64))
    U = np.empty((len(labels_a), len(pairs)), dtype=np.float64)
    W = np.empty((len(pairs), len(labels_b)), dtype=np.float64)
    for m, (op_a, op_b) in enumerate(pairs):
        U[:, m] = compile_diagonal(op_a, space_a)(Va)
        W[m, :] = compile_diagonal(op_b, space_b)(Vb)
    return U @ W
