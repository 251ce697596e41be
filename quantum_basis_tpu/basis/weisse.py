"""Divide-and-conquer momentum-sector enumeration (Weisse equivalent).

The reference's Weisse machinery (classify_Weisse_tables + the e/w
multi-arrays + zipper, src/basis.cc:1475-2202, src/model.cc:274-487) exists
so the momentum basis can be enumerated from HALF-lattice bases — O(d^{N/2})
memory — instead of scanning the d^N product space state by state.

This module delivers the same capability in device-first form:

1. split the label space at a digit boundary SA ~ sqrt(label_space)
   (the same contiguous split as the Lin tables; the ''zipper'' of two
   half-labels is then a single integer add la + ib*SA);
2. enumerate both half bases (each ~sqrt-sized) and evaluate the conserved
   quantum numbers additively per half (Q = Q_A + Q_B - Q_0, valid for the
   site-sum conserved operators the reference supports);
3. stream the compatible (Q_A, Q_B) cross products through the device orbit
   classifier in fixed-size blocks, keeping only representatives (orbit
   minima) — no full-sector array ever exists on host or device.

The output is bit-identical to ``enumerate_reps`` over a materialized
sector (tests assert this), so downstream norms/matvecs are unchanged. The
streaming structure is also the multi-host sharding unit: different hosts
take different (Q_A block, Q_B block) tiles.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu.basis.lin_table import digit_split
from quantum_basis_tpu.ops.compile import compile_diagonal

_QN_TOL = 1e-5  # quantum-number tolerance (reference: src/basis.cc:1070)


def _half_values(space, conserve_lst, labels_half):
    """Evaluate each conserved operator on half-labels (other half = 0)."""
    if not conserve_lst:
        return np.zeros((0, labels_half.size))
    V = space.decode(labels_half)
    return np.stack([np.asarray(compile_diagonal(m, space)(V))
                     for m in conserve_lst])


def enumerate_reps_dnc(tset, conserve_lst=None, val_lst=None,
                       block: int = 1 << 20, with_dim: bool = False,
                       tile_select=None, sort: bool = True):
    """Momentum representatives without materializing the sector.

    Returns sorted representative labels; with ``with_dim`` also the total
    sector dimension (counted during the stream). Matches
    ``enumerate_reps(tset, enumerate_basis(...))`` exactly.
    """
    import jax
    import jax.numpy as jnp

    space = tset.space
    conserve_lst = list(conserve_lst or [])
    vals = np.asarray([float(v) for v in (val_lst or [])])
    sa = digit_split(space)
    total = int(space.label_space)
    sb = (total + sa - 1) // sa

    la = np.arange(sa, dtype=np.int64)
    lb = np.arange(sb, dtype=np.int64) * sa
    qa = _half_values(space, conserve_lst, la)          # (m, sa)
    qb = _half_values(space, conserve_lst, lb)          # (m, sb)
    q0 = _half_values(space, conserve_lst,
                      np.zeros(1, dtype=np.int64))[:, 0] \
        if conserve_lst else np.zeros(0)

    @jax.jit
    def rep_mask(lab):
        V = space.decode(lab)
        F = jnp.asarray(space.fermion_count_table)[
            jnp.arange(space.n_slots)[None, :], V.astype(jnp.int64)]
        tl, _ = tset.transform_all(V, F)
        return jnp.min(tl, axis=-1) == lab

    reps = []
    dim = 0
    tile_no = [0]

    def process(cands):
        # one streamed tile; distributable round-robin by tile index
        # (tile_select=(rank, nranks)); dim counts only OWNED tiles —
        # the sharded wrapper sums it across ranks
        nonlocal dim
        i = tile_no[0]
        tile_no[0] += 1
        if tile_select is not None and i % tile_select[1] != tile_select[0]:
            return
        dim += cands.size
        for start in range(0, cands.size, block):
            lab = jnp.asarray(cands[start:start + block])
            keep = np.asarray(rep_mask(lab))
            if keep.any():
                reps.append(np.asarray(cands[start:start + block])[keep])

    if not conserve_lst:
        for start_b in range(sb):
            process(lb[start_b] + la)
    else:
        # bucket half-labels by their rounded conserved-value tuples
        def keys(q):
            return [tuple(col) for col in
                    np.round(q / _QN_TOL).astype(np.int64).T]

        ka = keys(qa)
        kb = keys(qb)
        target = tuple(np.round((vals + q0) / _QN_TOL).astype(np.int64))
        from collections import defaultdict

        groups_a = defaultdict(list)
        for i, k in enumerate(ka):
            groups_a[k].append(i)
        groups_b = defaultdict(list)
        for i, k in enumerate(kb):
            groups_b[k].append(i)
        for k_a, idx_a in groups_a.items():
            k_need = tuple(np.asarray(target) - np.asarray(k_a))
            idx_b = groups_b.get(k_need)
            if not idx_b:
                continue
            A = la[np.asarray(idx_a)]
            B = lb[np.asarray(idx_b)]
            # stream the cross product in row strips of bounded size
            rows_per = max(1, block // max(A.size, 1))
            for start in range(0, B.size, rows_per):
                strip = (B[start:start + rows_per, None]
                         + A[None, :]).reshape(-1)
                process(strip)

    out = (np.concatenate(reps) if reps else np.empty(0, dtype=np.int64))
    if sort:
        out = np.sort(out)
    return (out, dim) if with_dim else out
