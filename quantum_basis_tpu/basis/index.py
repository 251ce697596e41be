"""Basis index: label -> row position lookup on device.

The device analogs of the reference's three lookup strategies
(src/basis.cc:1193-1348, src/model.cc:266-270):

- ``direct``: an O(1) dense position table over the whole label space —
  one gather per lookup. Chosen automatically when the label space fits
  (config.direct_lookup_max).
- ``bsearch``: vectorized binary search over the sorted label array
  (replaces ``binary_search``, src/miscellaneous.cc:261-339).
- Lin tables (two-gather lookup via sublattice labels) live in
  :mod:`quantum_basis_tpu.basis.lin_table` and plug in through the same
  interface.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu import config


class BasisIndex:
    """Sorted basis labels + device lookup ``labels -> row index``.

    ``lookup(tgt)`` returns int32 indices; entries not present in the basis
    return an arbitrary in-range index — call ``lookup_checked`` to also get
    a validity mask (used by general operator application where images may
    leave the sector).
    """

    def __init__(self, labels: np.ndarray, label_space: int, mode: str | None = None,
                 lin_split: int | None = None):
        import jax.numpy as jnp

        labels = np.asarray(labels, dtype=np.int64)
        if labels.size and np.any(labels[1:] <= labels[:-1]):
            raise ValueError("basis labels must be sorted strictly ascending")
        self.n = int(labels.size)
        self.label_space = int(label_space)
        if mode is None:
            if self.label_space <= config.direct_lookup_max:
                mode = "direct"
            elif lin_split is not None and self.n:
                mode = "lin"  # try Lin; fall back to bsearch below
            else:
                mode = "bsearch"
        self.mode = mode
        self.labels = jnp.asarray(labels)
        if mode == "lin":
            from quantum_basis_tpu.basis.lin_table import LinTable, LinTableError

            try:
                lt = LinTable(labels, self.label_space, int(lin_split))
                self._Ja = jnp.asarray(lt.Ja.astype(np.int32))
                self._Jb = jnp.asarray(lt.Jb.astype(np.int32))
                self._sa = int(lin_split)
            except LinTableError:
                # graceful fallback, reference: src/model.cc:266-270
                self.mode = mode = "bsearch"
        if mode == "direct":
            pos = np.zeros(self.label_space, dtype=np.int32)
            pos[labels] = np.arange(self.n, dtype=np.int32)
            self._pos = jnp.asarray(pos)
        elif mode not in ("bsearch", "lin"):
            raise ValueError(f"unknown index mode {mode!r}")

    @property
    def tables(self):
        """Device arrays backing the lookup — thread these through outer jits
        and shard_map as explicit (replicated) arguments."""
        if self.mode == "direct":
            return (self._pos,)
        if self.mode == "lin":
            return (self._Ja, self._Jb)
        return (self.labels,)

    def lookup_t(self, tables, tgt):
        """Row indices of target labels using explicitly-passed tables."""
        import jax.numpy as jnp

        if self.mode == "direct":
            (pos,) = tables
            t = jnp.clip(tgt, 0, self.label_space - 1)
            return pos[t]
        if self.mode == "lin":
            Ja, Jb = tables
            t = jnp.clip(tgt, 0, self.label_space - 1)
            j = Ja[t % self._sa] + Jb[t // self._sa]
            return jnp.clip(j, 0, max(self.n - 1, 0)).astype(jnp.int32)
        (labels,) = tables
        idx = jnp.searchsorted(labels, tgt)
        return jnp.clip(idx, 0, max(self.n - 1, 0)).astype(jnp.int32)

    def lookup(self, tgt):
        """Row indices of target labels (any shape); invalid -> arbitrary."""
        return self.lookup_t(self.tables, tgt)

    def lookup_checked(self, tgt):
        """(indices, valid mask) — valid iff the label is in the basis."""
        idx = self.lookup(tgt)
        valid = self.labels[idx] == tgt
        return idx, valid
