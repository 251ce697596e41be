"""Translation symmetry: orbits, representatives, momentum-sector norms.

Device-first re-design of the reference's momentum-sector machinery. The
reference builds Weisse divide-and-conquer tables over half-lattice bases to
avoid scanning each state's full translation orbit on a CPU
(src/basis.cc:1351-2202). On an accelerator the orbit scan is the *better* fit: for a
batch of states, all G translated labels are one integer matmul
``V @ stride_perms`` (plus a fermion-parity quadratic form), so
classification is embarrassingly parallel with no table indirection. This is
mathematically the reference's own dual-check path ("deprecated" orbit
classification, src/model.cc:2316-2427), which its examples assert equal to
the Weisse path — here it is the primary implementation.

Definitions (translation group {T(R)}, G elements, momentum k):

- representative r of an orbit = the minimum label in the orbit;
- P_k = (1/G) sum_R e^{+i k.R} T(R) is the projector onto momentum k
  (sign convention pinned by the chiral-fermion oracle in tests/test_repr.py);
- norm nu_r = <r|P_k|r> = (1/G) sum_{S in Stab(r)} sigma_S e^{i k.S},
  where T(S)|r> = sigma_S |r> defines the stabilizer sign; nu is |Stab|/G
  when k is compatible (including fermionic boundary signs) and 0 otherwise
  (cf. norm_trans_repr, src/basis.cc:2104-2202). Stabilizers are closed
  under inverse, so the sum is real and insensitive to the phase sign;
- the sector basis is the set of representatives with nu_r > 0.
"""

from __future__ import annotations

import numpy as np


class TranslationSet:
    """All translations of a lattice precompiled for device use.

    Host precompute: per group element R, the label permutation as a stride
    vector (new_label = V . stride_perm_R) and the fermionic inversion
    matrix Q_R (parity = F^T Q_R F mod 2); cf. StateSpace.permutation_arrays.
    """

    def __init__(self, space, lattice):
        import jax.numpy as jnp

        self.space = space
        self.lattice = lattice
        disps, plans = lattice.translation_group()
        self.disps = disps                     # (G, dim) int
        self.G = disps.shape[0]
        S = space.n_slots
        SP = np.zeros((S, self.G), dtype=np.int64)
        Qs = []
        self.fermionic = space.fermionic
        for g in range(self.G):
            sp, Q = space.permutation_arrays(plans[g])
            SP[:, g] = sp
            Qs.append(Q)
        self.SP = jnp.asarray(SP)              # (S, G)
        # f64 copy for the label matmul: not every XLA backend implements
        # an s64 dot_general; f64 is exact below 2^53
        self.SPf = jnp.asarray(SP.astype(np.float64))
        if self.fermionic:
            self.Q = jnp.asarray(np.stack(Qs).astype(np.float32))  # (G, S, S)
        else:
            self.Q = None

    # ---------------------------------------------------------------- device

    def transform_all(self, V, F):
        """All G translations of a batch of states.

        V (..., S) int — slot values; F (..., S) — fermion counts.
        Returns (labels (..., G) int64, sign (..., G) f64).
        """
        import jax.numpy as jnp

        labels = jnp.round(
            jnp.einsum("...s,sg->...g", V.astype(jnp.float64), self.SPf)
        ).astype(jnp.int64)
        if self.fermionic:
            Ff = F.astype(jnp.float32)
            # parity_g = F^T Q_g F  (mod 2): einsum over the two slot axes
            par = jnp.einsum("...s,gst,...t->...g", Ff, self.Q, Ff)
            sign = 1.0 - 2.0 * jnp.mod(par, 2.0).astype(jnp.float64)
        else:
            sign = jnp.ones(labels.shape, dtype=jnp.float64)
        return labels, sign

    def phases(self, momentum):
        """e^{-i k.R} per group element: (cos (G,), sin (G,)) numpy arrays.

        ``momentum`` is the integer momentum vector; the phase angle is
        -2*pi*(k.R fraction) with the fraction delegated to the lattice
        (k_d R_d / L_d on rectangular supercells, m @ A^{-T} R on tilted).
        """
        ang = -2.0 * np.pi * (self.lattice.k_dot_R(momentum, self.disps)
                              if self.disps.size else np.zeros(self.G))
        return np.cos(ang), np.sin(ang)


def classify_orbits(tset: TranslationSet, labels: np.ndarray, chunk: int = 1 << 18):
    """Orbit minimum for every basis label (host orchestration, device math).

    Returns orbitmin (N,) int64. A state is a representative iff
    ``orbitmin[i] == labels[i]``.
    """
    import jax
    import jax.numpy as jnp

    space = tset.space
    labels = np.asarray(labels, dtype=np.int64)
    n = labels.size

    @jax.jit
    def chunk_min(lab):
        V = space.decode(lab)
        F = jnp.asarray(space.fermion_count_table)[
            jnp.arange(space.n_slots)[None, :], V.astype(jnp.int64)
        ]
        tl, _ = tset.transform_all(V, F)
        return jnp.min(tl, axis=-1)

    out = np.empty(n, dtype=np.int64)
    for start in range(0, n, chunk):
        lab = jnp.asarray(labels[start : start + chunk])
        out[start : start + lab.size] = np.asarray(chunk_min(lab))
    return out


def sector_norms(tset: TranslationSet, reps: np.ndarray, momentum,
                 chunk: int = 1 << 18):
    """nu_r = <r|P_k|r> for each representative (real, >= 0 up to roundoff).

    Mirrors ``norm_trans_repr`` (reference: src/basis.cc:2104-2202) — but as
    the direct stabilizer sum over the whole group, batched on device.
    """
    import jax
    import jax.numpy as jnp

    space = tset.space
    reps = np.asarray(reps, dtype=np.int64)
    cos, sin = tset.phases(momentum)
    cos_d, sin_d = jnp.asarray(cos), jnp.asarray(sin)

    @jax.jit
    def chunk_norm(lab):
        V = space.decode(lab)
        F = jnp.asarray(space.fermion_count_table)[
            jnp.arange(space.n_slots)[None, :], V.astype(jnp.int64)
        ]
        tl, sg = tset.transform_all(V, F)
        stab = (tl == lab[:, None]).astype(jnp.float64)
        re = jnp.sum(stab * sg * cos_d[None, :], axis=-1) / tset.G
        im = jnp.sum(stab * sg * sin_d[None, :], axis=-1) / tset.G
        return re, im

    out = np.empty(reps.size, dtype=np.float64)
    for start in range(0, reps.size, chunk):
        lab = jnp.asarray(reps[start : start + chunk])
        re, im = chunk_norm(lab)
        re = np.asarray(re)
        if np.max(np.abs(np.asarray(im)), initial=0.0) > 1e-9:
            raise AssertionError("momentum-sector norm has imaginary part")
        out[start : start + lab.size] = re
    return out


def enumerate_reps(tset: TranslationSet, labels: np.ndarray) -> np.ndarray:
    """Representatives (orbit minima present in ``labels``); sorted.

    ``labels`` must be the full (sorted) quantum-number-sector basis — the
    orbit of any sector state stays in the sector, so the orbit minimum is
    itself a sector state.
    """
    orbitmin = classify_orbits(tset, labels)
    return labels[orbitmin == labels]
