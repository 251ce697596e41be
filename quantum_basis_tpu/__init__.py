"""quantum_basis_tpu — an exact-diagonalization framework on JAX accelerators.

A JAX/XLA framework for quantum lattice many-body problems
(spins, bosons, fermions, and mixtures), providing the full capability surface
of the reference C++ library ``wztzjhn/quantum_basis`` (see SURVEY.md), but
designed for accelerators:

- many-body product states are fixed-width integer *labels* (mixed-radix codes
  over per-(orbital,site) "slots"), decoded on device with vectorized
  shift/mask arithmetic — replacing the reference's malloc'd bit-packed byte
  strings (reference: src/basis.cc:139-944);
- the Hamiltonian is compiled from a host-side symbolic operator algebra into
  static *term tables* (joint-column lookup tables + Jordan-Wigner weight
  vectors), so matrix-free application ``y = H @ x`` is pure gathers, small
  integer matmuls (fermion parity), and elementwise math — no
  scatters, no dynamic shapes (reference: src/basis.cc:2585-2840,
  src/model.cc:941-1121);
- all device numerics are split-complex float64 ``(re, im)`` pairs;
- eigensolvers are a native JAX Krylov suite (Lanczos, CG refinement,
  thick-restart Lanczos, Chebyshev-filtered interior windows, continued
  fractions) — replacing MKL/ARPACK-NG/FEAST (reference: src/lanczos.cc);
- multi-chip scaling uses ``jax.sharding.Mesh`` + ``shard_map`` with psum /
  all_gather collectives over the basis axis (the reference is OpenMP-only).
"""

from quantum_basis_tpu import config as config
from quantum_basis_tpu.config import initialize

from quantum_basis_tpu.basis.site_basis import SiteBasis
from quantum_basis_tpu.basis.state import StateSpace
from quantum_basis_tpu.ops.operators import Opr, OprProd, Mopr
from quantum_basis_tpu.lattice.lattice import Lattice
from quantum_basis_tpu.models.model import Model
from quantum_basis_tpu.models.product import ProductModel

__version__ = "0.1.0"

__all__ = [
    "ProductModel",
    "config",
    "initialize",
    "SiteBasis",
    "StateSpace",
    "Opr",
    "OprProd",
    "Mopr",
    "Lattice",
    "Model",
    "__version__",
]
