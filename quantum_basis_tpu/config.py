"""Global configuration: precision constants, x64 setup, checkpoint flag.

Mirrors the reference's tolerance constants and ``initialize()`` entry point
(reference: src/miscellaneous.cc:44-112, src/qbasis.h:48-64), adapted to JAX:
``initialize`` enables float64, prints an environment banner, and toggles the
crash-consistent checkpoint subsystem.
"""

from __future__ import annotations

import os
import platform

import jax

# Double precision is mandatory for the 1e-8 golden-value contract: enable it
# eagerly at import so every module traces with x64 semantics.
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR
# itself; when neither that variable nor an in-process setting names a
# directory, compiled programs are kept at a fixed path inside the checkout,
# so a later process (or a re-run) of the same program skips compilation.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR") \
        and not jax.config.jax_compilation_cache_dir:
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), ".xla_cache"))

import numpy as np  # noqa: E402

# Numerical tolerances (reference: src/miscellaneous.cc:44-47).
machine_prec = float(np.finfo(np.float64).eps)
opr_precision = 1e-12       # for comparing operator matrix elements
sparse_precision = 1e-14    # entries below this are dropped from sparse H
lanczos_precision = 2e-12   # Lanczos convergence tolerance


def residual_gate(e0: float) -> float:
    """Largest exact-f64 residual ||H v - E0 v|| (unit v) accepted for a
    published eigenpair — a rigorous eigenvalue error bound for Hermitian
    H. Solves that stop above it raise instead of returning."""
    return max(1e3 * lanczos_precision * max(abs(e0), 1.0), 5e-10)


# Crash-consistent checkpointing of long Krylov runs (reference: src/ckpt.cc:11).
enable_ckpt = False

# Mixed-precision Krylov (SURVEY §7.2 hard part #2): run the Lanczos bulk in
# float32 on the window-contraction engine, then polish in float64 from the
# f32 Ritz vector. The final eigenpairs still meet the f64 solver tolerance;
# the f32 stage does most of the SpMV work. Off by default — enable per run
# via initialize(mixed_precision=True) or set directly. Every f32 matmul of
# the solve path runs at Precision.HIGHEST: a reduced-precision matmul
# (TF32 on the GPU keeps a 10-bit mantissa) cannot reach the f32 stage's
# target below.
mixed_precision = False

# f32-stage convergence target (residual, relative to |E|); the f64 polish
# stage then runs to the caller's tolerance from this warm start.
mixed_precision_f32_tol = 1e-5

# Directory for checkpoint files (reference uses ``out_Qckpt/``).
ckpt_dir = "out_Qckpt"

# f64 dot-product lowering: False (default) -> dot_general, exact on
# native-f64 backends; True -> elementwise-multiply + reduce for every
# precision-critical f64 dot (kept for backends whose f64 dot_general is
# not exact).
f64_reduce_dots = False


# In-progress Krylov-basis records larger than this are skipped (the
# completion/stage records still save): a restart-boundary save of a
# (ncv+1, N) basis pulls the whole buffer to the host and writes it, which
# stalls the solver for seconds per GB. Crash cost without the record =
# redoing one solver stage from its warm start.
ckpt_max_bytes = 512 * 1024 * 1024

# When set, solvers append per-restart convergence lines here (the analog of
# the reference's log_Lanczos_<purpose>.txt / log_CG.txt, SURVEY §5.5).
solver_log_dir = None

# Label spaces up to this size get an O(1) direct position-lookup table on
# device; larger spaces fall back to binary search / Lin tables.
direct_lookup_max = 1 << 26


def initialize(enable_checkpoint: bool = False, quiet: bool = False,
               mixed_precision: bool | None = None) -> None:
    """Set up the library: x64, checkpoint flag, environment banner.

    JAX analog of ``qbasis::initialize`` (reference:
    src/miscellaneous.cc:49-112) — instead of CPUID/MKL/OpenMP reporting we
    report the JAX backend and device inventory.
    """
    global enable_ckpt
    enable_ckpt = bool(enable_checkpoint)
    if mixed_precision is not None:
        globals()["mixed_precision"] = bool(mixed_precision)
    jax.config.update("jax_enable_x64", True)
    if quiet:
        return
    print("=" * 64)
    print("quantum_basis_tpu")
    print(f"host       : {platform.node()}")
    print(f"jax        : {jax.__version__}")
    try:
        devs = jax.devices()
        print(f"backend    : {devs[0].platform} x{len(devs)}")
    except Exception as exc:  # pragma: no cover - device discovery is env-specific
        print(f"backend    : unavailable ({exc})")
    print(f"x64        : {jax.config.jax_enable_x64}")
    print(f"checkpoint : {'enabled -> ' + ckpt_dir if enable_ckpt else 'disabled'}")
    print(f"pid        : {os.getpid()}")
    print("=" * 64)


# ---------------------------------------------------------------- program keys
# Monotonic ids for solver program sharing (solvers key their jitted-ops
# caches on an operator template's ``program_key``; a recycled id() could
# alias two templates, so keys come from this counter instead).
import itertools as _itertools

_program_key_counter = _itertools.count(1)


def next_program_key() -> int:
    return next(_program_key_counter)


# KPM dynamics on momentum sectors: above this full label-space size the
# Chebyshev recurrence runs on the sector-dimension ELL instead of the
# projected full-space engine. Sized for a 16 GB device: the fused f64
# full-space recurrence program at N = 2^24 complex does not fit there.
# Not yet re-derived for an 80 GB card (ROADMAP Reach 8).
kpm_fullspace_max_N = 1 << 23

# Chunk length for the full-space KPM recurrence: programs of <= this many
# scan steps with a device-resident carry between calls (the moments are
# bit-identical to one fused program, whose temporaries grow with the step
# count). None = single fused program.
kpm_fullspace_chunk = 64
