"""Multi-host distribution: process-group init + global meshes.

The reference scales across hosts with MPI (SURVEY §2.2 / §5.8: boost::mpi
broadcast of basis shards, src/model.cc row partitioning). The JAX
equivalent is its multi-controller runtime:

1. every host process calls :func:`init_distributed` once at startup;
2. meshes are built over ``jax.devices()`` — which after initialization
   lists ALL devices of every process, not just the local ones;
3. arrays are laid out with ``jax.sharding.NamedSharding`` over that global
   mesh, and jit/GSPMD inserts the collectives (psum/all-gather/ppermute)
   — no hand-written sends, no MPI ranks in user code.

Both sharded engines are multi-host-clean by construction:

- :class:`~quantum_basis_tpu.parallel.fullspace_sharded.FullSpaceSharded`
  is pure GSPMD (sharding annotations only; rolls lower to collective
  permutes) — the production multi-host path;
- :class:`~quantum_basis_tpu.parallel.apply_sharded.MatvecSharded` uses
  shard_map + all_gather over the same mesh and works unchanged, paying an
  all-gather of the source vector per apply.

On a single process (or under ``xla_force_host_platform_device_count``)
:func:`init_distributed` is a no-op fallback, so drivers can call it
unconditionally.
"""

from __future__ import annotations

import os

_initialized = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None) -> bool:
    """Initialize the JAX multi-controller runtime (idempotent).

    With no arguments, relies on auto-detection: under SLURM/OpenMPI
    launchers ``jax.distributed.initialize()`` resolves the coordinator and
    process ids from the environment. Explicit
    arguments override (COORDINATOR host:port, process count, this
    process's id). Returns True when a multi-process group is active,
    False on the single-process fallback.
    """
    global _initialized
    import jax

    if _initialized:
        return jax.process_count() > 1

    explicit = coordinator_address is not None or num_processes is not None
    env_hint = any(k in os.environ for k in (
        "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
        "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE"))
    if explicit or env_hint:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                local_device_ids=local_device_ids)
        except Exception as e:  # pragma: no cover - environment dependent
            if explicit:
                raise
            # Strong multi-host markers mean this process is PART of a
            # multi-process job: falling back would silently run N
            # independent single-host computations. Refuse. (Weak hints like
            # SLURM_JOB_ID on a single-node allocation still fall back with
            # a warning.)
            strong = ("JAX_COORDINATOR_ADDRESS" in os.environ
                      or int(os.environ.get("OMPI_COMM_WORLD_SIZE", "1")) > 1)
            if strong:
                raise RuntimeError(
                    "jax.distributed.initialize failed in a multi-host "
                    "environment; init_distributed() must run before any "
                    f"other JAX API call (original error: {e})") from e
            import warnings

            warnings.warn(f"jax.distributed.initialize failed ({e}); "
                          "continuing single-process")
    _initialized = True
    return jax.process_count() > 1


def process_info():
    """(process_id, process_count, local_devices, global_devices)."""
    import jax

    return (jax.process_index(), jax.process_count(),
            len(jax.local_devices()), len(jax.devices()))


def global_basis_mesh(axis: str = "b"):
    """1-D mesh over ALL devices of the (possibly multi-host) runtime.

    Every process must build the identical mesh (same device order) —
    guaranteed here by using ``jax.devices()``, whose order is globally
    consistent after :func:`init_distributed`.
    """
    import jax
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def shard_array_over_mesh(x, mesh, axis: str = "b"):
    """Shard a host numpy array over the mesh's first axis, multi-host safe:
    each process provides only its addressable shards
    (``jax.make_array_from_callback``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))

    def cb(idx):
        return jnp.asarray(x[idx])

    return jax.make_array_from_callback(x.shape, sharding, cb)
