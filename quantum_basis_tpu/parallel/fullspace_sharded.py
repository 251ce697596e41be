"""Sharded full-space roll engine: multi-chip apply with zero custom comms.

The full-space apply (ops/apply_fullspace.py) is built from dense regular
primitives only — iota, elementwise masks, rolls, adds. Under a 1-D mesh
sharding of the label axis, GSPMD partitions every one of them natively:
rolls become local rolls + a boundary collective-permute, masks
are computed from the sharded iota, and reductions in the enclosing solver
are psums. No gather/scatter, no halo bookkeeping — the communication per
apply is one |delta|-sized boundary slab per roll pass, moved over the
fastest interconnect by the compiler.

This is the scaling path for label spaces beyond one device's memory: a
vector of 2^30 f64 (8.6 GB) shards to 2.1 GB per device over four.
"""

from __future__ import annotations

import numpy as np


class FullSpaceSharded:
    """Wrap a FullSpaceOp with mesh-sharded inputs/outputs.

    Same (params, apply) protocol as every other matvec; vectors are
    expected (and produced) with a ``NamedSharding(mesh, P(axis))`` layout.
    """

    def __init__(self, fs, mesh, axis: str = "b"):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        self.fs = fs
        self.mesh = mesh
        self.axis = axis
        self.n = fs.n
        self.is_complex = fs.is_complex
        self.sharding = NamedSharding(mesh, P(axis))
        if fs.N % mesh.devices.size != 0:
            raise ValueError("label space must divide the mesh size "
                             f"({fs.N} % {mesh.devices.size} != 0)")
        self.diag_full = jax.device_put(fs.diag_full, self.sharding)
        self.mask = (jax.device_put(fs.mask, self.sharding)
                     if fs.mask is not None else None)

        out_shardings = (self.sharding,
                         self.sharding if self.is_complex else None)
        self._jit_apply = jax.jit(
            fs.apply,
            in_shardings=((self.sharding,),
                          (self.sharding,
                           self.sharding if self.is_complex else None)),
            out_shardings=out_shardings,
        )

    @property
    def params(self):
        return (self.diag_full,)

    def apply(self, params, x):
        # traceable path (used inside larger jits): same math, GSPMD
        # propagates the shardings from the operands
        return self.fs.apply(params, x)

    def __call__(self, x):
        import jax

        xr, xi = x
        xr = jax.device_put(xr, self.sharding)
        if xi is not None:
            xi = jax.device_put(xi, self.sharding)
        elif self.is_complex:
            import jax.numpy as jnp

            xi = jax.device_put(jnp.zeros_like(xr), self.sharding)
        return self._jit_apply(self.params, (xr, xi))

    # sector interop delegates to the wrapped op
    def to_full(self, x_sector):
        import jax

        out = self.fs.to_full(x_sector)
        return tuple(None if p is None else jax.device_put(p, self.sharding)
                     for p in out)

    def to_sector(self, x_full):
        return self.fs.to_sector(x_full)
