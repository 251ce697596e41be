"""Distributed sample sort over a device mesh.

The device replacement for the reference's thread-parallel host sort
(``__gnu_parallel::sort`` under ``use_gnu_parallel_sort``,
src/basis.cc:8-12,1127-1133) at scales where the label array is sharded
over devices/hosts and no single host should hold it. Classic sample-sort
over XLA collectives:

1. local sort per shard (``jax.lax.sort``);
2. every shard contributes P-1 evenly-spaced samples; the gathered sample
   matrix yields global splitters (all shards compute them identically —
   no designated root);
3. each element is binned by splitter (``searchsorted``) and exchanged via
   ``all_to_all`` in fixed-capacity buckets (XLA collectives are
   static-shaped, so buckets are padded to ``capacity`` and carry a count;
   overflow is reported per shard rather than silently truncated);
4. each shard sorts its received buckets; the result is globally sorted
   across shards in mesh-axis order with per-shard valid counts.

The capacity bound is the standard sample-sort guarantee: with regular
sampling, no destination receives more than ~2n/P elements for mildly
skewed data; callers pass a larger ``slack`` for adversarial inputs (the
overflow flag makes the failure loud, matching this framework's
hard-fail-over-silent-wrong policy).
"""

from __future__ import annotations

import numpy as np

_PAD = np.int64(2**62)  # sorts above every real label


def sample_sort_sharded(x_shards: np.ndarray, mesh, axis: str = "b",
                        slack: float = 2.5):
    """Sort a (P, n_local) int64 array globally over the mesh axis.

    Input row p is shard p's (unsorted) data; returns ``(y_shards,
    counts, overflow)`` where ``y_shards`` is (P, capacity) int64 padded
    with 2^62, ``counts[p]`` is the number of valid elements in row p, the
    concatenation of valid prefixes is the globally sorted array, and
    ``overflow`` is True if any bucket exceeded capacity (resort with more
    slack). Runs under ``shard_map``; the exchange is one
    ``all_to_all``.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P_

    P = int(mesh.shape[axis])
    x_shards = np.asarray(x_shards, dtype=np.int64)
    assert x_shards.shape[0] == P
    n_local = int(x_shards.shape[1])
    capacity = int(np.ceil(slack * n_local))
    # lane-friendly capacity
    capacity = -(-capacity // 128) * 128

    shard_map = jax.shard_map

    def body(xb):
        x = xb[0]  # (n_local,) this shard's data
        x = jax.lax.sort(x)
        # regular sampling: P-1 splitter candidates per shard
        idx = ((jnp.arange(1, P) * n_local) // P).astype(jnp.int32)
        samples = x[idx]  # (P-1,)
        allsmp = jax.lax.all_gather(samples, axis)  # (P, P-1)
        flat = jax.lax.sort(allsmp.reshape(-1))
        # global splitters: every P-1'th of the P*(P-1) gathered samples
        spl = flat[((jnp.arange(1, P) * (P - 1)) - 1).astype(jnp.int32)]
        dest = jnp.searchsorted(spl, x, side="right").astype(jnp.int32)
        # pack into fixed buckets: position of each element in its bucket
        onehot = dest[None, :] == jnp.arange(P)[:, None]      # (P, n)
        pos = jnp.cumsum(onehot, axis=1) - 1                  # (P, n)
        counts = jnp.sum(onehot, axis=1)                      # (P,)
        buckets = jnp.full((P, capacity), _PAD, dtype=jnp.int64)
        # scatter each element into (dest, pos[dest])
        p_of = jnp.take_along_axis(pos, dest[None, :], axis=0)[0]
        ok = p_of < capacity
        buckets = buckets.at[dest, jnp.where(ok, p_of, capacity - 1)].set(
            jnp.where(ok, x, _PAD))
        over = jnp.any(counts > capacity)
        # exchange: shard p sends buckets[q] to shard q
        recv = jax.lax.all_to_all(buckets, axis, split_axis=0,
                                  concat_axis=0, tiled=False)
        recv_counts = jax.lax.all_to_all(
            jnp.minimum(counts, capacity)[:, None], axis,
            split_axis=0, concat_axis=0, tiled=False).reshape(-1)
        merged = jax.lax.sort(recv.reshape(-1))[:capacity * P]
        total = jnp.sum(recv_counts)
        # receive-side overflow: a shard may receive up to P buckets each
        # <= capacity (e.g. heavily duplicated keys all routing here), but
        # only `capacity` slots survive the truncation below — that must
        # trip the retry/raise path, not silently drop elements.
        over = over | (total > capacity)
        over_any = jax.lax.pmax(over, axis)
        return (merged[None, :capacity], total[None], over_any[None])

    sh = NamedSharding(mesh, P_(axis))
    xb = jax.device_put(jnp.asarray(x_shards), sh)
    f = shard_map(body, mesh=mesh, in_specs=P_(axis),
                  out_specs=(P_(axis), P_(axis), P_(axis)))
    y, counts, over = jax.jit(f)(xb)
    y = np.asarray(y)
    counts = np.asarray(counts)
    over = bool(np.any(np.asarray(over)))
    return y, counts, over


def sample_sort(values: np.ndarray, mesh, axis: str = "b",
                slack: float = 2.5) -> np.ndarray:
    """Convenience host API: sort a flat int64 array via the mesh; returns
    the sorted numpy array. Retries once with doubled slack on overflow."""
    P = int(mesh.shape[axis])
    values = np.asarray(values, dtype=np.int64)
    n = values.size
    n_local = -(-n // P)
    pad = n_local * P - n
    xs = np.concatenate([values, np.full(pad, _PAD, dtype=np.int64)])
    xs = xs.reshape(P, n_local)
    y, counts, over = sample_sort_sharded(xs, mesh, axis, slack)
    if over:
        y, counts, over = sample_sort_sharded(xs, mesh, axis, 2 * slack)
        if over:
            raise RuntimeError("sample_sort bucket overflow; raise slack")
    parts = [y[p, : int(counts[p])] for p in range(P)]
    out = np.concatenate(parts) if parts else np.empty(0, np.int64)
    return out[out < _PAD][:n]
