"""Sharding utilities: place a LOBPCG problem onto a row mesh.

Design (SURVEY.md §2.6): operators and tall blocks are 1-D row-partitioned
over the mesh; XLA's SPMD partitioner then turns

- `S^H B S` Gram contractions into local GEMMs + `psum`,
- stencil operator applications into local stencils + halo
  `collective-permute`s,
- the k x k projected eigensolves into replicated compute,

with no solver-code changes: the sharding is carried by the input arrays.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lobpcg_tpu.parallel.mesh import ROWS


def _shardable(leaf, n_shards: int) -> bool:
    return (
        hasattr(leaf, "ndim")
        and leaf.ndim >= 1
        and leaf.shape[0] % n_shards == 0
        and leaf.shape[0] >= n_shards
    )


def shard_array(x: jax.Array, mesh: Mesh, axis: str = ROWS) -> jax.Array:
    """Shard dim 0 of an array over the mesh (replicate if indivisible)."""
    n_shards = mesh.shape[axis]
    if _shardable(x, n_shards):
        spec = P(axis, *([None] * (x.ndim - 1)))
    else:
        spec = P()
    return jax.device_put(x, NamedSharding(mesh, spec))


def shard_operator(op, mesh: Mesh, axis: str = ROWS):
    """Row-shard every array leaf of an operator pytree.

    Dense [n, n] matrices become row panels; diagonal vectors become row
    segments; scalars replicate.  Operators whose matmat mixes rows
    across shards (e.g. BlockAntiDiagOperator's half-swap) still compute
    correctly — XLA inserts the required collectives.
    """
    return jax.tree_util.tree_map(
        lambda leaf: shard_array(jnp.asarray(leaf), mesh, axis), op
    )


def shard_problem(
    mesh: Mesh,
    A,
    X0: Optional[jax.Array] = None,
    B=None,
    T=None,
    axis: str = ROWS,
    spmd_stencil: bool = True,
):
    """Place (A, X0, B, T) on the mesh with row partitioning.

    With `spmd_stencil` (default), stencil operators in the trees are
    swapped for the explicit shard_map halo-exchange implementation
    (parallel.spmd_stencil) instead of relying on the SPMD partitioner
    to derive halos from pad/slice patterns.
    """
    from lobpcg_tpu.parallel.spmd_stencil import use_spmd_stencils

    def prep(op):
        if op is None:
            return None
        if spmd_stencil:
            op = use_spmd_stencils(op, mesh, axis)
        return shard_operator(op, mesh, axis)

    A = prep(A)
    B = prep(B)
    T = prep(T)
    X0 = shard_array(X0, mesh, axis) if X0 is not None else None
    return A, X0, B, T
