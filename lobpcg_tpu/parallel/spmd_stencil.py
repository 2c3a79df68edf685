"""Explicit halo-exchange stencil SpMM under shard_map.

SURVEY.md §2.6 plan of record: row-partition the operator and the tall
blocks over the mesh; stencil application needs only neighbor-row
exchange, done here with two `ppermute`s (one row up, one row down)
overlapped by XLA's latency-hiding scheduler with the local stencil
compute.  This is the deterministic, collective-explicit
alternative to letting the SPMD partitioner derive halos from pad/slice
patterns.

Segment boundaries (the BdG block structure A = diag(K, ..., K),
`tests/test_ilobpcg.c:28-52`) must not couple: when a shard boundary
coincides with a segment boundary the incoming halo row is zeroed, and
segment boundaries interior to a shard are handled by the local
shift-add masking.  Requires the per-shard row count to divide the
segment length (guaranteed when n % (segments * n_devices) == 0).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from lobpcg_tpu.parallel.mesh import ROWS


def stencil_matmat_spmd(
    X: jax.Array,
    scale,
    mesh: Mesh,
    *,
    num_segments: int = 1,
    axis: str = ROWS,
) -> jax.Array:
    """Y = scale * tridiag[-1, 2, -1] X per row segment, X row-sharded."""
    n, k = X.shape
    nd = mesh.shape[axis]
    if n % (num_segments * nd):
        raise ValueError(
            f"n={n} must divide into {num_segments} segments x {nd} shards"
        )
    seg = n // num_segments
    local_rows = n // nd
    # Segment boundaries must align with the shard grid: either every
    # shard holds a whole number of segments (local_rows % seg == 0, the
    # interior masking below handles them) or every segment spans a whole
    # number of shards (seg % local_rows == 0, the halo zeroing handles
    # them).  Anything else puts a boundary strictly inside a shard with
    # no masking and silently couples segments.
    if (seg % local_rows) and (local_rows % seg):
        raise ValueError(
            f"segment length {seg} and shard rows {local_rows} must divide "
            "one another (segment boundaries would fall inside a shard)"
        )

    def local(xs):
        # xs: [local_rows, k] on this shard.
        idx = jax.lax.axis_index(axis)

        # Halo exchange: my top row -> previous shard's bottom halo; my
        # bottom row -> next shard's top halo.  ppermute fills shards
        # with no source (ends of the chain) with zeros — exactly the
        # Dirichlet boundary.
        fwd = [(i, i + 1) for i in range(nd - 1)]
        bwd = [(i + 1, i) for i in range(nd - 1)]
        halo_up = jax.lax.ppermute(xs[-1:], axis, perm=fwd)  # from idx-1
        halo_dn = jax.lax.ppermute(xs[:1], axis, perm=bwd)  # from idx+1

        # Zero halos at segment boundaries: the first row of this shard
        # starts a segment iff (idx * local_rows) % seg == 0, and the row
        # after its last ends one iff ((idx + 1) * local_rows) % seg == 0.
        starts_seg = (idx * local_rows) % seg == 0
        ends_seg = ((idx + 1) * local_rows) % seg == 0
        halo_up = jnp.where(starts_seg, jnp.zeros_like(halo_up), halo_up)
        halo_dn = jnp.where(ends_seg, jnp.zeros_like(halo_dn), halo_dn)

        down = jnp.concatenate([halo_up, xs[:-1]], axis=0)  # x_{i-1}
        up = jnp.concatenate([xs[1:], halo_dn], axis=0)  # x_{i+1}

        # Interior segment boundaries (segments smaller than a shard):
        # zero the neighbor contribution across them.
        if seg < local_rows:
            r0 = idx * local_rows
            rows = r0 + jax.lax.broadcasted_iota(
                jnp.int32, (local_rows, 1), 0
            )
            first_of_seg = (rows % seg) == 0
            last_of_seg = (rows % seg) == seg - 1
            down = jnp.where(first_of_seg, jnp.zeros_like(down), down)
            up = jnp.where(last_of_seg, jnp.zeros_like(up), up)

        return scale * (2.0 * xs - up - down)

    return shard_map(
        local,
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=P(axis, None),
    )(X)


def _rewrite(op, mesh: Mesh, axis: str):
    """Recursively replace Laplacian1D with the explicit shard_map halo
    exchange (other operators keep their partitioner-derived halos)."""
    import dataclasses

    from lobpcg_tpu.operators.linop import Laplacian1D, LinearOperator

    if isinstance(op, Laplacian1D):
        return SpmdLaplacian1D(
            scale=op.scale, n=op.n, segments=op.segments, mesh=mesh,
            axis=axis,
        )
    # Recurse into operator-valued fields (Sum/Composed/BlockDiag/...).
    if dataclasses.is_dataclass(op):
        changes = {}
        for f in dataclasses.fields(op):
            v = getattr(op, f.name)
            if isinstance(v, LinearOperator):
                changes[f.name] = _rewrite(v, mesh, axis)
        if changes:
            return dataclasses.replace(op, **changes)
    return op


def use_spmd_stencils(op, mesh: Mesh, axis: str = ROWS):
    """Return a copy of the operator tree with every Laplacian1D swapped
    for the explicit halo-exchange shard_map implementation."""
    return _rewrite(op, mesh, axis)


from lobpcg_tpu.operators.linop import LinearOperator, operator  # noqa: E402


@operator(
    data_fields=("scale",),
    meta_fields=("n", "segments", "mesh", "axis"),
)
class SpmdLaplacian1D(LinearOperator):
    """Laplacian1D with explicit shard_map halo exchange over `mesh`.

    Produced by `use_spmd_stencils` / `shard_problem(..., spmd_stencil=True)`;
    behaves identically to Laplacian1D but lowers to local compute plus
    two `ppermute`s instead of partitioner-derived halos.
    """

    scale: jax.Array
    n: int = 0
    segments: int = 1
    mesh: Mesh = None
    axis: str = ROWS

    def matmat(self, X):
        return stencil_matmat_spmd(
            X, self.scale, self.mesh, num_segments=self.segments,
            axis=self.axis,
        )

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.scale.dtype
