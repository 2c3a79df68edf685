"""Row-sharded block-ELL (BSR) SpMM with neighbor halo exchange.

SURVEY.md §2.6: the distributed operator application is a local SpMM
plus remote-row exchange.  For banded matrices (RCM reordering via the
native library keeps general sparse matrices banded,
`native/sparse_prep.cpp`), every remote block row a shard needs lives
within `halo` block rows of its boundary, so the exchange is two
`ppermute`s of fixed-width edge bands — no all-gather, no all-to-all.

Host-side planning (here, NumPy on the ELL arrays):
- block-row partition: nb block rows split evenly over the mesh,
- halo width: max reach |block_col - block_row| over all stored blocks
  (must be < block rows per shard; RCM-reorder first if it is not).

Device side (`shard_map`): exchange edge bands, concatenate
[halo_up | X_local | halo_dn], remap the global block columns into that
extended local frame, and run the gather + einsum SpMM on it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lobpcg_tpu.operators.linop import LinearOperator, operator
from lobpcg_tpu.operators.sparse import bsr_matmat_reference
from lobpcg_tpu.parallel.mesh import ROWS


def _ell_halo_width(block_cols: np.ndarray, blocks: np.ndarray) -> int:
    """Max |block_col - block_row| over stored (non-padding) blocks."""
    nb, R = block_cols.shape
    rows = np.arange(nb)[:, None]
    nonpad = np.abs(blocks).reshape(nb, R, -1).sum(-1) > 0
    reach = np.abs(block_cols - rows) * nonpad
    return int(reach.max()) if nb else 0


@operator(
    data_fields=("block_cols", "blocks"),
    meta_fields=("n", "bs", "halo", "mesh", "axis"),
)
class ShardedBSROperator(LinearOperator):
    """Block-ELL sparse operator, block-row sharded with halo exchange.

    Build with `ShardedBSROperator.shard(op, mesh)` from a BSROperator.
    """

    block_cols: jax.Array  # [nb, R] i32, global block-column indices
    blocks: jax.Array  # [nb, R, bs, bs]
    n: int = 0
    bs: int = 0
    halo: int = 0
    mesh: Mesh = None
    axis: str = ROWS

    @classmethod
    def shard(cls, op, mesh: Mesh, axis: str = ROWS) -> "ShardedBSROperator":
        """Plan and place a BSROperator onto the mesh."""
        cols = np.asarray(op.block_cols)
        blocks = np.asarray(op.blocks)
        nb, R, bs, _ = blocks.shape
        nd = mesh.shape[axis]
        if nb % nd:
            raise ValueError(f"nb={nb} block rows not divisible by {nd}")
        halo = _ell_halo_width(cols, blocks)
        if halo >= nb // nd:
            raise ValueError(
                f"block bandwidth {halo} >= {nb // nd} block rows/shard; "
                "RCM-reorder the matrix (utils.native.rcm_order) or use "
                "fewer shards"
            )
        return cls(
            block_cols=jax.device_put(
                jnp.asarray(cols, jnp.int32),
                NamedSharding(mesh, P(axis, None)),
            ),
            blocks=jax.device_put(
                jnp.asarray(blocks),
                NamedSharding(mesh, P(axis, None, None, None)),
            ),
            n=op.n,
            bs=bs,
            halo=halo,
            mesh=mesh,
            axis=axis,
        )

    def matmat(self, X: jax.Array) -> jax.Array:
        nb = self.n // self.bs
        nd = self.mesh.shape[self.axis]
        nb_loc = nb // nd
        H = self.halo
        bs = self.bs
        axis = self.axis

        def local(cols, blocks, xs):
            # cols: [nb_loc, R]; blocks: [nb_loc, R, bs, bs];
            # xs: [nb_loc * bs, k]
            idx = jax.lax.axis_index(axis)
            if H > 0:
                hrows = H * bs
                fwd = [(i, i + 1) for i in range(nd - 1)]
                bwd = [(i + 1, i) for i in range(nd - 1)]
                halo_up = jax.lax.ppermute(xs[-hrows:], axis, perm=fwd)
                halo_dn = jax.lax.ppermute(xs[:hrows], axis, perm=bwd)
                x_ext = jnp.concatenate([halo_up, xs, halo_dn], axis=0)
            else:
                x_ext = xs
            # Remap global block cols into the extended local frame;
            # padding blocks are zero so a clamped index is harmless.
            loc = jnp.clip(
                cols - (idx * nb_loc - H), 0, nb_loc + 2 * H - 1
            )
            return bsr_matmat_reference(loc, blocks, x_ext)

        return shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(axis, None), P(axis, None, None, None),
                      P(axis, None)),
            out_specs=P(axis, None),
        )(self.block_cols, self.blocks, X)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.blocks.dtype
