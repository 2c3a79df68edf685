"""N-dimensional Dirichlet Laplacian stencils (2-D / 3-D).

The reference's sparse flagship is the "3D Laplacian (stencil CSR)"
(BASELINE.json config 1), which it would funnel through the generic
matvec callback.  The fast path for structured grids skips the sparse
machinery entirely: a 7-point (3-D) or 5-point (2-D) stencil is a
handful of shifted adds on a [nx, ny, nz, k] view, which XLA fuses into
one pass over X.  Under row sharding of the flattened leading axis the
leading dimension's neighbor exchange lowers to collective-permutes
while the inner dimensions stay local.

Matches `operators.sparse.laplacian_3d_csr` numerically (same h and
Dirichlet BCs), without materializing any sparse structure.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from lobpcg_tpu.operators.linop import LinearOperator, operator


def _lap_along(Xg: jax.Array, axis: int) -> jax.Array:
    """tridiag[-1, 2, -1] along `axis` of a grid-shaped array (Dirichlet)."""
    pad = [(0, 0)] * Xg.ndim
    pad[axis] = (1, 1)
    Xp = jnp.pad(Xg, pad)

    def sl(lo, hi):
        idx = [slice(None)] * Xg.ndim
        idx[axis] = slice(lo, hi)
        return tuple(idx)

    n = Xg.shape[axis]
    return 2.0 * Xg - Xp[sl(2, n + 2)] - Xp[sl(0, n)]


@operator(data_fields=("scale",), meta_fields=("grid",))
class LaplacianND(LinearOperator):
    """Dirichlet Laplacian on a structured grid, flattened C-order.

    grid: (nx,) / (nx, ny) / (nx, ny, nz); n = prod(grid).
    scale: 1/h^2 (uniform spacing).  Eigenvalues are sums of per-axis
    4*scale*sin^2(k*pi/(2*(n_axis+1))) terms — the same oracle as
    `laplacian_3d_csr`.
    """

    scale: jax.Array
    grid: tuple = ()

    def matmat(self, X):
        n, k = X.shape
        Xg = X.reshape(*self.grid, k)
        Y = sum(_lap_along(Xg, ax) for ax in range(len(self.grid)))
        return (self.scale * Y).reshape(n, k)

    @property
    def shape(self):
        n = int(np.prod(self.grid))
        return (n, n)

    @property
    def dtype(self):
        return self.scale.dtype


def laplacian_nd_eigs(grid, scale: float, count: int) -> np.ndarray:
    """The `count` smallest exact eigenvalues of LaplacianND."""
    per_axis = [
        4.0 * scale * np.sin(np.arange(1, n + 1) * np.pi / (2 * (n + 1))) ** 2
        for n in grid
    ]
    acc = per_axis[0]
    for a in per_axis[1:]:
        acc = (acc[:, None] + a[None, :]).ravel()
        acc = np.sort(acc)[: max(count * 4, 64)]  # keep the low tail only
    return np.sort(acc)[:count]
