"""Materialized sparse operators: block-ELL SpMM.

Covers the reference's "sparse operator through the LinearOperator
interface" capability (`README.md:14`, dense/sparse/matrix-free all flow
through matvec): the host-side native library (native/sparse_prep.cpp
via utils.native) assembles COO -> CSR -> BSR, optionally RCM-reorders
for bandwidth, pads to ELL, and the device runs a gather + batched
block contraction (`bsr_matmat_reference`).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from lobpcg_tpu.operators.linop import LinearOperator, operator
from lobpcg_tpu.utils import native


def _bsr_to_ell(bip: np.ndarray, bix: np.ndarray, bv: np.ndarray):
    """Pad BSR rows to uniform width R (ELL).  Padding blocks are zero
    with block-column 0."""
    nb = len(bip) - 1
    counts = np.diff(bip)
    R = max(1, int(counts.max()))
    bs = bv.shape[-1]
    cols = np.zeros((nb, R), np.int32)
    vals = np.zeros((nb, R, bs, bs), bv.dtype)
    for i in range(nb):
        c = int(counts[i])
        cols[i, :c] = bix[bip[i] : bip[i + 1]]
        vals[i, :c] = bv[bip[i] : bip[i + 1]]
    return cols, vals


def bsr_matmat_reference(
    block_cols: jax.Array, blocks: jax.Array, X: jax.Array
) -> jax.Array:
    """Block-ELL SpMM Y = A @ X: gather the block rows of X each stored
    block touches, then one batched [bs, bs] x [bs, k] contraction.
    X may hold more block rows than A (a halo-extended shard frame);
    Y has one block row per row of ``block_cols``.

    HIGHEST precision: an f32 product on a GPU would otherwise be
    allowed to run in TF32 (about three decimal digits).
    """
    nb, R, bs, _ = blocks.shape
    k = X.shape[1]
    Xb = X.reshape(X.shape[0] // bs, bs, k)
    Xg = Xb[block_cols]  # [nb, R, bs, k]
    Y = jnp.einsum(
        "nrij,nrjk->nik", blocks, Xg,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=X.dtype,
    )
    return Y.reshape(nb * bs, k)


@operator(data_fields=("block_cols", "blocks"), meta_fields=("n",))
class BSROperator(LinearOperator):
    """Block-ELL sparse operator.

    block_cols: [nb, R] int32 block-column indices (padding -> 0)
    blocks:     [nb, R, bs, bs] dense blocks (padding -> zeros)
    """

    block_cols: jax.Array
    blocks: jax.Array
    n: int = 0

    def matmat(self, X):
        return bsr_matmat_reference(self.block_cols, self.blocks, X)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.blocks.dtype

    # -- constructors -------------------------------------------------

    @classmethod
    def from_csr(cls, indptr, indices, vals, *, block_size: int,
                 dtype=jnp.float32) -> "BSROperator":
        n = len(indptr) - 1
        if n % block_size:
            raise ValueError(
                f"n={n} not divisible by block_size={block_size}"
            )
        bip, bix, bv = native.csr_to_bsr(
            n, block_size, np.asarray(indptr), np.asarray(indices),
            np.asarray(vals, np.float64),
        )
        cols, blocks = _bsr_to_ell(bip, bix, bv)
        return cls(
            block_cols=jnp.asarray(cols),
            blocks=jnp.asarray(blocks, dtype),
            n=n,
        )

    @classmethod
    def from_coo(cls, n, rows, cols, vals, *, block_size: int,
                 dtype=jnp.float32) -> "BSROperator":
        indptr, indices, v = native.coo_to_csr(
            n, np.asarray(rows), np.asarray(cols),
            np.asarray(vals, np.float64),
        )
        return cls.from_csr(indptr, indices, v, block_size=block_size,
                            dtype=dtype)

    @classmethod
    def from_dense(cls, A, *, block_size: int, dtype=jnp.float32,
                   tol: float = 0.0) -> "BSROperator":
        A = np.asarray(A)
        rows, cols = np.nonzero(np.abs(A) > tol)
        return cls.from_coo(
            A.shape[0], rows, cols, A[rows, cols], block_size=block_size,
            dtype=dtype,
        )


def laplacian_3d_csr(nx: int, ny: int, nz: int, h: float = None):
    """7-point 3-D Dirichlet Laplacian as CSR (host assembly) — the
    BASELINE.json config "3D Laplacian (stencil CSR)".  Returns
    (indptr, indices, vals) with eigenvalues sum of per-axis (k pi)^2
    terms under Dirichlet BCs."""
    import scipy.sparse as sp

    if h is None:
        h = 1.0 / (max(nx, ny, nz) + 1)

    def lap1d(m):
        return sp.diags(
            [-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)],
            [-1, 0, 1],
        )

    Ix, Iy, Iz = (sp.identity(m) for m in (nx, ny, nz))
    L = (
        sp.kron(sp.kron(lap1d(nx), Iy), Iz)
        + sp.kron(sp.kron(Ix, lap1d(ny)), Iz)
        + sp.kron(sp.kron(Ix, Iy), lap1d(nz))
    ) / (h * h)
    L = L.tocsr()
    L.sort_indices()
    return L.indptr.astype(np.int64), L.indices.astype(np.int64), L.data
