"""Sparse operator (BSR/ELL) and native preprocessing tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from lobpcg_tpu.operators.sparse import BSROperator, laplacian_3d_csr
from lobpcg_tpu.utils import native


def _rand_sparse(n, density, seed):
    rng = np.random.RandomState(seed)
    M = sp.random(n, n, density=density, random_state=rng, format="csr")
    M = M + M.T
    M.sort_indices()
    return M


def test_coo_to_csr_matches_scipy():
    rng = np.random.RandomState(1)
    n, nnz = 100, 800
    rows, cols = rng.randint(0, n, nnz), rng.randint(0, n, nnz)
    vals = rng.randn(nnz)
    indptr, indices, v = native.coo_to_csr(n, rows, cols, vals)
    ref = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    np.testing.assert_array_equal(indptr, ref.indptr)
    np.testing.assert_array_equal(indices, ref.indices)
    np.testing.assert_allclose(v, ref.data)


def test_csr_to_bsr_matches_scipy():
    M = _rand_sparse(128, 0.05, 2)
    bip, bix, bv = native.csr_to_bsr(
        128, 8, M.indptr, M.indices, M.data
    )
    ref = M.tobsr((8, 8))
    ref.sort_indices()
    np.testing.assert_array_equal(bip, ref.indptr)
    np.testing.assert_array_equal(bix, ref.indices)
    np.testing.assert_allclose(bv, ref.data)


def test_rcm_reduces_bandwidth():
    M = _rand_sparse(200, 0.02, 3)
    perm = native.rcm_order(200, M.indptr, M.indices)
    assert sorted(perm) == list(range(200))
    Mp = M[perm][:, perm].tocoo()
    bw_after = np.abs(Mp.row - Mp.col).max()
    Mo = M.tocoo()
    bw_before = np.abs(Mo.row - Mo.col).max()
    assert bw_after <= bw_before


def test_partition_and_halo():
    ip, ix, v = laplacian_3d_csr(8, 8, 8)
    n = 512
    off = native.partition_rows(n, ip, 4)
    assert off[0] == 0 and off[-1] == n
    nnz_per = [ip[off[p + 1]] - ip[off[p]] for p in range(4)]
    assert max(nnz_per) / max(1, min(nnz_per)) < 1.5  # balanced
    h = native.halo_rows(int(off[1]), int(off[2]), ip, ix)
    assert len(h) > 0
    assert np.all((h < off[1]) | (h >= off[2]))


def test_bsr_operator_matches_dense():
    M = _rand_sparse(96, 0.08, 4)
    A = M.toarray()
    op = BSROperator.from_dense(A, block_size=8, dtype=jnp.float64)
    X = jnp.asarray(np.random.RandomState(5).randn(96, 7))
    Y = op.matmat(X)
    np.testing.assert_allclose(np.asarray(Y), A @ np.asarray(X), atol=1e-10)


def test_bsr_in_lobpcg_solver():
    """3-D Laplacian (stencil CSR) through BSR inside the solver — the
    BASELINE.json config 1 workload."""
    from lobpcg_tpu import lobpcg
    from tests.fixtures import rand_block

    nx = 8
    ip, ix, v = laplacian_3d_csr(nx, nx, nx)
    n = nx**3
    op = BSROperator.from_csr(ip, ix, v, block_size=8, dtype=jnp.float64)
    X0 = rand_block(301, n, 6, jnp.float64)
    r = lobpcg(op, X0, nev=3, size_sub=6, tol=1e-6, max_iter=300)
    assert int(r.converged) == 3
    # oracle: h = 1/(nx+1); eigenvalues = sum of 1-D Dirichlet eigenvalues
    h = 1.0 / (nx + 1)
    oned = 4.0 / (h * h) * np.sin(np.arange(1, nx + 1) * np.pi * h / 2) ** 2
    combos = np.sort(
        (oned[:, None, None] + oned[None, :, None] + oned[None, None, :])
        .ravel()
    )
    np.testing.assert_allclose(
        np.asarray(r.eigenvalues), combos[:3], rtol=1e-8
    )


def test_bsr_3d_laplacian_10_eigenpairs():
    """Full BASELINE.json config 1: standard LOBPCG, double, 3-D
    Laplacian stencil CSR, 10 smallest eigenpairs, no preconditioner."""
    from lobpcg_tpu import lobpcg
    from tests.fixtures import rand_block

    nx = 10
    ip, ix, v = laplacian_3d_csr(nx, nx, nx)
    n = nx**3
    op = BSROperator.from_csr(ip, ix, v, block_size=8, dtype=jnp.float64)
    nev, ss = 10, 15
    X0 = rand_block(302, n, ss, jnp.float64)
    r = lobpcg(op, X0, nev=nev, size_sub=ss, tol=1e-6, max_iter=500)
    assert int(r.converged) == nev
    h = 1.0 / (nx + 1)
    oned = 4.0 / (h * h) * np.sin(np.arange(1, nx + 1) * np.pi * h / 2) ** 2
    combos = np.sort(
        (oned[:, None, None] + oned[None, :, None] + oned[None, None, :])
        .ravel()
    )
    np.testing.assert_allclose(
        np.asarray(r.eigenvalues), combos[:nev], rtol=1e-7
    )


def _block_banded(nb, bs, band, seed):
    """Dense matrix whose nonzero blocks lie within `band` block
    diagonals of the main one."""
    rng = np.random.RandomState(seed)
    n = nb * bs
    A = np.zeros((n, n))
    for i in range(nb):
        for j in range(max(0, i - band), min(nb, i + band + 1)):
            A[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = rng.randn(bs, bs)
    return A


@pytest.mark.parametrize("band", [0, 2])
@pytest.mark.parametrize("bs", [8, 24, 64])
def test_bsr_reference_matches_dense(bs, band):
    """bsr_matmat_reference (the one BSR SpMM) == dense product, over
    block sizes that do and do not divide 128 and two bandwidths."""
    from lobpcg_tpu.operators.sparse import bsr_matmat_reference

    nb = 12
    A = _block_banded(nb, bs, band, seed=bs + band)
    op = BSROperator.from_dense(A, block_size=bs, dtype=jnp.float64)
    assert op.block_cols.shape == (nb, min(nb, 2 * band + 1))
    X = jnp.asarray(np.random.RandomState(bs).randn(nb * bs, 5))
    ref = A @ np.asarray(X)
    Y = bsr_matmat_reference(op.block_cols, op.blocks, X)
    np.testing.assert_allclose(np.asarray(Y), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
    np.testing.assert_array_equal(np.asarray(op.matmat(X)), np.asarray(Y))
