"""N-D Laplacian stencil operator (operators/stencil_nd.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

from lobpcg_tpu import lobpcg
from lobpcg_tpu.operators.sparse import BSROperator, laplacian_3d_csr
from lobpcg_tpu.operators.stencil_nd import LaplacianND, laplacian_nd_eigs
from lobpcg_tpu.parallel import row_mesh, shard_problem
from fixtures import rand_block


def test_3d_matches_csr():
    nx = 6
    h = 1.0 / (nx + 1)
    A = LaplacianND(scale=jnp.asarray(1.0 / (h * h), jnp.float64),
                    grid=(nx, nx, nx))
    ip, ix, v = laplacian_3d_csr(nx, nx, nx)
    import scipy.sparse as sp

    M = sp.csr_matrix((v, ix, ip), shape=(nx**3, nx**3))
    X = rand_block(1, nx**3, 4, jnp.float64)
    np.testing.assert_allclose(
        np.asarray(A.matmat(X)), M @ np.asarray(X), atol=1e-10
    )


def test_2d_solver_analytic():
    nx, ny = 24, 16
    h = 1.0 / (nx + 1)
    A = LaplacianND(scale=jnp.asarray(1.0 / (h * h), jnp.float64),
                    grid=(nx, ny))
    nev, ss = 4, 8
    r = lobpcg(A, rand_block(2, nx * ny, ss, jnp.float64), nev=nev,
               size_sub=ss, tol=1e-8, max_iter=400)
    assert int(r.converged) == nev
    exact = laplacian_nd_eigs((nx, ny), 1.0 / (h * h), nev)
    np.testing.assert_allclose(np.asarray(r.eigenvalues), exact, rtol=1e-8)


def test_3d_solver_matches_bsr_solve():
    nx = 8
    ip, ix, v = laplacian_3d_csr(nx, nx, nx)
    n = nx**3
    h = 1.0 / (nx + 1)
    A_st = LaplacianND(scale=jnp.asarray(1.0 / (h * h), jnp.float64),
                       grid=(nx, nx, nx))
    A_sp = BSROperator.from_csr(ip, ix, v, block_size=8, dtype=jnp.float64)
    X0 = rand_block(3, n, 6, jnp.float64)
    r1 = lobpcg(A_st, X0, nev=3, size_sub=6, tol=1e-8, max_iter=300)
    r2 = lobpcg(A_sp, X0, nev=3, size_sub=6, tol=1e-8, max_iter=300)
    np.testing.assert_allclose(
        np.asarray(r1.eigenvalues), np.asarray(r2.eigenvalues), rtol=1e-9
    )


def test_3d_sharded():
    """Row-sharded 3-D stencil: the leading grid axis partitions over the
    mesh; inner axes stay local."""
    nx = 8
    h = 1.0 / (nx + 1)
    A = LaplacianND(scale=jnp.asarray(1.0 / (h * h), jnp.float64),
                    grid=(nx, nx, nx))
    X0 = rand_block(5, nx**3, 6, jnp.float64)
    ref = lobpcg(A, X0, nev=3, size_sub=6, tol=1e-8, max_iter=300)

    mesh = row_mesh(4)
    As, X0s, _, _ = shard_problem(mesh, A, X0)
    with mesh:
        r = lobpcg(As, X0s, nev=3, size_sub=6, tol=1e-8, max_iter=300)
        lam = np.asarray(r.eigenvalues)
    np.testing.assert_allclose(lam, np.asarray(ref.eigenvalues), rtol=1e-9)


def test_sharded_rewrite_forces_jnp():
    """shard_problem keeps LaplacianND's plain jnp form (the partitioner
    derives its halos) and only places its data on the mesh."""
    nx = 8
    A = LaplacianND(scale=jnp.asarray(1.0, jnp.float64), grid=(nx, nx, nx))
    mesh = row_mesh(4)
    As, _, _, _ = shard_problem(mesh, A)
    assert isinstance(As, LaplacianND) and As.grid == A.grid
    X = rand_block(4, nx**3, 3, jnp.float64)
    with mesh:
        Y = np.asarray(As.matmat(X))
    np.testing.assert_allclose(Y, np.asarray(A.matmat(X)), atol=1e-12)


def _lap1d(m):
    import scipy.sparse as sp

    return sp.diags([-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)],
                    [-1, 0, 1])


def _nd_csr(grid, scale):
    """Kronecker-sum Dirichlet Laplacian on `grid` (C-order), times scale."""
    import scipy.sparse as sp

    L = None
    for ax, m in enumerate(grid):
        term = None
        for j, mj in enumerate(grid):
            f = _lap1d(mj) if j == ax else sp.identity(mj)
            term = f if term is None else sp.kron(term, f)
        L = term if L is None else L + term
    return (scale * L).tocsr()


@pytest.mark.parametrize("k", [1, 8, 128])
@pytest.mark.parametrize("grid", [(7, 5), (4, 6, 5)])
def test_nd_matches_csr(grid, k):
    """LaplacianND (one fused sum of per-axis stencils) == the explicit
    Kronecker-sum matrix in 2-D and 3-D, at several block widths; the
    3-D matrix is also the one laplacian_3d_csr assembles."""
    h = 1.0 / (max(grid) + 1)
    scale = 1.0 / (h * h)
    A = LaplacianND(scale=jnp.asarray(scale, jnp.float64), grid=grid)
    M = _nd_csr(grid, scale)
    if len(grid) == 3:
        import scipy.sparse as sp

        ip, ix, v = laplacian_3d_csr(*grid)
        M3 = sp.csr_matrix((v, ix, ip), shape=M.shape)
        assert abs(M3 - M).max() < 1e-9 * scale
    X = rand_block(6, int(np.prod(grid)), k, jnp.float64)
    np.testing.assert_allclose(
        np.asarray(A.matmat(X)), M @ np.asarray(X), rtol=1e-12,
        atol=1e-12 * scale,
    )
