"""Sharded block-ELL SpMM with halo exchange (parallel/spmd_bsr.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

from lobpcg_tpu import lobpcg
from lobpcg_tpu.operators.sparse import BSROperator, laplacian_3d_csr
from lobpcg_tpu.parallel import row_mesh
from lobpcg_tpu.parallel.spmd_bsr import ShardedBSROperator
from lobpcg_tpu.utils import native
from fixtures import rand_block


def _banded_matrix(n, bw, seed=0):
    rng = np.random.RandomState(seed)
    A = np.zeros((n, n))
    for d in range(-bw, bw + 1):
        v = rng.randn(n - abs(d)) * (0.3 ** abs(d))
        A += np.diag(v, d)
    A = 0.5 * (A + A.T) + 2 * bw * np.eye(n)
    return A


@pytest.mark.parametrize("nd", [2, 4, 8])
@pytest.mark.parametrize("bw", [1, 5, 17])
def test_sharded_bsr_matches_dense(nd, bw):
    n = 256
    A = _banded_matrix(n, bw)
    op = BSROperator.from_dense(A, block_size=8, dtype=jnp.float64)
    mesh = row_mesh(nd)
    sop = ShardedBSROperator.shard(op, mesh)
    X = rand_block(3, n, 5, jnp.float64)
    with mesh:
        Y = np.asarray(sop.matmat(X))
    np.testing.assert_allclose(Y, A @ np.asarray(X), atol=1e-10)


def test_sharded_bsr_diagonal_no_halo():
    n = 64
    A = np.diag(np.arange(1.0, n + 1))
    op = BSROperator.from_dense(A, block_size=8, dtype=jnp.float64)
    mesh = row_mesh(8)
    sop = ShardedBSROperator.shard(op, mesh)
    assert sop.halo == 0
    X = rand_block(1, n, 3, jnp.float64)
    with mesh:
        Y = np.asarray(sop.matmat(X))
    np.testing.assert_allclose(Y, A @ np.asarray(X), atol=1e-12)


def test_sharded_bsr_bandwidth_guard():
    n = 64
    A = np.eye(n)
    A[0, -1] = A[-1, 0] = 1.0  # full-bandwidth coupling
    op = BSROperator.from_dense(A, block_size=8, dtype=jnp.float64)
    mesh = row_mesh(8)
    with pytest.raises(ValueError, match="bandwidth"):
        ShardedBSROperator.shard(op, mesh)


def test_rcm_enables_sharding():
    """A matrix whose raw ordering exceeds the per-shard bandwidth becomes
    shardable after RCM reordering (the native-library preprocessing)."""
    n = 128
    A = _banded_matrix(n, 3, seed=4)
    perm_scatter = np.random.RandomState(9).permutation(n)
    A_bad = A[np.ix_(perm_scatter, perm_scatter)]

    op_bad = BSROperator.from_dense(A_bad, block_size=8, dtype=jnp.float64)
    mesh = row_mesh(8)
    with pytest.raises(ValueError):
        ShardedBSROperator.shard(op_bad, mesh)

    import scipy.sparse as sp

    M = sp.csr_matrix(A_bad)
    perm = np.asarray(native.rcm_order(n, M.indptr, M.indices))
    A_rcm = A_bad[np.ix_(perm, perm)]
    op = BSROperator.from_dense(A_rcm, block_size=8, dtype=jnp.float64)
    sop = ShardedBSROperator.shard(op, mesh)
    X = rand_block(2, n, 4, jnp.float64)
    with mesh:
        Y = np.asarray(sop.matmat(X))
    np.testing.assert_allclose(Y, A_rcm @ np.asarray(X), atol=1e-10)


def test_sharded_bsr_in_solver():
    """3-D Laplacian solved through the sharded BSR path matches the
    unsharded solve."""
    nx = 8
    ip, ix, v = laplacian_3d_csr(nx, nx, nx)
    n = nx**3
    op = BSROperator.from_csr(ip, ix, v, block_size=8, dtype=jnp.float64)
    X0 = rand_block(301, n, 6, jnp.float64)

    ref = lobpcg(op, X0, nev=3, size_sub=6, tol=1e-7, max_iter=300)

    # nx=8 gives block bandwidth nx^2/bs = 8 block rows; 4 shards keep
    # 16 block rows per shard (> halo).
    mesh = row_mesh(4)
    sop = ShardedBSROperator.shard(op, mesh)
    from lobpcg_tpu.parallel import shard_array

    X0s = shard_array(X0, mesh)
    with mesh:
        r = lobpcg(sop, X0s, nev=3, size_sub=6, tol=1e-7, max_iter=300)
        lam = np.asarray(r.eigenvalues)
    np.testing.assert_allclose(lam, np.asarray(ref.eigenvalues), rtol=1e-9)
