"""Multi-device tests on the 8-way virtual CPU mesh: sharded solves must
match unsharded results (the reference has no distributed layer; this is
the SURVEY.md §2.6 design, validated per §4's implication note)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lobpcg_tpu import ilobpcg, lobpcg
from lobpcg_tpu.parallel import row_mesh, shard_problem
from tests.fixtures import (
    bdg_ops,
    bdg_positive_init,
    laplacian_exact,
    laplacian_op,
    rand_block,
)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return row_mesh(8)


def test_sharded_lobpcg_matches_single(mesh):
    n, nev, m = 256, 3, 5
    A = laplacian_op(n, jnp.float64)
    X0 = rand_block(201, n, m, jnp.float64)
    r_single = lobpcg(A, X0, nev=nev, size_sub=m, tol=1e-6, max_iter=300)

    As, X0s, _, _ = shard_problem(mesh, A, X0)
    r_shard = lobpcg(As, X0s, nev=nev, size_sub=m, tol=1e-6, max_iter=300)

    assert int(r_shard.converged) == nev
    # Sharded Grams psum shard partials (different rounding than one
    # contraction), so the two solves take slightly different
    # trajectories; both stop at tol=1e-6, which bounds the eigenvalue
    # agreement near tol^... measured 5e-8 relative — demand 1e-7, not
    # bit-closeness the stopping criterion never promised.
    np.testing.assert_allclose(
        np.asarray(r_shard.eigenvalues),
        np.asarray(r_single.eigenvalues),
        rtol=1e-7,
    )


def test_sharded_ilobpcg_bdg(mesh):
    m, nev, ss = 64, 3, 5
    A, B = bdg_ops(m, jnp.float64)
    X0 = bdg_positive_init(42, m, ss, jnp.float64)
    As, X0s, Bs, _ = shard_problem(mesh, A, X0, B)
    r = ilobpcg(As, X0s, Bs, nev=nev, size_sub=ss, tol=1e-4, max_iter=500)
    assert int(r.converged) == nev
    for k in range(1, nev + 1):
        exact = laplacian_exact(k)
        assert abs(float(r.eigenvalues[k - 1]) - exact) / exact < 0.01


def test_sharded_output_layout(mesh):
    """Eigenvector output keeps the row sharding (no implicit gather)."""
    n, nev, m = 128, 2, 4
    A = laplacian_op(n, jnp.float64)
    X0 = rand_block(202, n, m, jnp.float64)
    As, X0s, _, _ = shard_problem(mesh, A, X0)
    r = lobpcg(As, X0s, nev=nev, size_sub=m, tol=1e-6, max_iter=300)
    shard_shapes = {s.data.shape for s in r.eigenvectors.addressable_shards}
    assert shard_shapes == {(n // 8, nev)}


def test_rr_chunk_rows_rejects_row_sharded_inputs(mesh):
    """rr_chunk_rows + a row-sharded X0 must raise up front:
    the chunking reshape conflicts with a sharded leading axis."""
    from lobpcg_tpu import SolverConfig

    n, nev, m = 256, 3, 5
    A = laplacian_op(n, jnp.float64)
    X0 = rand_block(202, n, m, jnp.float64)
    As, X0s, _, _ = shard_problem(mesh, A, X0)
    cfg = SolverConfig(nev=nev, size_sub=m, tol=1e-6, max_iter=50,
                       rr_dtype="float64", rr_chunk_rows=32)
    with pytest.raises(ValueError, match="row-sharded"):
        lobpcg(As, X0s, config=cfg)
    # Unsharded inputs with the same config stay accepted.
    r = lobpcg(A, X0, config=cfg)
    assert int(r.iterations) > 0


def test_row_mesh_raises_when_too_few_devices():
    """More devices than the default backend has is an error — never a
    mesh quietly built from another backend's devices."""
    n = len(jax.devices())
    assert row_mesh(n).devices.size == n
    with pytest.raises(ValueError, match=f"need {n + 1} devices"):
        row_mesh(n + 1)
