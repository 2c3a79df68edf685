"""Integration tests for the standard solver — direct ports of the
oracles in `/root/reference/tests/test_lobpcg.c` (7 solver-level tests:
dense 4x4/6x6 vs dsyev, 1-D Laplacian vs (k*pi)^2, f32 run,
soft locking on diag(1..30)) plus generalized-pencil and preconditioner
coverage the reference gains via its B/T operator slots."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lobpcg_tpu import JacobiPreconditioner, lobpcg
from tests.fixtures import (
    A4,
    A6,
    EIGVALS_4,
    EIGVALS_6,
    dense_op,
    diag_op,
    laplacian_exact,
    laplacian_op,
    rand_block,
)


def _ortho_error(X):
    G = np.asarray(X).conj().T @ np.asarray(X)
    return np.abs(G - np.eye(G.shape[0])).max()


def test_d_lobpcg_4x4():
    """test_lobpcg.c Test 1: n=4, nev=1, sizeSub=1."""
    A = dense_op(A4, jnp.float64)
    r = lobpcg(A, nev=1, size_sub=1, tol=1e-5, max_iter=100,
               key=jax.random.PRNGKey(1))
    assert int(r.converged) == 1
    np.testing.assert_allclose(float(r.eigenvalues[0]), EIGVALS_4[0], atol=1e-8)
    assert _ortho_error(r.eigenvectors) < 1e-8
    X = np.asarray(r.eigenvectors)
    rq = X.T @ A4 @ X - np.diag(np.asarray(r.eigenvalues))
    assert np.abs(rq).max() < 1e-8


def test_z_lobpcg_4x4():
    """test_lobpcg.c Test 2: complex double."""
    A = dense_op(A4, jnp.complex128)
    r = lobpcg(A, nev=1, size_sub=1, tol=1e-5, max_iter=100,
               key=jax.random.PRNGKey(2))
    assert int(r.converged) == 1
    np.testing.assert_allclose(float(r.eigenvalues[0]), EIGVALS_4[0], atol=1e-4)
    assert _ortho_error(r.eigenvectors) < 1e-8


def test_c_lobpcg_4x4():
    """complex64 solver-level run (the reference's c32 instantiation)."""
    A = dense_op(A4, jnp.complex64)
    r = lobpcg(A, nev=1, size_sub=1, tol=1e-4, max_iter=200,
               key=jax.random.PRNGKey(2))
    assert int(r.converged) == 1
    np.testing.assert_allclose(
        float(r.eigenvalues[0]), EIGVALS_4[0], rtol=1e-3
    )
    assert _ortho_error(r.eigenvectors) < 1e-4


def test_d_lobpcg_6x6():
    """test_lobpcg.c Test 3: n=6, nev=1, sizeSub=2."""
    A = dense_op(A6, jnp.float64)
    r = lobpcg(A, nev=1, size_sub=2, tol=1e-5, max_iter=100,
               key=jax.random.PRNGKey(3))
    assert int(r.converged) == 1
    np.testing.assert_allclose(float(r.eigenvalues[0]), EIGVALS_6[0], atol=1e-6)
    assert _ortho_error(r.eigenvectors) < 1e-8


def test_d_lobpcg_6x6_nev2():
    """test_lobpcg.c Test 4: n=6, nev=2, sizeSub=2."""
    A = dense_op(A6, jnp.float64)
    r = lobpcg(A, nev=2, size_sub=2, tol=1e-5, max_iter=100,
               key=jax.random.PRNGKey(4))
    assert int(r.converged) == 2
    np.testing.assert_allclose(
        np.asarray(r.eigenvalues), EIGVALS_6[:2], atol=1e-6
    )
    assert _ortho_error(r.eigenvectors) < 1e-8


def test_d_lobpcg_laplacian():
    """test_lobpcg.c Test 5: n=100, nev=3, sizeSub=5, 1% vs (k*pi)^2."""
    n, nev, m = 100, 3, 5
    A = laplacian_op(n, jnp.float64)
    X0 = rand_block(123, n, m, jnp.float64)
    r = lobpcg(A, X0, nev=nev, size_sub=m, tol=1e-4, max_iter=500)
    assert int(r.converged) == nev
    for k in range(1, nev + 1):
        exact = laplacian_exact(k)
        rel = abs(float(r.eigenvalues[k - 1]) - exact) / exact
        assert rel < 0.01, (k, rel)


def test_s_lobpcg_laplacian():
    """test_lobpcg.c Test 6: float32 run, tol=1e-3."""
    n, nev, m = 100, 3, 5
    A = laplacian_op(n, jnp.float32)
    X0 = rand_block(456, n, m, jnp.float32)
    r = lobpcg(A, X0, nev=nev, size_sub=m, tol=1e-3, max_iter=500)
    assert int(r.converged) == nev


def test_d_lobpcg_softlock():
    """test_lobpcg.c Test 7: A=diag(1..30), nev=3, sizeSub=6, tol=1e-10 —
    exercises P/W soft-locking compaction as eigenpairs converge."""
    n, nev, m = 30, 3, 6
    A = diag_op(n, jnp.float64)
    X0 = rand_block(42, n, m, jnp.float64)
    r = lobpcg(A, X0, nev=nev, size_sub=m, tol=1e-10, max_iter=200)
    assert int(r.converged) == nev
    np.testing.assert_allclose(
        np.asarray(r.eigenvalues), [1.0, 2.0, 3.0], atol=1e-8
    )
    assert _ortho_error(r.eigenvectors) < 1e-10


def test_generalized_pencil():
    """A x = lambda B x with SPD B (capability: `lobpcg_impl.inc` B path)."""
    n, nev, m = 40, 3, 5
    rng = np.random.RandomState(9)
    Am = rng.randn(n, n)
    Am = Am @ Am.T + n * np.eye(n)
    Bm = np.diag(rng.uniform(0.5, 2.0, n))
    A, B = dense_op(Am, jnp.float64), dense_op(Bm, jnp.float64)
    X0 = rand_block(77, n, m, jnp.float64)
    r = lobpcg(A, X0, B, nev=nev, size_sub=m, tol=1e-8, max_iter=300)
    import scipy.linalg as sla

    exact = sla.eigh(Am, Bm, eigvals_only=True)[:nev]
    assert int(r.converged) == nev
    np.testing.assert_allclose(np.asarray(r.eigenvalues), exact, rtol=1e-6)
    # B-orthonormality of eigenvectors
    X = np.asarray(r.eigenvectors)
    np.testing.assert_allclose(X.T @ Bm @ X, np.eye(nev), atol=1e-6)


def test_generalized_pencil_b_cache_off():
    """use_b_cache=False (re-apply B at every site) matches the cached
    default on the SPD-B pencil — covers the Bvb/Bblocks plumbing in the
    definite driver (solvers/lobpcg.py) against the legacy path."""
    from lobpcg_tpu import SolverConfig

    n, nev, m = 40, 3, 5
    rng = np.random.RandomState(9)
    Am = rng.randn(n, n)
    Am = Am @ Am.T + n * np.eye(n)
    Bm = np.diag(rng.uniform(0.5, 2.0, n))
    A, B = dense_op(Am, jnp.float64), dense_op(Bm, jnp.float64)
    X0 = rand_block(77, n, m, jnp.float64)
    r1 = lobpcg(A, X0, B, nev=nev, size_sub=m, tol=1e-8, max_iter=300)
    cfg = SolverConfig(nev=nev, size_sub=m, tol=1e-8, max_iter=300,
                       use_b_cache=False)
    r2 = lobpcg(A, X0, B, config=cfg)
    assert int(r1.converged) == nev and int(r2.converged) == nev
    np.testing.assert_allclose(
        np.asarray(r1.eigenvalues), np.asarray(r2.eigenvalues), rtol=1e-9
    )


def test_jacobi_preconditioner_speeds_convergence():
    """T slot capability (`lobpcg_impl.inc:152-155`)."""
    n, nev, m = 200, 2, 4
    d = np.linspace(1.0, 1e4, n)
    A = diag_op(n, jnp.float64)
    A = dense_op(np.diag(d), jnp.float64)
    T = JacobiPreconditioner(jnp.asarray(d))
    X0 = rand_block(88, n, m, jnp.float64)
    r_pre = lobpcg(A, X0, T=T, nev=nev, size_sub=m, tol=1e-8, max_iter=60)
    assert int(r_pre.converged) == nev
    np.testing.assert_allclose(
        np.asarray(r_pre.eigenvalues), d[:nev], rtol=1e-6
    )


def test_warm_start_resume():
    """Warm start = checkpoint/resume analog (`lobpcg_impl.inc:92-96`):
    re-entering with the previous X converges immediately."""
    n, nev, m = 50, 2, 4
    A = diag_op(n, jnp.float64)
    X0 = rand_block(99, n, m, jnp.float64)
    r1 = lobpcg(A, X0, nev=nev, size_sub=m, tol=1e-9, max_iter=200)
    assert int(r1.converged) == nev
    # Resume from converged eigenvectors, padded to size_sub
    X_resume = jnp.concatenate(
        [r1.eigenvectors, rand_block(100, n, m - nev, jnp.float64)], axis=1
    )
    r2 = lobpcg(A, X_resume, nev=nev, size_sub=m, tol=1e-9, max_iter=200)
    assert int(r2.converged) == nev
    assert int(r2.iterations) <= int(r1.iterations)


def test_rank_deficient_start_basis():
    """BASELINE config 2: rank-deficient search space — X0 with duplicated
    and zero columns still converges (SVQB drop + ortho retry at the
    solver level)."""
    import jax.numpy as jnp
    import numpy as np

    from tests.fixtures import laplacian_exact, laplacian_op, rand_block

    n, nev, ss = 100, 3, 6
    A = laplacian_op(n, jnp.float64)
    X = np.asarray(rand_block(13, n, ss, jnp.float64)).copy()
    X[:, 3] = X[:, 0]  # duplicate
    X[:, 4] = 0.0      # dead column
    X[:, 5] = 2.0 * X[:, 1]  # linearly dependent
    r = lobpcg(A, jnp.asarray(X), nev=nev, size_sub=ss, tol=1e-7,
               max_iter=300)
    assert int(r.converged) == nev
    exact = laplacian_exact(np.arange(1, nev + 1))
    rel = np.abs(np.asarray(r.eigenvalues) - exact) / exact
    assert np.all(rel < 1e-2), rel


def test_chebyshev_preconditioned_solver():
    """ChebyshevFilter in the reference's T slot, solver level."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lobpcg_tpu import ChebyshevFilter
    from lobpcg_tpu.ops.residual import estimate_norm
    from tests.fixtures import laplacian_exact, laplacian_op, rand_block

    n, nev, ss = 400, 3, 6
    A = laplacian_op(n, jnp.float64)
    hi = float(estimate_norm(A, jax.random.PRNGKey(1), 20)) * 1.05
    T = ChebyshevFilter(op=A, lo=jnp.float64(hi / 50), hi=jnp.float64(hi),
                        degree=10)
    r = lobpcg(A, rand_block(3, n, ss, jnp.float64), T=T, nev=nev,
               size_sub=ss, tol=1e-7, max_iter=200)
    assert int(r.converged) == nev
    exact = laplacian_exact(np.arange(1, nev + 1))
    assert np.all(np.abs(np.asarray(r.eigenvalues) - exact) / exact < 1e-2)


def test_generalized_pencil_b_residual_norm():
    """residual_norm="b" on the generalized diagonal (Jacobi-style)
    pencil: converges to the same eigenvalues as the 2-norm default and
    reports B-seminorm residuals (fixes the reference
    defect `residual_impl.inc:83-91`)."""
    from lobpcg_tpu import SolverConfig

    n, nev, m = 40, 3, 5
    rng = np.random.RandomState(9)
    Am = rng.randn(n, n)
    Am = Am @ Am.T + n * np.eye(n)
    Bm = np.diag(rng.uniform(0.5, 2.0, n))
    A, B = dense_op(Am, jnp.float64), dense_op(Bm, jnp.float64)
    X0 = rand_block(77, n, m, jnp.float64)
    cfg = SolverConfig(nev=nev, size_sub=m, tol=1e-8, max_iter=300,
                       residual_norm="b")
    r = lobpcg(A, X0, B, config=cfg)
    import scipy.linalg as sla

    exact = sla.eigh(Am, Bm, eigvals_only=True)[:nev]
    assert int(r.converged) == nev
    np.testing.assert_allclose(np.asarray(r.eigenvalues), exact, rtol=1e-6)
    # Reported norms are the B-seminorm of the final residual block.
    X = np.asarray(r.eigenvectors)
    lam = np.asarray(r.eigenvalues)
    Wn = Am @ X - Bm @ X * lam[None, :]
    a_n = np.linalg.norm(Am, 2)
    b_n = np.linalg.norm(Bm, 2)
    expect = np.sqrt(np.abs(np.sum(Wn * (Bm @ Wn), axis=0)))
    # a_norm/b_norm are power-iteration estimates; compare loosely.
    ratio = np.asarray(r.residual_norms) * (a_n + np.abs(lam) * b_n) / \
        np.maximum(expect, 1e-30)
    assert np.all(ratio > 0.2) and np.all(ratio < 5.0)


def test_ilobpcg_b_residual_norm_converges():
    """residual_norm="b" through the indefinite driver (B indefinite:
    the |.| guard makes the seminorm well-defined)."""
    from lobpcg_tpu import SolverConfig, ilobpcg
    from tests.fixtures import bdg_ops, bdg_positive_init

    m = 100
    A, B = bdg_ops(m, jnp.float64)
    X0 = bdg_positive_init(5, m, 6, jnp.float64)
    cfg = SolverConfig(nev=3, size_sub=6, tol=1e-8, max_iter=200,
                       residual_norm="b")
    r = ilobpcg(A, X0, B, config=cfg)
    assert int(r.converged) == 3
    k = np.arange(1, 4)
    exact = (k * np.pi) ** 2
    np.testing.assert_allclose(
        np.asarray(r.eigenvalues), exact, rtol=1e-2
    )
