"""Mixed-precision solves (BASELINE.json config: "Generalized pencil
A x = lambda B x with user preconditioner T (Jacobi/diagonal), mixed
float/double").

Storage / operator applications in f32 (the fast path), Gram
accumulation + projected eigensolves in f64 via SolverConfig.rr_dtype.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lobpcg_tpu import (
    DenseOperator,
    DiagonalOperator,
    JacobiPreconditioner,
    Laplacian1D,
    SolverConfig,
    ilobpcg,
    lobpcg,
)
from lobpcg_tpu.ops.gram import gram_self
from fixtures import bdg_ops, bdg_positive_init, laplacian_exact, rand_block


def test_gram_out_dtype():
    rng = np.random.RandomState(0)
    U = jnp.asarray(rng.randn(50, 4), jnp.float32)
    G = gram_self(U, None, out_dtype=jnp.float64)
    assert G.dtype == jnp.float64
    G64 = np.asarray(U, np.float64).T @ np.asarray(U, np.float64)
    np.testing.assert_allclose(np.asarray(G), G64, rtol=1e-6)


def test_gram_out_dtype_complex():
    rng = np.random.RandomState(1)
    U = jnp.asarray(rng.randn(30, 3) + 1j * rng.randn(30, 3), jnp.complex64)
    G = gram_self(U, None, out_dtype=jnp.complex128)
    assert G.dtype == jnp.complex128


def test_lobpcg_laplacian_mixed():
    """f32 stencil operator + f64 RR: analytic (k pi)^2 within 1%,
    eigenvalues reported in f64."""
    n, nev, ss = 100, 3, 6
    h = 1.0 / (n + 1)
    A = Laplacian1D(scale=jnp.asarray(1.0 / (h * h), jnp.float32), n=n)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-5, max_iter=200,
                       rr_dtype="float64")
    r = lobpcg(A, rand_block(7, n, ss, jnp.float32), config=cfg)
    assert r.eigenvalues.dtype == jnp.float64
    exact = laplacian_exact(np.arange(1, nev + 1))
    rel = np.abs(np.asarray(r.eigenvalues) - exact) / exact
    assert np.all(rel < 1e-2), rel


def test_generalized_jacobi_mixed():
    """Config 3: generalized pencil, Jacobi preconditioner, mixed f32/f64."""
    rng = np.random.RandomState(3)
    n, nev, ss = 60, 4, 8
    M = rng.randn(n, n)
    A_np = M @ M.T + n * np.eye(n)
    b_diag = rng.uniform(1.0, 3.0, n)
    A = DenseOperator(jnp.asarray(A_np, jnp.float32))
    B = DiagonalOperator(jnp.asarray(b_diag, jnp.float32))
    T = JacobiPreconditioner(jnp.asarray(np.diag(A_np), jnp.float32))
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-5, max_iter=300,
                       rr_dtype="float64")
    r = lobpcg(A, rand_block(11, n, ss, jnp.float32), B, T, config=cfg)

    import scipy.linalg as sla

    exact = np.sort(sla.eigh(A_np, np.diag(b_diag), eigvals_only=True))[:nev]
    got = np.asarray(r.eigenvalues)
    np.testing.assert_allclose(got, exact, rtol=5e-4)


def test_ilobpcg_bdg_mixed():
    """Indefinite BdG pencil in f32 storage + f64 pencil solves."""
    m, nev, ss = 100, 3, 6
    A, B = bdg_ops(m, jnp.float32)
    X0 = bdg_positive_init(42, m, ss, jnp.float32)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-4, max_iter=300,
                       rr_dtype="float64")
    r = ilobpcg(A, X0, B, config=cfg)
    assert r.eigenvalues.dtype == jnp.float64
    exact = laplacian_exact(np.arange(1, nev + 1))
    rel = np.abs(np.asarray(r.eigenvalues) - exact) / exact
    assert np.all(rel < 1e-2), rel
    assert np.all(np.asarray(r.signature) == 1)


def test_mixed_rr_dtype_complex_promotion():
    cfg = SolverConfig(nev=2, size_sub=2, rr_dtype="float64")
    assert cfg.resolved_rr_dtype(jnp.complex64) == jnp.dtype(jnp.complex128)
    assert cfg.resolved_rr_dtype(jnp.float32) == jnp.dtype(jnp.float64)
    cfg2 = SolverConfig(nev=2, size_sub=2)
    assert cfg2.resolved_rr_dtype(jnp.float32) is None


@pytest.mark.parametrize("rr_dtype", [None, "float64"])
def test_mixed_vs_pure_consistency(rr_dtype):
    """Mixed and pure paths agree on a well-conditioned dense problem."""
    rng = np.random.RandomState(5)
    n, nev, ss = 40, 3, 5
    M = rng.randn(n, n)
    A_np = M @ M.T + n * np.eye(n)
    A = DenseOperator(jnp.asarray(A_np, jnp.float32))
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-5, max_iter=200,
                       rr_dtype=rr_dtype)
    r = lobpcg(A, rand_block(2, n, ss, jnp.float32), config=cfg)
    exact = np.sort(np.linalg.eigvalsh(A_np))[:nev]
    np.testing.assert_allclose(np.asarray(r.eigenvalues), exact, rtol=1e-4)


def test_ilobpcg_rr_chunk_rows_end_to_end():
    """rr_chunk_rows (the f64-emulation memory bound) solves the BdG
    mixed-precision pencil to the same eigenvalues as the unchunked
    escalated path — including a non-divisible chunk remainder."""
    m, nev, ss = 100, 3, 6  # n = 200 rows -> chunks of 64 + remainder 8
    A, B = bdg_ops(m, jnp.float32)
    X0 = bdg_positive_init(42, m, ss, jnp.float32)
    base = SolverConfig(nev=nev, size_sub=ss, tol=1e-4, max_iter=300,
                        rr_dtype="float64")
    chunked = SolverConfig(nev=nev, size_sub=ss, tol=1e-4, max_iter=300,
                           rr_dtype="float64", rr_chunk_rows=64)
    r0 = ilobpcg(A, X0, B, config=base)
    r1 = ilobpcg(A, X0, B, config=chunked)
    exact = laplacian_exact(np.arange(1, nev + 1))
    rel = np.abs(np.asarray(r1.eigenvalues) - exact) / exact
    assert np.all(rel < 1e-2), rel
    # Chunking changes f64-accumulation ADDITION ORDER, which nudges the
    # f32 solve trajectory; eigenvalues agree at solve accuracy, not ulp.
    np.testing.assert_allclose(
        np.asarray(r1.eigenvalues), np.asarray(r0.eigenvalues), rtol=1e-5
    )
