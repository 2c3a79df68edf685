"""Split-real (realified) complex solves (operators/realify.py) — the
execution path for complex Hermitian pencils on complex-free backends."""

import numpy as np
import jax.numpy as jnp
import pytest

from lobpcg_tpu import (
    CallableOperator,
    DenseOperator,
    DiagonalOperator,
    SolverConfig,
    ilobpcg,
    lobpcg,
)
from lobpcg_tpu.operators.realify import (
    derealify,
    realify_config,
    realify_operator,
    realify_problem,
    realify_x0,
)
from fixtures import bdg_ops, bdg_positive_init, laplacian_exact, rand_block


def _hermitian(n, seed):
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n) + 1j * rng.randn(n, n)
    return (M + M.conj().T) / 2 + n * np.eye(n)


def test_embedding_matches_complex_apply():
    n, k = 24, 4
    A_np = _hermitian(n, 0)
    A = DenseOperator(jnp.asarray(A_np, jnp.complex128))
    Ar = realify_operator(A)
    Z = rand_block(1, n, k, jnp.complex128)
    W = jnp.concatenate([jnp.real(Z), jnp.imag(Z)], axis=0)
    Y = np.asarray(Ar.matmat(W))
    AZ = A_np @ np.asarray(Z)
    np.testing.assert_allclose(Y[:n], AZ.real, atol=1e-12)
    np.testing.assert_allclose(Y[n:], AZ.imag, atol=1e-12)


def test_realified_lobpcg_matches_complex():
    n, nev, ss = 40, 3, 5
    A_np = _hermitian(n, 1)
    A = DenseOperator(jnp.asarray(A_np, jnp.complex128))
    X0 = rand_block(2, n, ss, jnp.complex128)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=300)

    ref = lobpcg(A, X0, config=cfg)

    Ar, X0r, _, _, cfgr = realify_problem(A, X0, config=cfg)
    assert cfgr.nev == 2 * nev and cfgr.size_sub == 2 * ss
    rr = lobpcg(Ar, X0r, config=cfgr)
    lam, vec, res = derealify(rr, nev)

    np.testing.assert_allclose(lam, np.asarray(ref.eigenvalues), rtol=1e-7)
    # Recovered complex eigenvectors satisfy the COMPLEX eigen equation.
    for j in range(nev):
        r = A_np @ vec[:, j] - lam[j] * vec[:, j]
        assert np.linalg.norm(r) < 1e-5 * np.linalg.norm(A_np), j
    assert np.all(np.isfinite(res))


def test_realified_generalized_with_diag_b():
    n, nev, ss = 30, 2, 4
    A_np = _hermitian(n, 3)
    b = np.random.RandomState(4).uniform(1.0, 2.0, n)
    A = DenseOperator(jnp.asarray(A_np, jnp.complex128))
    B = DiagonalOperator(jnp.asarray(b, jnp.complex128))
    X0 = rand_block(5, n, ss, jnp.complex128)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-8, max_iter=300)

    Ar, X0r, Br, _, cfgr = realify_problem(A, X0, B, config=cfg)
    rr = lobpcg(Ar, X0r, Br, config=cfgr)
    lam, _, _ = derealify(rr, nev)

    import scipy.linalg as sla

    exact = np.sort(sla.eigh(A_np, np.diag(b), eigvals_only=True).real)[:nev]
    np.testing.assert_allclose(lam, exact, rtol=1e-7)


def test_realified_ilobpcg_bdg():
    """Complex BdG pencil through the real embedding matches the
    analytic +-(k pi)^2 spectrum."""
    m, nev, ss = 100, 3, 6
    A, B = bdg_ops(m, jnp.complex128)
    X0 = bdg_positive_init(42, m, ss, jnp.complex128)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-6, max_iter=400)

    Ar, X0r, Br, _, cfgr = realify_problem(A, X0, B, config=cfg)
    assert Ar.dtype == jnp.float64
    rr = ilobpcg(Ar, X0r, Br, config=cfgr)
    lam, _, _ = derealify(rr, nev)

    exact = laplacian_exact(np.arange(1, nev + 1))
    rel = np.abs(lam - exact) / exact
    assert np.all(rel < 1e-2), rel
    assert np.all(np.asarray(rr.signature)[: 2 * nev] == 1)


def test_realify_x0_layout():
    Z = rand_block(1, 10, 3, jnp.complex128)
    W = realify_x0(Z)
    assert W.shape == (20, 6)
    z0 = np.asarray(Z)[:, 0]
    np.testing.assert_allclose(np.asarray(W)[:10, 0], z0.real)
    np.testing.assert_allclose(np.asarray(W)[10:, 0], z0.imag)
    np.testing.assert_allclose(np.asarray(W)[:10, 1], -z0.imag)
    np.testing.assert_allclose(np.asarray(W)[10:, 1], z0.real)


def test_realify_downcast_dtype():
    """complex128-specified operator realified to f32 storage."""
    A = DenseOperator(jnp.asarray(_hermitian(8, 6), jnp.complex128))
    Ar = realify_operator(A, rdt=jnp.float32)
    assert Ar.dtype == jnp.float32


def test_realify_unknown_operator_raises():
    op = CallableOperator(args=(), fn=lambda X: X, n=4,
                          _dtype=jnp.complex128)
    with pytest.raises(NotImplementedError):
        realify_operator(op)


def test_realify_config_doubles():
    cfg = SolverConfig(nev=5, size_sub=8)
    c2 = realify_config(cfg)
    assert (c2.nev, c2.size_sub) == (10, 16)


def test_realify_rejects_truly_complex_scalars():
    from lobpcg_tpu import Laplacian1D, JacobiPreconditioner

    with pytest.raises(NotImplementedError):
        realify_operator(
            Laplacian1D(scale=jnp.asarray(1.0 + 2.0j, jnp.complex128), n=4)
        )
    with pytest.raises(NotImplementedError):
        realify_operator(
            JacobiPreconditioner(
                jnp.asarray([1.0 + 1.0j, 2.0], jnp.complex128)
            )
        )


def test_shardwise_x0_matches_realify_x0():
    """The complex headline gate's shard-by-shard start-block builder
    (__graft_entry__._realified_duplicated_rows) must reproduce
    realify_x0(concat([u, u])) exactly, in arbitrary row windows."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from __graft_entry__ import _realified_duplicated_rows

    m, k = 12, 3
    rng = np.random.RandomState(7)
    ur = rng.uniform(-0.5, 0.5, size=(m, k)).astype(np.float32)
    ui = rng.uniform(-0.5, 0.5, size=(m, k)).astype(np.float32)
    u = (ur + 1j * ui).astype(np.complex64)
    X0c = jnp.asarray(np.concatenate([u, u], axis=0))
    ref = np.asarray(realify_x0(X0c, jnp.float32))
    for r0, r1 in ((0, 4 * m), (0, 7), (5, 29), (2 * m, 4 * m), (47, 48)):
        got = _realified_duplicated_rows(ur, ui, r0, r1)
        np.testing.assert_array_equal(got, ref[r0:r1])
