"""Explicit shard_map halo-exchange stencil (parallel/spmd_stencil.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lobpcg_tpu import Laplacian1D, lobpcg
from lobpcg_tpu.parallel import (
    SpmdLaplacian1D,
    row_mesh,
    shard_problem,
    stencil_matmat_spmd,
    use_spmd_stencils,
)
from fixtures import rand_block


def _dense_tridiag(n, seg, scale):
    A = np.zeros((n, n))
    for s in range(n // seg):
        lo = s * seg
        for i in range(seg):
            A[lo + i, lo + i] = 2 * scale
            if i > 0:
                A[lo + i, lo + i - 1] = -scale
            if i < seg - 1:
                A[lo + i, lo + i + 1] = -scale
    return A


@pytest.mark.parametrize("segments", [1, 2, 4])
@pytest.mark.parametrize("nd", [2, 8])
def test_spmd_stencil_matches_dense(segments, nd):
    n, k = 64, 3
    mesh = row_mesh(nd)
    X = rand_block(7, n, k, jnp.float64)
    Y = stencil_matmat_spmd(X, jnp.float64(1.5), mesh,
                            num_segments=segments)
    A = _dense_tridiag(n, n // segments, 1.5)
    np.testing.assert_allclose(np.asarray(Y), A @ np.asarray(X), atol=1e-12)


@pytest.mark.parametrize("segments", [1, 2])
def test_spmd_matches_local_operator(segments):
    n, k = 96, 4
    mesh = row_mesh(8)
    sc = jnp.float64(3.0)
    K = Laplacian1D(scale=sc, n=n, segments=segments)
    Ks = SpmdLaplacian1D(scale=sc, n=n, segments=segments, mesh=mesh)
    X = rand_block(3, n, k, jnp.float64)
    np.testing.assert_allclose(
        np.asarray(Ks.matmat(X)), np.asarray(K.matmat(X)), atol=1e-12
    )


def test_use_spmd_stencils_rewrites_nested():
    from lobpcg_tpu import BlockDiagOperator, DiagonalOperator, SumOperator

    mesh = row_mesh(4)
    K = Laplacian1D(scale=jnp.float64(1.0), n=32)
    op = BlockDiagOperator(
        inner=SumOperator(K, DiagonalOperator(jnp.ones(32))), copies=2
    )
    out = use_spmd_stencils(op, mesh)
    assert isinstance(out.inner.left, SpmdLaplacian1D)
    assert out.inner.left.mesh is mesh
    # Untouched parts survive.
    assert isinstance(out.inner.right, DiagonalOperator)


def test_sharded_solve_matches_unsharded():
    n, nev, ss = 128, 3, 6
    h = 1.0 / (n + 1)
    A = Laplacian1D(scale=jnp.asarray(1.0 / (h * h), jnp.float64), n=n)
    X0 = rand_block(5, n, ss, jnp.float64)

    ref = lobpcg(A, X0, nev=nev, size_sub=ss, tol=1e-7, max_iter=200)

    mesh = row_mesh(8)
    As, X0s, _, _ = shard_problem(mesh, A, X0)
    assert isinstance(As, SpmdLaplacian1D)
    with mesh:
        r = lobpcg(As, X0s, nev=nev, size_sub=ss, tol=1e-7, max_iter=200)
        lam = np.asarray(r.eigenvalues)
    np.testing.assert_allclose(lam, np.asarray(ref.eigenvalues), rtol=1e-9)


def test_spmd_stencil_shape_validation():
    mesh = row_mesh(8)
    X = rand_block(1, 60, 2, jnp.float64)  # 60 not divisible by 8
    with pytest.raises(ValueError):
        stencil_matmat_spmd(X, jnp.float64(1.0), mesh, num_segments=1)


@pytest.mark.parametrize("segments", [1, 2, 16])
def test_spmd_local_f32_wide_matches_dense(segments):
    """f32 at width 128: the shard-local concatenate/shift-add path with
    ppermute'd halos matches the dense operator (segments smaller than,
    equal to, and larger than a shard)."""
    n, k = 512, 128
    mesh = row_mesh(8)
    X = rand_block(11, n, k, jnp.float32)
    Y = stencil_matmat_spmd(X, jnp.float32(1.5), mesh, num_segments=segments)
    assert Y.dtype == jnp.float32
    A = _dense_tridiag(n, n // segments, 1.5)
    ref = A @ np.asarray(X, np.float64)
    # Four f32 roundings per row (three terms and the scale), with
    # ||A||_inf = 6 and |x| <= 0.5: error <= 4 * 2^-24 * 6 * 0.5.
    assert np.abs(np.asarray(Y) - ref).max() <= 4 * 2.0**-24 * 6 * 0.5


def test_spmd_f32_solve_matches_analytic():
    """f32 end-to-end solve through the row-sharded halo-exchange stencil
    hits the analytic Laplacian spectrum (reference oracle ±1%,
    `tests/test_lobpcg.c:383-389`)."""
    n, nev, ss = 1024, 2, 8
    h = 1.0 / (n + 1)
    sc = jnp.asarray(1.0 / (h * h), jnp.float32)
    X0 = rand_block(5, n, ss, jnp.float32)

    mesh = row_mesh(8)
    As, X0s, _, _ = shard_problem(mesh, Laplacian1D(scale=sc, n=n), X0)
    with mesh:
        r = lobpcg(As, X0s, nev=nev, size_sub=ss, tol=1e-5, max_iter=300)
        lam = np.asarray(r.eigenvalues)
    assert int(r.converged) == nev
    analytic = (np.arange(1, nev + 1) * np.pi) ** 2
    np.testing.assert_allclose(lam, analytic, rtol=1e-2)
