"""Gram kernel tests — oracles from `/root/reference/tests/test_gram.c`."""

import jax.numpy as jnp
import numpy as np
import pytest

from lobpcg_tpu.ops.gram import (
    gram_cross,
    gram_cross_mat,
    gram_self,
    gram_self_mat,
    ortho_err,
)
from tests.fixtures import dense_op, rand_block

DTYPES = [jnp.float32, jnp.float64, jnp.complex64, jnp.complex128]


@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_self_identity_metric(dtype):
    U = rand_block(0, 20, 4, dtype)
    G = gram_self(U)
    np.testing.assert_allclose(
        np.asarray(G), np.asarray(U).conj().T @ np.asarray(U), rtol=1e-5
    )


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.complex128])
def test_gram_self_operator_metric(dtype):
    rng = np.random.RandomState(3)
    n = 12
    M = rng.randn(n, n)
    Bm = M @ M.T + n * np.eye(n)
    B = dense_op(Bm, dtype)
    U = rand_block(1, n, 3, dtype)
    G = gram_self(U, B)
    expect = np.asarray(U).conj().T @ Bm @ np.asarray(U)
    np.testing.assert_allclose(np.asarray(G), expect, rtol=1e-10)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.complex128])
def test_gram_cross_rectangular(dtype):
    n = 15
    V = rand_block(2, n, 5, dtype)
    U = rand_block(3, n, 3, dtype)
    G = gram_cross(V, U)
    assert G.shape == (5, 3)
    np.testing.assert_allclose(
        np.asarray(G), np.asarray(V).conj().T @ np.asarray(U), rtol=1e-10
    )


def test_gram_mat_variants():
    n, k = 8, 3
    rng = np.random.RandomState(7)
    mat = rng.randn(n, n)
    mat = mat + mat.T
    U = rand_block(4, n, k, jnp.float64)
    V = rand_block(5, n, k, jnp.float64)
    np.testing.assert_allclose(
        np.asarray(gram_self_mat(U, jnp.asarray(mat))),
        np.asarray(U).T @ mat @ np.asarray(U),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(gram_cross_mat(V, U, jnp.asarray(mat))),
        np.asarray(V).T @ mat @ np.asarray(U),
        rtol=1e-10,
    )


def test_ortho_err_signature_diag():
    # |G_jj| - 1 handles +-1 signature diagonals
    # (reference `ortho_err_upper_impl.inc:2-13`).
    G = jnp.diag(jnp.array([1.0, -1.0, 1.0]))
    assert float(ortho_err(G)) < 1e-14
    G2 = G.at[0, 1].set(0.3)
    assert abs(float(ortho_err(G2)) - 0.3) < 1e-12


def test_ortho_err_respects_mask():
    G = jnp.eye(4).at[3, 3].set(7.0).at[2, 3].set(5.0)
    assert float(ortho_err(G, 3)) < 1e-14


def test_mixed_chunk_hdot_matches_unchunked():
    """Row-chunked widened Grams (mixed_chunk_ctx: the f64-emulation
    memory bound) accumulate the same f64 values as the unchunked dot up
    to addition order, handle the non-divisible-row remainder, and stay
    off for non-widened dots and sub-threshold sizes."""
    import jax

    from lobpcg_tpu.ops.gram import gram_self, mixed_chunk_ctx

    n, k = 1000, 6  # 1000 = 7*128 + 104: exercises the remainder path
    U = rand_block(21, n, k, jnp.float32)
    ref = np.asarray(gram_self(U, out_dtype=jnp.float64))
    assert ref.dtype == np.float64

    with mixed_chunk_ctx(128):
        chunked = np.asarray(gram_self(U, out_dtype=jnp.float64))
        # Also under jit (scan + remainder must trace).
        jitted = np.asarray(
            jax.jit(lambda u: gram_self(u, out_dtype=jnp.float64))(U)
        )
        # Non-widened dot: chunking must NOT engage (bit-identical to
        # the plain matmul).
        plain = np.asarray(gram_self(U))
        n_small = np.asarray(gram_self(U[:100], out_dtype=jnp.float64))
    np.testing.assert_allclose(chunked, ref, rtol=1e-14, atol=1e-12)
    np.testing.assert_allclose(jitted, ref, rtol=1e-14, atol=1e-12)
    np.testing.assert_array_equal(plain, np.asarray(gram_self(U)))
    np.testing.assert_allclose(
        n_small, np.asarray(gram_self(U[:100], out_dtype=jnp.float64)),
        rtol=1e-14,
    )

    # Complex widening path (c64 storage -> c128 accumulate).
    Uc = rand_block(22, 300, 4, jnp.complex64)
    refc = np.asarray(gram_self(Uc, out_dtype=jnp.complex128))
    with mixed_chunk_ctx(64):
        chc = np.asarray(gram_self(Uc, out_dtype=jnp.complex128))
    np.testing.assert_allclose(chc, refc, rtol=1e-13, atol=1e-12)
