"""The ortho_skip entry check: skip the projection+SVQB pass when W is
already (B-)orthonormal up to column scaling, and only then."""

import numpy as np
import jax.numpy as jnp
import pytest

from lobpcg_tpu import (
    BlockAntiDiagOperator,
    BlockDiagOperator,
    Laplacian1D,
    SolverConfig,
    ilobpcg,
)
from lobpcg_tpu.ops.ortho import ortho_drop, ortho_indefinite
from fixtures import rand_block


# ---------------------------------------------------------------------------
# ortho_skip entry check


def _bdg_ops(m, dtype=jnp.float64):
    h = 1.0 / (m + 1)
    K = Laplacian1D(scale=jnp.asarray(1.0 / (h * h), dtype), n=m)
    A = BlockDiagOperator(inner=K, copies=2)
    B = BlockAntiDiagOperator(d=jnp.ones(m, dtype))
    return A, B


def test_ortho_drop_entry_skip_keeps_orthonormal_basis():
    """An already-orthonormal U (up to column scaling) passes the entry
    check: the loop is skipped and only the scaling is applied."""
    n, kv, ku = 64, 4, 3
    V = jnp.linalg.qr(rand_block(1, n, kv, jnp.float64))[0]
    # U: orthonormal complement directions, deliberately mis-scaled.
    full = jnp.linalg.qr(rand_block(2, n, kv + ku, jnp.float64))[0]
    U0 = full[:, kv:]
    U0 = U0 - V @ (V.T @ U0)
    U0 = jnp.linalg.qr(U0)[0] * jnp.asarray([2.0, 0.5, 7.0])
    U, nu = ortho_drop(
        U0, ku, V, kv, None, eps_ortho=1e-10, eps_drop=1e-10,
        entry_check=True,
    )
    assert int(nu) == ku
    G = np.asarray(U.T @ U)
    np.testing.assert_allclose(G, np.eye(ku), atol=1e-9)
    # Directions preserved: U is exactly a column scaling of U0.
    C = np.asarray(U0.T @ U)  # diagonal iff no projection/SVQB mixing ran
    np.testing.assert_allclose(
        C - np.diag(np.diag(C)), 0.0, atol=1e-9
    )


def test_ortho_indefinite_entry_check_still_orthogonalizes():
    """A non-orthogonal U must come out B-orthonormal with the entry
    check enabled (the skip must not fire when work is needed)."""
    m = 32
    _, B = _bdg_ops(m)
    V = jnp.concatenate(
        [jnp.linalg.qr(rand_block(3, m, 2, jnp.float64))[0] / np.sqrt(2)] * 2
    )
    U0 = rand_block(4, 2 * m, 3, jnp.float64)
    U, nu = ortho_indefinite(
        U0, 3, V, 2, B, eps_ortho=1e-8, eps_drop=1e-8, entry_check=True,
    )
    BU = np.asarray(B.matmat(U))
    G = np.asarray(U).T @ BU
    # B-orthonormal up to signature (|diag| = 1), and B-orthogonal to V.
    np.testing.assert_allclose(np.abs(np.diag(G)), 1.0, atol=1e-7)
    np.testing.assert_allclose(G - np.diag(np.diag(G)), 0.0, atol=1e-7)
    np.testing.assert_allclose(np.asarray(V).T @ BU, 0.0, atol=1e-7)


@pytest.mark.parametrize("skip", [True, False])
def test_ilobpcg_ortho_skip_parity(skip):
    """ortho_skip must not change the BdG spectrum (reference oracle
    ±1%, `tests/test_ilobpcg.c:213-218`)."""
    m, nev, ss = 100, 3, 6
    A, B = _bdg_ops(m)
    X0 = rand_block(7, 2 * m, ss, jnp.float64)
    X0 = X0.at[m:, :].set(X0[:m, :])  # B-positive start [u; u]
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-9, max_iter=300,
                      ortho_skip=skip)
    r = ilobpcg(A, X0, B, config=cfg)
    analytic = (np.arange(1, nev + 1) * np.pi) ** 2
    np.testing.assert_allclose(
        np.asarray(r.eigenvalues), analytic, rtol=1e-2
    )


def test_entry_check_floor_blocks_degenerate_column_skip():
    """A near-B-null column must NOT skip: the 1/sqrt|G_ii|
    scaling would amplify it past the SVQB eps_drop machinery."""
    from lobpcg_tpu.ops.gram import as_blocks, frob_norm
    from lobpcg_tpu.ops.ortho import _entry_state, _guard

    n, kv, ku = 64, 4, 3
    V = jnp.linalg.qr(rand_block(1, n, kv, jnp.float64))[0]
    full = jnp.linalg.qr(rand_block(2, n, kv + ku, jnp.float64))[0]
    U0 = full[:, kv:]
    U0 = U0 - V @ (V.T @ U0)
    U0 = jnp.linalg.qr(U0)[0]
    vb = as_blocks(V, ku)
    bvn = _guard(frob_norm(V), 1e-10)
    for scales, expect in (
        (jnp.asarray([2.0, 0.5, 7.0]), True),     # healthy: skips
        (jnp.asarray([2.0, 1e-9, 7.0]), False),   # degenerate: floor trips
    ):
        _, _, skip = _entry_state(
            U0 * scales, 3, None, vb, None, bvn, 1e-8, 1e-10, None,
            indefinite=False,
        )
        assert bool(skip) == expect, scales
