"""Projected pencil eigensolve unit tests (ops/pencil.py) — the GGEV
replacement (SURVEY.md §7 hard part 1)."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg as sla

from lobpcg_tpu.ops.pencil import (
    pencil_eig,
    pencil_eig_cholesky,
    pencil_eig_qz,
)


def _pencil(k, seed, dtype=np.float64):
    rng = np.random.RandomState(seed)
    M = rng.randn(k, k)
    if np.issubdtype(dtype, np.complexfloating):
        M = M + 1j * rng.randn(k, k)
    GA = M @ M.conj().T + k * np.eye(k)  # HPD
    sig = np.diag(np.where(np.arange(k) % 2 == 0, 1.0, -1.0))
    Q = rng.randn(k, k)
    GB = Q @ sig @ Q.T  # symmetric indefinite
    if np.issubdtype(dtype, np.complexfloating):
        GB = GB.astype(dtype)
    return jnp.asarray(GA, dtype), jnp.asarray(GB, dtype)


def _check_pencil_residual(GA, GB, lam, V, tol):
    GA, GB = np.asarray(GA), np.asarray(GB)
    for j in range(GA.shape[0]):
        v = np.asarray(V)[:, j]
        r = GA @ v - lam[j] * (GB @ v)
        assert np.linalg.norm(r) <= tol * (
            np.linalg.norm(GA) + abs(lam[j]) * np.linalg.norm(GB)
        ), (j, lam[j])


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.complex128])
@pytest.mark.parametrize("k", [4, 9])
def test_cholesky_solves_pencil(dtype, k):
    GA, GB = _pencil(k, 1, np.dtype(dtype))
    lam, V, ok = pencil_eig_cholesky(GA, GB, tiny=1e-30)
    assert bool(ok)
    _check_pencil_residual(GA, GB, np.asarray(lam), V, 1e-10)


@pytest.mark.parametrize("k", [4, 9])
def test_qz_matches_scipy(k):
    GA, GB = _pencil(k, 2)
    lam, V, _ = pencil_eig_qz(GA, GB, tiny=1e-30)
    lam = np.sort(np.asarray(lam))
    w = sla.eig(np.asarray(GA), np.asarray(GB), right=False)
    np.testing.assert_allclose(lam, np.sort(w.real), rtol=1e-9)


def test_cholesky_and_qz_agree():
    GA, GB = _pencil(6, 3)
    lam_c, _, ok = pencil_eig_cholesky(GA, GB, tiny=1e-30)
    lam_q, _, _ = pencil_eig_qz(GA, GB, tiny=1e-30)
    assert bool(ok)
    np.testing.assert_allclose(
        np.sort(np.asarray(lam_c)), np.sort(np.asarray(lam_q)), rtol=1e-8
    )


def test_cholesky_ladder_solves_indefinite_ga():
    """Indefinite GA, definite pencil: the definite-combination ladder
    keeps the Cholesky path fully on-device (the reference handles this
    via LAPACK GGEV, `blas_wrapper.h:489-519`)."""
    k = 5
    rng = np.random.RandomState(4)
    M = rng.randn(k, k)
    GA = jnp.asarray(M + M.T - k * np.eye(k))  # indefinite
    GB = jnp.asarray(np.eye(k))
    lam, V, ok = pencil_eig_cholesky(GA, GB, tiny=1e-30)
    assert bool(ok)
    exact = np.sort(np.linalg.eigvalsh(np.asarray(GA)))
    np.testing.assert_allclose(np.sort(np.asarray(lam)), exact, rtol=1e-9)
    _check_pencil_residual(GA, GB, np.asarray(lam), V, 1e-10)


def test_cholesky_ladder_negative_definite_ga():
    """-GA HPD: candidate (c=-1, s=0) must solve it exactly."""
    k = 4
    rng = np.random.RandomState(7)
    M = rng.randn(k, k)
    GA = jnp.asarray(-(M @ M.T) - k * np.eye(k))  # negative definite
    sig = np.diag([1.0, -1.0, 1.0, -1.0])
    GB = jnp.asarray(sig)
    lam, V, ok = pencil_eig_cholesky(GA, GB, tiny=1e-30)
    assert bool(ok)
    exact = np.sort(np.real(sla.eig(np.asarray(GA), np.asarray(GB),
                                    right=False)))
    np.testing.assert_allclose(np.sort(np.asarray(lam)), exact, rtol=1e-9)


def test_cholesky_flags_nondefinite_pencil():
    """A genuinely non-definite pencil (no HPD combination exists) must
    set ok=False with NaN-poisoned outputs, and 'auto' must recover via
    QZ."""
    J = np.diag([1.0, -1.0])
    GA = jnp.asarray(2.0 * J)
    GB = jnp.asarray(J)
    lam, V, ok = pencil_eig_cholesky(GA, GB, tiny=1e-30)
    assert not bool(ok)
    assert np.all(np.isnan(np.asarray(lam)))

    # auto dispatch recovers via QZ: GA = 2 GB -> lambda = 2, 2.
    lam, V, ok = pencil_eig(GA, GB, method="auto", tiny=1e-30)
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(lam), [2.0, 2.0], rtol=1e-12)


def test_sentinel_on_singular_gb():
    """beta ~ 0 eigenvalues map to +-1e30 sentinels
    (`indefinite_rr_impl.inc:99-108` parity)."""
    k = 4
    GA = jnp.asarray(np.diag([1.0, 2.0, 3.0, 4.0]))
    GB = jnp.asarray(np.diag([1.0, 1.0, 1.0, 0.0]))  # singular
    lam, _, _ = pencil_eig_qz(GA, GB, tiny=1e-12)
    lam = np.asarray(lam)
    assert np.sum(np.abs(lam) >= 1e29) == 1
    assert set(np.round(np.sort(lam[np.abs(lam) < 1e29]), 6)) == {1.0, 2.0, 3.0}


def test_unknown_method_raises():
    GA, GB = _pencil(3, 5)
    with pytest.raises(ValueError):
        pencil_eig(GA, GB, method="nope", tiny=1e-30)
