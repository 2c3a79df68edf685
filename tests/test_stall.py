"""Stagnation stabilizer (SolverConfig.stall_reset).

The reference driver has no stagnation handling: near the f32
convergence floor a failed projected-pencil solve discards the iteration
and rebuilds W from X deterministically (`ilobpcg_impl.inc:228-256`
carries garbage; our do_recover discards), so the retry can cycle —
measured on the previous accelerator as a 5.6x iteration spread across
bit-identical problems.  stall_reset perturbs W with
column-norm-scaled noise after K non-improving iterations (rr-failed
iterations jump the counter to the threshold).

These tests check the mechanics on CPU: the perturbation preserves the
dead-column invariant, fires when forced, stays silent on healthy
solves, and does not change what the solve converges to.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lobpcg_tpu import SolverConfig, ilobpcg
from fixtures import bdg_ops, bdg_positive_init


def _solve(dtype, *, stall_reset=0, tol=1e-8, history=False, max_iter=300):
    m = 100
    A, B = bdg_ops(m, dtype)
    X0 = bdg_positive_init(3, m, 6, dtype)
    cfg = SolverConfig(nev=4, size_sub=6, tol=tol, max_iter=max_iter,
                       stall_reset=stall_reset, record_history=history)
    return ilobpcg(A, X0, B, config=cfg)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.complex128])
def test_stall_reset_converges_to_same_eigenvalues(dtype):
    r0 = _solve(dtype)
    r1 = _solve(dtype, stall_reset=1)  # pathologically aggressive
    np.testing.assert_allclose(
        np.asarray(r1.eigenvalues), np.asarray(r0.eigenvalues), rtol=1e-6
    )
    assert int(r1.converged) >= 4


def test_stall_trips_are_recorded_in_history_flags():
    r = _solve(jnp.float64, stall_reset=1, history=True)
    flags = np.asarray(r.history.flags[: int(r.iterations)])
    assert (flags >= 16).any(), "stall_reset=1 never fired"
    # flag layout: quality + 8*rr_fail + 16*tripped stays decodable
    assert flags.max() < 32


def test_healthy_solve_never_trips_at_sane_threshold():
    # A well-separated f64 solve improves every iteration: with a
    # realistic K the perturbation must stay silent, making the program
    # behave identically to stall_reset=0 (same iteration count).
    r0 = _solve(jnp.float64, stall_reset=0, history=True)
    r6 = _solve(jnp.float64, stall_reset=25, history=True)
    flags = np.asarray(r6.history.flags[: int(r6.iterations)])
    assert not (flags >= 16).any()
    assert int(r6.iterations) == int(r0.iterations)


def test_perturbation_preserves_dead_column_invariant():
    # Converged trailing solve state: momentum/basis dead columns stay
    # exactly zero even with the perturbation firing (column-norm
    # scaling zeroes the noise on zero columns).
    r = _solve(jnp.float64, stall_reset=1)
    P = np.asarray(r.momentum)
    conv = int(r.converged)
    act = P.shape[1] - conv
    if act < P.shape[1]:
        assert np.all(P[:, act:] == 0.0)


def test_stall_reset_validation():
    with pytest.raises(ValueError):
        SolverConfig(nev=2, size_sub=4, stall_reset=-1)
