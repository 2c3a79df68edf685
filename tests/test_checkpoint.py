"""Checkpoint / resume: warm restart from the saved X basis
(reference analog: caller-provided S reuse, `src/core/lobpcg_impl.inc:92-96`)."""

import numpy as np
import jax.numpy as jnp

from lobpcg_tpu import SolverConfig, ilobpcg, lobpcg
from lobpcg_tpu.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    solve_checkpointed,
)
from fixtures import (
    bdg_ops,
    bdg_positive_init,
    laplacian_exact,
    laplacian_op,
    rand_block,
)


def test_save_load_roundtrip(tmp_path):
    p = tmp_path / "ck.npz"
    X = np.random.RandomState(0).randn(20, 4)
    save_checkpoint(p, X, np.array([1.0, 2.0]), iterations=7,
                    meta={"converged": 1})
    ck = load_checkpoint(p)
    np.testing.assert_array_equal(ck["basis"], X)
    assert ck["iterations"] == 7
    np.testing.assert_array_equal(ck["eigenvalues"], [1.0, 2.0])
    assert ck["meta_converged"] == 1


def test_warm_restart_matches_full_solve():
    """Stopping after k iterations and re-entering from the basis reaches
    the same eigenvalues as an uninterrupted solve."""
    n, nev, ss = 100, 3, 6
    A = laplacian_op(n, jnp.float64)
    X0 = rand_block(5, n, ss, jnp.float64)

    full = lobpcg(A, X0, nev=nev, size_sub=ss, tol=1e-7, max_iter=200)

    part = lobpcg(A, X0, nev=nev, size_sub=ss, tol=1e-7, max_iter=5)
    assert int(part.converged) < nev
    resumed = lobpcg(A, part.basis, nev=nev, size_sub=ss, tol=1e-7,
                     max_iter=200)
    assert int(resumed.converged) == nev
    np.testing.assert_allclose(
        np.asarray(resumed.eigenvalues), np.asarray(full.eigenvalues),
        rtol=1e-8,
    )


def test_solve_checkpointed_lobpcg(tmp_path):
    n, nev, ss = 100, 3, 6
    A = laplacian_op(n, jnp.float64)
    X0 = rand_block(5, n, ss, jnp.float64)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-6, max_iter=200)
    p = tmp_path / "solve.npz"
    r = solve_checkpointed(lobpcg, A, X0, config=cfg, path=p, every=7)
    assert int(r.converged) == nev
    exact = laplacian_exact(np.arange(1, nev + 1))
    rel = np.abs(np.asarray(r.eigenvalues) - exact) / exact
    assert np.all(rel < 1e-2)
    # Snapshot exists and holds the final basis.
    ck = load_checkpoint(p)
    assert ck["basis"].shape == (n, ss)
    assert ck["meta_converged"] == nev


def test_solve_checkpointed_resume(tmp_path):
    """Kill after the first chunk; a fresh call resumes from disk and
    converges without restarting from scratch."""
    n, nev, ss = 100, 3, 6
    A = laplacian_op(n, jnp.float64)
    X0 = rand_block(5, n, ss, jnp.float64)
    p = tmp_path / "solve.npz"

    # "Crashed" run: only one chunk of 4 iterations.
    cfg_short = SolverConfig(nev=nev, size_sub=ss, tol=1e-6, max_iter=4)
    solve_checkpointed(lobpcg, A, X0, config=cfg_short, path=p, every=4)
    it0 = load_checkpoint(p)["iterations"]
    assert it0 == 4

    # Resumed run continues the iteration count.
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-6, max_iter=200)
    r = solve_checkpointed(lobpcg, A, None, config=cfg, path=p, every=10)
    assert int(r.converged) == nev
    assert int(r.iterations) > it0


def test_solve_checkpointed_ilobpcg(tmp_path):
    m, nev, ss = 100, 3, 6
    A, B = bdg_ops(m, jnp.float64)
    X0 = bdg_positive_init(42, m, ss, jnp.float64)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-5, max_iter=300)
    r = solve_checkpointed(ilobpcg, A, X0, B, config=cfg,
                           path=tmp_path / "i.npz", every=20)
    assert int(r.converged) == nev
    exact = laplacian_exact(np.arange(1, nev + 1))
    rel = np.abs(np.asarray(r.eigenvalues) - exact) / exact
    assert np.all(rel < 1e-2)


def test_solve_checkpointed_single_compile(tmp_path):
    """Chunked solving must not recompile per chunk size: the tail chunk
    (max_iter % every != 0) goes through the runtime it_cap, so the
    whole run adds exactly ONE trace to the jit cache (a full-size
    recompile per chunk shape costs tens of seconds)."""
    from lobpcg_tpu.solvers.lobpcg import _lobpcg_jit

    n, nev, ss = 100, 3, 6
    A = laplacian_op(n, jnp.float64)
    X0 = rand_block(5, n, ss, jnp.float64)
    # max_iter=25, every=10 -> chunks of 10, 10, 5 (distinct tail).
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-12, max_iter=25)
    before = _lobpcg_jit._cache_size()
    solve_checkpointed(lobpcg, A, X0, config=cfg,
                       path=tmp_path / "c.npz", every=10)
    assert _lobpcg_jit._cache_size() - before == 1


def test_momentum_resume_fewer_iterations():
    """Resuming with the saved P block converges in no more total
    iterations than the uninterrupted run (X-only restarts pay re-ramp
    iterations every chunk)."""
    n, nev, ss = 100, 3, 6
    A = laplacian_op(n, jnp.float64)
    X0 = rand_block(5, n, ss, jnp.float64)

    full = lobpcg(A, X0, nev=nev, size_sub=ss, tol=1e-8, max_iter=400)

    part = lobpcg(A, X0, nev=nev, size_sub=ss, tol=1e-8, max_iter=10)
    warm = lobpcg(A, part.basis, P0=part.momentum, nev=nev, size_sub=ss,
                  tol=1e-8, max_iter=400)
    cold = lobpcg(A, part.basis, nev=nev, size_sub=ss, tol=1e-8,
                  max_iter=400)
    assert int(warm.converged) == nev
    assert int(cold.converged) == nev
    total_warm = 10 + int(warm.iterations)
    # Close to the uninterrupted count (an X-only restart can pay a few
    # re-ramp iterations; the momentum restart should not add more).
    assert total_warm <= int(full.iterations) + 8


def test_p0_non_prefix_compacted():
    """A user-assembled P0 with scattered nonzero columns is compacted to
    the prefix the solver invariant requires (no NaN poisoning)."""
    n, nev, ss = 100, 3, 6
    A = laplacian_op(n, jnp.float64)
    X0 = rand_block(5, n, ss, jnp.float64)
    part = lobpcg(A, X0, nev=nev, size_sub=ss, tol=1e-8, max_iter=10)
    P = np.asarray(part.momentum).copy()
    P[:, 1] = 0.0  # punch a hole: nonzero cols no longer a prefix
    r = lobpcg(A, part.basis, P0=jnp.asarray(P), nev=nev, size_sub=ss,
               tol=1e-8, max_iter=400)
    assert int(r.converged) == nev
    assert np.all(np.isfinite(np.asarray(r.eigenvalues)))


def test_p0_shape_validated():
    n, nev, ss = 60, 2, 4
    A = laplacian_op(n, jnp.float64)
    X0 = rand_block(1, n, ss, jnp.float64)
    import pytest

    with pytest.raises(ValueError, match="P0"):
        lobpcg(A, X0, P0=X0[:, :2], nev=nev, size_sub=ss)
