"""Observability: verbosity logging + per-iteration history recording
(the jit-compatible replacement for the reference's verbosity printf,
`src/core/lobpcg_impl.inc:118-124,230-238`)."""

import numpy as np
import jax.numpy as jnp

from lobpcg_tpu import SolverConfig, ilobpcg, lobpcg
from fixtures import bdg_ops, bdg_positive_init, laplacian_op, rand_block


def test_history_recorded():
    n, nev, ss = 100, 3, 6
    A = laplacian_op(n, jnp.float64)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-6, max_iter=100,
                       record_history=True)
    r = lobpcg(A, rand_block(3, n, ss, jnp.float64), config=cfg)
    h = r.history
    assert h is not None
    it = int(r.iterations)
    assert 0 < it <= 100
    assert h.eigenvalues.shape == (100, ss)
    assert h.residual_norms.shape == (100, nev)
    # Final recorded row matches the returned state.
    np.testing.assert_allclose(
        np.asarray(h.eigenvalues[it - 1, :nev]), np.asarray(r.eigenvalues)
    )
    np.testing.assert_allclose(
        np.asarray(h.residual_norms[it - 1]), np.asarray(r.residual_norms)
    )
    assert int(h.converged[it - 1]) == int(r.converged)
    # Rows past the final iteration are untouched (zero).
    assert np.all(np.asarray(h.eigenvalues[it:]) == 0)
    # Converged counts are recorded and end at nev.
    assert int(h.converged[it - 1]) == nev


def test_history_off_by_default():
    n, nev, ss = 60, 2, 4
    A = laplacian_op(n, jnp.float64)
    r = lobpcg(A, rand_block(3, n, ss, jnp.float64), nev=nev, size_sub=ss,
               tol=1e-4, max_iter=50)
    assert r.history is None


def test_ilobpcg_history():
    m, nev, ss = 100, 3, 6
    A, B = bdg_ops(m, jnp.float64)
    X0 = bdg_positive_init(42, m, ss, jnp.float64)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-5, max_iter=200,
                       record_history=True)
    r = ilobpcg(A, X0, B, config=cfg)
    it = int(r.iterations)
    np.testing.assert_allclose(
        np.asarray(r.history.eigenvalues[it - 1, :nev]),
        np.asarray(r.eigenvalues),
    )


def test_verbosity_prints(capfd):
    n, nev, ss = 60, 2, 4
    A = laplacian_op(n, jnp.float64)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-4, max_iter=50,
                       verbosity=1)
    r = lobpcg(A, rand_block(3, n, ss, jnp.float64), config=cfg)
    np.asarray(r.eigenvalues)  # block until callbacks flush
    out, _ = capfd.readouterr()
    assert "[lobpcg]" in out
    assert "converged" in out
    assert "||A||" in out


def test_timed_helper():
    from lobpcg_tpu.utils.profiling import timed

    import jax

    f = jax.jit(lambda x: x * 2.0)
    out, dt = timed(f, jnp.ones((8,)), warmup=1, reps=2)
    assert dt >= 0
    np.testing.assert_allclose(np.asarray(out), 2.0)
