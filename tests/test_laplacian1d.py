"""Laplacian1D, the plain pad/slice stencil, against the dense oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from lobpcg_tpu import Laplacian1D
from fixtures import rand_block


def _dense(n, segments, scale):
    seg = n // segments
    T = 2 * np.eye(seg) - np.eye(seg, k=1) - np.eye(seg, k=-1)
    return scale * np.kron(np.eye(segments), T)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("segments", [1, 2, 16])
@pytest.mark.parametrize("k", [1, 64, 128, 256])
def test_laplacian1d_matches_dense(k, segments, dtype):
    """Every width (the apply is width-indifferent) and segment count,
    both Dirichlet edges and every segment boundary included."""
    n, scale = 128, 2.5
    A = Laplacian1D(scale=jnp.asarray(scale, dtype), n=n, segments=segments)
    X = rand_block(k + segments, n, k, dtype)
    Y = A.matmat(X)
    assert Y.shape == (n, k) and Y.dtype == dtype
    ref = _dense(n, segments, scale) @ np.asarray(X, np.float64)
    # Four roundings per row (three terms and the scale), ||A||_inf =
    # 4 * scale, |x| <= 0.5.
    eps = float(jnp.finfo(dtype).eps) / 2
    np.testing.assert_allclose(np.asarray(Y, np.float64), ref, rtol=0,
                               atol=4 * eps * 4 * scale * 0.5)
