"""Smallest example: 3 lowest eigenpairs of the 1-D Dirichlet Laplacian.

The reference planned (but never shipped) an examples/ directory
(`/root/reference/examples/Makefile`, `TODO.md:371-372`); these scripts
fill that role.

Run: python examples/laplacian_1d.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from lobpcg_tpu import Laplacian1D, lobpcg

# Note on f32 + operator scale: the convergence test is backward error
# relative to ||A|| ~ 4/h^2, so at large n a loose tol accepts eigenvalues
# far from the spectrum's bottom.  In f32 keep n moderate and tol tight
# (or use SolverConfig(rr_dtype="float64") — see fft_matrix_free.py).
n = 256
h = 1.0 / (n + 1)
A = Laplacian1D(scale=jnp.asarray(1.0 / (h * h), jnp.float32), n=n)

result = lobpcg(A, nev=3, size_sub=6, tol=1e-6, max_iter=300,
                key=jax.random.PRNGKey(0))

exact = (np.arange(1, 4) * np.pi) ** 2
print("eigenvalues:", np.asarray(result.eigenvalues))
print("analytic:   ", exact)
print("iterations: ", int(result.iterations),
      " converged:", int(result.converged))
