"""Sparse operator path: 3-D Laplacian as CSR -> block-ELL (BSR) SpMM.

Host-side preprocessing (COO->CSR->BSR blocking) runs through the native
C++ library (built on first use, or by `make -C native`), with
NumPy/SciPy fallbacks; the device runs the block-ELL gather + einsum.

Run: python examples/sparse_3d_laplacian.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from lobpcg_tpu import lobpcg
from lobpcg_tpu.operators.sparse import BSROperator, laplacian_3d_csr
from lobpcg_tpu.utils.native import native_available

nx = 10
indptr, indices, vals = laplacian_3d_csr(nx, nx, nx)
A = BSROperator.from_csr(indptr, indices, vals, block_size=8,
                         dtype=jnp.float64)
print(f"native preprocessing library: "
      f"{'loaded' if native_available() else 'fallback (NumPy/SciPy)'}")

r = lobpcg(A, nev=5, size_sub=10, tol=1e-6, max_iter=300,
           key=jax.random.PRNGKey(1))

h = 1.0 / (nx + 1)
oned = 4.0 / (h * h) * np.sin(np.arange(1, nx + 1) * np.pi * h / 2) ** 2
exact = np.sort(
    (oned[:, None, None] + oned[None, :, None] + oned[None, None, :]).ravel()
)[:5]
print("eigenvalues:", np.asarray(r.eigenvalues))
print("exact:      ", exact)
