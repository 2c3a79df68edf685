"""Complex Hermitian pencils solved in real arithmetic (split-real).

The realification layer embeds a complex Hermitian pencil
A z = lambda B z into a real symmetric pencil of twice the dimension
with a doubled spectrum, solves it in pure f32 real arithmetic, and
folds the duplicated pairs back into complex eigenpairs on the host.
The complex-specified operators are built on the host device, so the
solve device only ever sees the real arrays.

Run: python examples/complex_split_real.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from lobpcg_tpu import SolverConfig, ilobpcg
from lobpcg_tpu.operators.realify import derealify, realify_problem

m, nev, ss = 256, 3, 6
cpu = jax.devices("cpu")[0]
with jax.default_device(cpu):  # complex data stays on the host
    from lobpcg_tpu import (
        BlockAntiDiagOperator,
        BlockDiagOperator,
        Laplacian1D,
    )

    h = 1.0 / (m + 1)
    K = Laplacian1D(scale=jnp.asarray(1.0 / (h * h), jnp.complex128), n=m)
    A = BlockDiagOperator(inner=K, copies=2)
    B = BlockAntiDiagOperator(d=jnp.ones((m,), jnp.complex128))
    rng = np.random.RandomState(42)
    u = rng.uniform(-0.5, 0.5, size=(m, ss))
    X0 = jnp.asarray(np.concatenate([u, u], axis=0), jnp.complex128)

    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-5, max_iter=400)
    # Embed into the real pencil, downcast to f32 for the chip.
    Ar, X0r, Br, _, cfgr = realify_problem(A, X0, B, config=cfg,
                                           rdt=jnp.float32)

r = ilobpcg(Ar, X0r, Br, config=cfgr)  # runs on the accelerator, all-real
lam, vec, res = derealify(r, nev)

print("device:", jax.devices()[0].device_kind)
print("eigenvalues:", lam)
print("analytic:   ", (np.arange(1, nev + 1) * np.pi) ** 2)
print("eigenvectors are complex:", vec.dtype, vec.shape)
