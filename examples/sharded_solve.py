"""Row-sharded solve over a device mesh.

The operator rows and the tall [n, k] blocks are 1-D partitioned over the
mesh; XLA's SPMD partitioner lowers Gram contractions to local GEMMs +
psum and the stencil to local compute + halo collective-permute.
The solver code is unchanged — sharding is carried by the arrays.

On a machine without multiple accelerators this runs on 8 virtual CPU
devices (set up below) to demonstrate the SPMD program.

Run: python examples/sharded_solve.py
"""

import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

# Virtual 8-device CPU mesh when no multi-chip platform is available.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from lobpcg_tpu import Laplacian1D, lobpcg
from lobpcg_tpu.parallel import row_mesh, shard_problem

from lobpcg_tpu import DiagonalOperator

# Quantum-well Hamiltonian: lattice Laplacian + barrier outside a
# 256-site window.  Low modes are bound states with O(1) separations, so
# the solve converges in tens of iterations at any n (a bare 1/h^2
# Laplacian at this size needs thousands of unpreconditioned iterations).
n, w = 4096, 256
lo = (n - w) // 2
V = np.ones(n)
V[lo : lo + w] = 0.0
A = Laplacian1D(scale=jnp.asarray(1.0, jnp.float64), n=n) + DiagonalOperator(
    jnp.asarray(1.0 + V)
)
X0 = jax.random.uniform(jax.random.PRNGKey(0), (n, 6), jnp.float64,
                        -0.5, 0.5)

mesh = row_mesh(8)
As, X0s, _, _ = shard_problem(mesh, A, X0)

with mesh:
    r = lobpcg(As, X0s, nev=3, size_sub=6, tol=1e-9, max_iter=500)
    lam = np.asarray(r.eigenvalues)

# Oracle: dense eigh of a truncation around the well.
t0, t1 = max(0, lo - 512), min(n, lo + w + 512)
Ht = (np.diag(2.0 + 1.0 + V[t0:t1])
      - np.diag(np.ones(t1 - t0 - 1), 1)
      - np.diag(np.ones(t1 - t0 - 1), -1))
exact = np.linalg.eigvalsh(Ht)[:3]
print("mesh:", mesh)
print("eigenvalues:", lam, " converged:", int(r.converged),
      "iters:", int(r.iterations))
print("dense oracle:", exact)
print("eigenvector sharding:",
      r.eigenvectors.sharding.spec,
      "over", len(r.eigenvectors.addressable_shards), "devices")
