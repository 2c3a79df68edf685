"""Phase profile of the flagship BdG solve.

The reference's cost model (SURVEY.md §3.1) ranks the hot loop as
(1) operator applications, (2) tall GEMMs (Grams + project-back),
(3) small dense eigensolves.  This script measures each phase of the
device solve separately at the flagship shape and prints a per-iteration
phase table plus the fraction of the measured end-to-end iteration cost
each phase explains — so kernel work can be prioritized by data.

Phases (one ilobpcg iteration, AX + B caches on — the r3 data flow):
  A_apply        A @ [n, ss] (stencil SpMM) — residual/AXn
  B_apply        B @ [n, ss] (antidiag swap) — x2 for the BX/BP cache,
                 x1 for the residual's B Xn
  gram_blocks_pre  S^H (B S) from pre-applied blocks (6 upper-triangle
                 dots, zero operator applications)
  a_gram         S^H A S with AX cache (2 A-applies + 6 triangle dots)
  project_back   [X, P] = S [Cx | Cp] (2 tall GEMMs)
  ortho_pass     one ortho_indefinite outer pass with Bvb supplied
                 (projection via (BV)^H U + svqb; seed + inner B-applies)
  pencil_eig     KPS reduction + eigh on the (3 ss) x (3 ss) pencil

Usage: python benchmarks/profile_solve.py [--n 4000000] [--ss 128]
Prints one JSON line with the phase table (ms) and fractions.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

WELL, BARRIER, SHIFT = 1024, 1.0, 1.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4_000_000)
    ap.add_argument("--ss", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lobpcg_tpu import (
        BlockAntiDiagOperator,
        DiagonalOperator,
        Laplacian1D,
    )
    from lobpcg_tpu.ops.gram import b_mm, gram_blocks_pre
    from lobpcg_tpu.ops.ortho import ortho_indefinite
    from lobpcg_tpu.ops.pencil import pencil_eig_cholesky
    from lobpcg_tpu.ops.rayleigh import _a_gram

    n, ss = args.n, args.ss
    m = n // 2
    lo = (m - WELL) // 2
    V = np.full(m, BARRIER + SHIFT, np.float64)
    V[lo : lo + WELL] = SHIFT
    Vd = jnp.asarray(V, jnp.float32)
    # Segmented form (see solve_bdg.py): no BlockDiag slice+concat.
    A = Laplacian1D(scale=jnp.asarray(1.0, jnp.float32), n=n,
                    segments=2) + DiagonalOperator(
        jnp.concatenate([Vd, Vd]))
    B = BlockAntiDiagOperator(d=jnp.ones((m,), jnp.float32))

    key = jax.random.PRNGKey(0)
    kx, kp, kw = jax.random.split(key, 3)
    X = jax.random.uniform(kx, (n, ss), jnp.float32, -0.5, 0.5)
    P = jax.random.uniform(kp, (n, ss), jnp.float32, -0.5, 0.5)
    W = jax.random.uniform(kw, (n, ss), jnp.float32, -0.5, 0.5)
    AX = A.matmat(X)
    k3 = 3 * ss
    C = jax.random.uniform(key, (k3, ss), jnp.float32, -0.5, 0.5)
    GA = np.asarray(
        jax.random.uniform(key, (k3, k3), jnp.float32, -0.5, 0.5)
    )
    GA = jnp.asarray(GA @ GA.T + k3 * np.eye(k3), jnp.float32)
    GB = jnp.asarray(
        np.diag(np.where(np.arange(k3) % 2 == 0, 1.0, -1.0)),
        jnp.float32,
    )

    phases = {
        "A_apply": jax.jit(lambda X: A.matmat(X)),
        "B_apply": jax.jit(lambda X: B.matmat(X)),
        "gram_blocks_pre": jax.jit(
            lambda X, P, W, BX, BP, BW: gram_blocks_pre(
                (X, P, W), (BX, BP, BW)
            )
        ),
        "a_gram": jax.jit(
            lambda X, P, W, AX: _a_gram((X, P, W), AX, A)
        ),
        "project_back": jax.jit(
            lambda X, P, W, C: (b_mm((X, P, W), C), b_mm((X, P, W), C))
        ),
        "ortho_pass": jax.jit(
            lambda W, X, P, BX, BP: ortho_indefinite(
                W, ss, (X, P), 2 * ss, B,
                eps_ortho=1e-5, eps_drop=1e-5, max_outer=1, max_inner=1,
                Bvb=(BX, BP),
            )[0]
        ),
        "pencil_eig": jax.jit(
            lambda GA, GB: pencil_eig_cholesky(GA, GB, 1e-20)[:2]
        ),
        # The ortho_skip best case: entry check fires
        # on an already-B-orthonormal W, the whole projection+SVQB pass
        # is skipped, and the phase costs one B-apply + 2 small dots.
        "ortho_entry_skip": jax.jit(
            lambda W, X, P, BX, BP: ortho_indefinite(
                W, ss, (X, P), 2 * ss, B,
                eps_ortho=1e-5, eps_drop=1e-5, max_outer=1, max_inner=1,
                Bvb=(BX, BP), entry_check=True,
            )[0]
        ),
    }
    BX, BP, BW = B.matmat(X), B.matmat(P), B.matmat(W)
    # An orthonormalized W whose entry check passes: run one full pass
    # (it both projects against [X, P] and B-orthonormalizes).
    W_on, _ = ortho_indefinite(
        W, ss, (X, P), 2 * ss, B, eps_ortho=1e-5, eps_drop=1e-5,
        Bvb=(BX, BP),
    )
    phase_args = {
        "A_apply": (X,),
        "B_apply": (X,),
        "gram_blocks_pre": (X, P, W, BX, BP, BW),
        "a_gram": (X, P, W, AX),
        "project_back": (X, P, W, C),
        "ortho_pass": (W, X, P, BX, BP),
        "pencil_eig": (GA, GB),
        "ortho_entry_skip": (W_on, X, P, BX, BP),
    }

    def timed(f, fargs, reps):
        out = f(*fargs)
        jax.block_until_ready(out)
        leaf = jax.tree_util.tree_leaves(out)[0]
        float(jnp.sum(jnp.abs(leaf.reshape(-1)[:8]).astype(jnp.float32)))

        def loop():
            t0 = time.perf_counter()
            for _ in range(reps):
                out = f(*fargs)
            leaf = jax.tree_util.tree_leaves(out)[0]
            float(jnp.sum(jnp.abs(leaf.reshape(-1)[:8]).astype(jnp.float32)))
            return (time.perf_counter() - t0) / reps

        loop()
        return min(loop() for _ in range(3))

    table = {}
    for name, f in phases.items():
        table[name] = timed(f, phase_args[name], args.reps) * 1e3
        print(f"# {name}: {table[name]:.2f} ms", flush=True)

    # Per-iteration cost model (AX + B caches on, good-quality path):
    #   cache: 2 B-applies (BX, BP) feed ortho + B-Gram
    #   ortho: ~1 ortho_indefinite outer pass (typ. converges in 1)
    #   RR: a_gram (includes 2 A-applies) + gram_blocks_pre + pencil_eig
    #   projection: project_back (Xn and Pn)
    #   residual: A_apply (AXn) + B_apply (B Xn) + elementwise
    model_ms = (
        table["a_gram"] + table["gram_blocks_pre"] + table["pencil_eig"]
        + table["project_back"] + table["A_apply"] + 3 * table["B_apply"]
        + table["ortho_pass"]
    )
    contribs = dict(table)
    # Informational phase, not part of the per-iteration model.
    contribs.pop("ortho_entry_skip", None)
    contribs["B_apply"] *= 3  # 2 cache applies + 1 residual apply
    fractions = {k: round(v / model_ms, 3) for k, v in contribs.items()}
    print(json.dumps({
        "metric": "ilobpcg_phase_profile",
        "value": model_ms,
        "unit": "ms/iteration (modeled)",
        "n": n, "size_sub": ss,
        "phase_ms": {k: round(v, 2) for k, v in table.items()},
        "fractions_of_model": fractions,
        "device": str(jax.devices()[0].device_kind),
    }))


if __name__ == "__main__":
    main()
