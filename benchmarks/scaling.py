"""Strong-scaling harness: row-sharded indefinite BdG solve over a mesh.

BASELINE.json scaling target: >= 75% efficiency at N >= 2 devices on
the BdG pencil.  On a multi-GPU host this measures real scaling over
the interconnect; with --force-cpu it runs the identical sharded program
on a virtual device mesh (XLA_FLAGS=--xla_force_host_platform_device_count),
which validates the SPMD lowering (psum'd Grams, halo collective-permutes)
but not wall-clock scaling — the JSON notes which one it measured.

Usage: python benchmarks/scaling.py [--n 1048576] [--nev 16]
       [--devices 1 2 4 8] [--force-cpu]
Prints one JSON line per mesh size, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--nev", type=int, default=16)
    ap.add_argument("--size-sub", type=int, default=0)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--max-iter", type=int, default=60)
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--force-cpu", action="store_true")
    args = ap.parse_args()

    import os

    if args.force_cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()

    import jax
    import jax.numpy as jnp

    if args.force_cpu:
        jax.config.update("jax_platforms", "cpu")

    from lobpcg_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from benchmarks.solve_bdg import BARRIER, SHIFT, WELL  # noqa: F401
    from lobpcg_tpu import (
        BlockAntiDiagOperator,
        BlockDiagOperator,
        DiagonalOperator,
        Laplacian1D,
        SolverConfig,
        ilobpcg,
    )
    from lobpcg_tpu.parallel import row_mesh, shard_problem

    n_avail = len(jax.devices())
    sizes = args.devices or sorted(
        {s for s in (1, 2, 4, 8) if s <= n_avail}
    )
    real_scaling = n_avail >= 2 and jax.devices()[0].platform == "gpu"

    dtype = jnp.float32
    n = args.n
    m = n // 2
    nev = args.nev
    ss = args.size_sub or nev + 14

    lo = (m - WELL) // 2
    V = np.full(m, BARRIER + SHIFT, np.float64)
    V[lo : lo + WELL] = SHIFT
    rng = np.random.RandomState(42)
    u = np.zeros((m, ss), np.float32)
    u[lo : lo + WELL] = rng.uniform(-0.5, 0.5, size=(WELL, ss))
    X0_np = np.concatenate([u, u], axis=0)

    cfg = SolverConfig(nev=nev, size_sub=ss, tol=args.tol,
                       max_iter=args.max_iter)

    results = {}
    for nd in sizes:
        mesh = row_mesh(nd)
        Vd = jnp.asarray(V, dtype)
        K = (
            Laplacian1D(scale=jnp.asarray(1.0, dtype), n=m)
            + DiagonalOperator(Vd)
        )
        A = BlockDiagOperator(inner=K, copies=2)
        B = BlockAntiDiagOperator(d=jnp.ones((m,), dtype))
        X0 = jnp.asarray(X0_np, dtype)
        As, X0s, Bs, _ = shard_problem(mesh, A, X0, B)

        with mesh:
            r = ilobpcg(As, X0s, Bs, config=cfg, key=jax.random.PRNGKey(0))
            jax.block_until_ready(r.eigenvalues)
            t0 = time.perf_counter()
            r = ilobpcg(As, X0s, Bs, config=cfg, key=jax.random.PRNGKey(0))
            lam = np.asarray(r.eigenvalues)
        wall = time.perf_counter() - t0
        results[nd] = wall
        print(json.dumps({
            "metric": "ilobpcg_bdg_well_sharded_wall_clock",
            "value": wall,
            "unit": "s",
            "devices": nd,
            "n": n,
            "nev": nev,
            "iterations": int(r.iterations),
            "converged": int(r.converged),
            "lam0": float(lam[0]),
            "device": {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": nd},
        }))

    if len(results) > 1:
        base = min(results)
        eff = {
            nd: results[base] * base / (nd * results[nd]) for nd in results
        }
        print(json.dumps({
            "metric": "scaling_efficiency",
            "value": eff[max(results)],
            "unit": "fraction",
            "per_mesh": {str(k): round(v, 4) for k, v in eff.items()},
            "real_gpu_scaling": real_scaling,
            "note": (
                "real multi-GPU scaling" if real_scaling else
                "virtual-device SPMD validation only (CPU); wall-clock "
                "efficiency is not meaningful"
            ),
        }))


if __name__ == "__main__":
    main()
