"""Per-iteration trajectory dump for the BdG well solve (diagnosis aid).

Runs the same problem construction as solve_bdg.py with
`record_history=True` and prints a compact JSON trajectory: per
iteration the converged prefix, max/min residual over nev, the quality
flag (1 good / 5 dual / +8 rr-fail / +16 stall-perturbed), and the
first few eigenvalues' drift against the truncated-well oracle — the
raw material for diagnosing wide-subspace (ss=256) convergence.

Usage: python benchmarks/trace_solve.py --n 20000 --nev 150 --size-sub 256
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from solve_bdg import (  # noqa: E402
    BARRIER,
    WELL,
    well_eigs_oracle,
    well_problem,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--nev", type=int, default=150)
    ap.add_argument("--size-sub", type=int, default=256)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--max-iter", type=int, default=120)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rr-dtype", default=None)
    ap.add_argument("--no-b-cache", action="store_true")
    ap.add_argument("--no-dual-basis", action="store_true")
    ap.add_argument("--no-precond", action="store_true")
    ap.add_argument("--every", type=int, default=1,
                    help="print every Nth iteration")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from lobpcg_tpu import SolverConfig, ilobpcg

    dtype = jnp.dtype(args.dtype)
    n, nev, ss = args.n, args.nev, args.size_sub
    A, B, T, x0_np = well_problem(n, ss, dtype,
                                  precond=not args.no_precond)
    X0 = jnp.asarray(x0_np, dtype)

    cfg = SolverConfig(
        nev=nev, size_sub=ss, tol=args.tol, max_iter=args.max_iter,
        use_b_cache=not args.no_b_cache,
        dual_basis=not args.no_dual_basis,
        rr_dtype=args.rr_dtype,
        record_history=True,
    )
    r = ilobpcg(A, X0, B, T, config=cfg, key=jax.random.PRNGKey(0))
    h = r.history
    lam_h = np.asarray(h.eigenvalues)  # [max_iter, m]
    res_h = np.asarray(h.residual_norms)  # [max_iter, nev]
    conv_h = np.asarray(h.converged)  # [max_iter]
    flag_h = np.asarray(h.flags)  # [max_iter]
    its = int(r.iterations)
    exact = well_eigs_oracle(WELL, nev, BARRIER)

    print(json.dumps({
        "n": n, "nev": nev, "size_sub": ss, "tol": args.tol,
        "dtype": str(dtype), "rr_dtype": str(cfg.resolved_rr_dtype(dtype)),
        "iterations": its, "converged": int(r.converged),
        "quality5": int(r.quality5_count), "rr_failed": int(r.rr_fail_count),
        "device": jax.devices()[0].device_kind,
        "max_rel_err": float(np.max(
            np.abs(np.asarray(r.eigenvalues) - exact) / np.abs(exact))),
    }), flush=True)
    for i in range(0, its, args.every):
        lam_err = np.abs(lam_h[i, :nev] - exact) / np.abs(exact)
        print(json.dumps({
            "it": i, "conv": int(conv_h[i]), "flag": int(flag_h[i]),
            "res_max": float(res_h[i].max()),
            "res_min": float(res_h[i].min()),
            "res_med": float(np.median(res_h[i])),
            "lam_err_max": float(lam_err.max()),
            "lam_err_med": float(np.median(lam_err)),
            "lam0": float(lam_h[i, 0]), "lam_last": float(lam_h[i, nev - 1]),
        }), flush=True)


if __name__ == "__main__":
    main()
