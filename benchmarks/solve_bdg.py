"""Wall-clock-to-tolerance benchmark: indefinite LOBPCG on a BdG pencil.

BASELINE.json headline: "wall-clock to tol for 150 eigenpairs at dim 4M".

Workload: the reference's flagship BdG structure (`tests/test_ilobpcg.c:
28-67`) with a quantum-well Hamiltonian K = -Lap_h + V, V = 0 inside a
w-site window and V = barrier outside; A = diag(K, K), B = antidiag(I, I),
B-positive start X0 = [u; u].  The well keeps the low spectrum separated
by ~(k pi / w)^2 — resolvable in f32 at any problem dimension — while the
operator application remains a full n-dimensional stencil SpMM, which is
what wall-clock-to-tol actually measures.  (A bare Laplacian at dim 4M
has its lowest modes clustered to ~1e-11 relative separation: only
end-to-end f64 — the reference's CPU configuration — can converge 150
distinct pairs of it.  See BASELINE.md.)

`well_problem` builds the pencil for any dimension; chip_smoke.py and
benchmarks/scaling.py reuse it.

Usage: python benchmarks/solve_bdg.py [--n 4000000] [--nev 64] [--check]
Prints one JSON line per run.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

# Make the repo importable when run as a script from any directory.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

WELL = 1024  # well width in sites
BARRIER = 1.0  # barrier height (lattice units)
SHIFT = 1.0  # spectrum shift: target eigenvalues are 1 + (k pi / w)^2,
# all O(1), so f32 relative accuracy and convergence gaps are healthy at
# any problem dimension


def well_eigs_oracle(w: int, nev: int, barrier: float, margin: int = 2048):
    """Low eigenvalues of the truncated well Hamiltonian (host, dense)."""
    size = w + 2 * margin
    V = np.full(size, barrier + SHIFT)
    V[margin : margin + w] = SHIFT
    H = (
        np.diag(2.0 + V)
        - np.diag(np.ones(size - 1), 1)
        - np.diag(np.ones(size - 1), -1)
    )
    return np.linalg.eigvalsh(H)[:nev]


def well_problem(n: int, ss: int, dtype, *, cheb: int = 0,
                 precond: bool = True, seed: int = 42):
    """The BdG well pencil at dimension n: returns (A, B, T, X0) with
    X0 a host [n, ss] float32 array (B-positive start [u; u], random
    inside the well, where the bound states live)."""
    import jax.numpy as jnp

    from lobpcg_tpu import (
        BlockAntiDiagOperator,
        DiagonalOperator,
        JacobiPreconditioner,
        Laplacian1D,
    )

    m = n // 2
    # K = tridiag[-1, 2, -1] + V; bound band [1+..., ~1.25], continuum
    # from ~2 — a large gap, so LOBPCG converges in tens of iterations
    # while every iteration still pays the full n-dim SpMM.
    lo = (m - WELL) // 2
    V = np.full(m, BARRIER + SHIFT, np.float64)
    V[lo : lo + WELL] = SHIFT
    # A = diag(K, K) expressed as ONE segmented stencil + diagonal, which
    # XLA fuses into one pass over X.
    Vd2 = jnp.asarray(np.concatenate([V, V]), dtype)
    A = Laplacian1D(scale=jnp.asarray(1.0, dtype), n=n, segments=2) \
        + DiagonalOperator(Vd2)
    B = BlockAntiDiagOperator(d=jnp.ones((m,), dtype))
    T = None
    if cheb:
        from lobpcg_tpu import ChebyshevFilter

        hi = 4.0 + BARRIER + SHIFT + 0.1  # >= ||A|| for the lattice operator
        # Column-chunk the filter at capacity-bound sizes (its recurrence
        # holds ~4 [n, chunk] blocks live).
        chunk = max(8, ss // 4) if n >= 2_000_000 else 0
        T = ChebyshevFilter(op=A, lo=jnp.asarray(2.0, dtype),
                            hi=jnp.asarray(hi, dtype), degree=cheb,
                            chunk=chunk)
    elif precond:
        T = JacobiPreconditioner(2.0 + Vd2)

    rng = np.random.RandomState(seed)
    u = np.zeros((m, ss), np.float32)
    u[lo : lo + WELL] = rng.uniform(-0.5, 0.5, size=(WELL, ss))
    return A, B, T, np.concatenate([u, u], axis=0)


def well_problem_shapes(n: int, dtype):
    """The well pencil's (A, B, T) with shapes in place of arrays, for
    compiling a full-size solve without allocating its operators."""
    import jax

    from lobpcg_tpu import (
        BlockAntiDiagOperator,
        DiagonalOperator,
        JacobiPreconditioner,
        Laplacian1D,
    )

    sds = jax.ShapeDtypeStruct
    A = Laplacian1D(scale=sds((), dtype), n=n, segments=2) \
        + DiagonalOperator(sds((n,), dtype))
    B = BlockAntiDiagOperator(d=sds((n // 2,), dtype))
    T = JacobiPreconditioner(sds((n,), dtype))
    return A, B, T


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4_000_000)
    ap.add_argument("--nev", type=int, default=64)
    ap.add_argument("--size-sub", type=int, default=0, help="0 -> nev+14")
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--max-iter", type=int, default=300)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--no-precond", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="compare vs dense truncated-well eigenvalues")
    ap.add_argument("--realify", action="store_true",
                    help="specify the pencil in complex128 on the host and "
                         "solve its split-real f32 embedding on the device "
                         "(doubles the working dimension)")
    ap.add_argument("--cheb", type=int, default=0, metavar="DEGREE",
                    help="Chebyshev approximate-inverse preconditioner of "
                         "the given degree (0 = plain Jacobi/none)")
    ap.add_argument("--no-ax-cache", action="store_true",
                    help="recompute A@X instead of carrying the cache "
                         "(lower peak HBM, one extra SpMM per iteration)")
    ap.add_argument("--no-b-cache", action="store_true",
                    help="re-apply B at every ortho/Gram site (the "
                         "reference's behavior) instead of threading "
                         "one B@X / B@P application per iteration")
    ap.add_argument("--rr-dtype", default=None,
                    help="Gram/RR math dtype (e.g. float64); default "
                         "auto-escalates wide pencils per "
                         "config.RR_WIDTH_ESCALATE")
    ap.add_argument("--rr-chunk", type=int, default=0,
                    help="row-chunk widened Gram contractions (see "
                         "SolverConfig.rr_chunk_rows)")
    ap.add_argument("--x64", action="store_true",
                    help="enable jax_enable_x64 (required for float64 "
                         "RR math)")
    ap.add_argument("--no-dual-basis", action="store_true",
                    help="compile out the quality=5 dual-basis branch "
                         "(saves an [n, ss] block of peak HBM; sound "
                         "for the well-conditioned B = antidiag(I, I))")
    ap.add_argument("--donate", action="store_true",
                    help="donate X0 to the solve (frees 2 n*ss scalars "
                         "of HBM; X0 is rebuilt per repetition)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warm-up solve (escalated-f64 runs are "
                         "~30 min per solve; the single timed rep then "
                         "includes compile — use for convergence proofs, "
                         "not wall-clock comparisons)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed repetitions; best (min) wall-clock is "
                         "reported")
    ap.add_argument("--gram-precision", default="highest",
                    choices=("highest", "high"),
                    help="precision of the Gram contractions (see "
                         "SolverConfig.gram_precision)")
    ap.add_argument("--ortho-skip", action="store_true",
                    help="enable the ortho entry check (skip the "
                         "projection+SVQB pass when W is already "
                         "B-orthonormal up to column scaling)")
    ap.add_argument("--stall-reset", type=int, default=0,
                    help="perturb W after this many non-improving "
                         "iterations (0 = off; see "
                         "SolverConfig.stall_reset)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="split the solve into warm-restarted launches "
                         "of this many iterations (one compile)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, budget_gb=None) -> dict:
    """Build and solve the configured pencil; return the JSON record.

    With ``budget_gb`` the solve is first compiled (not run) and, if
    XLA's peak exceeds 95% of the budget, skipped: the record then says
    so and carries no timing."""
    import jax

    if args.x64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from lobpcg_tpu import (
        BlockAntiDiagOperator,
        BlockDiagOperator,
        DiagonalOperator,
        JacobiPreconditioner,
        Laplacian1D,
        SolverConfig,
        ilobpcg,
    )

    dtype = jnp.dtype(args.dtype)
    n = args.n
    m = n // 2
    nev = args.nev
    ss = args.size_sub or nev + 14
    A, B, T, x0_np = well_problem(n, ss, dtype, cheb=args.cheb,
                                  precond=not args.no_precond)

    cfg = SolverConfig(nev=nev, size_sub=ss, tol=args.tol,
                       max_iter=args.max_iter,
                       use_ax_cache=not args.no_ax_cache,
                       use_b_cache=not args.no_b_cache,
                       dual_basis=not args.no_dual_basis,
                       gram_precision=args.gram_precision,
                       rr_dtype=args.rr_dtype,
                       rr_chunk_rows=args.rr_chunk or None,
                       ortho_skip=args.ortho_skip,
                       stall_reset=args.stall_reset)

    if args.realify:
        import jax as _jax

        from lobpcg_tpu.operators.realify import derealify, realify_problem

        cpu = _jax.devices("cpu")[0]
        with _jax.default_device(cpu):
            V = np.asarray(A.right.d[:m], np.float64)
            Kc = Laplacian1D(scale=jnp.asarray(1.0, jnp.complex128), n=m) \
                + DiagonalOperator(jnp.asarray(V, jnp.complex128))
            Ac = BlockDiagOperator(inner=Kc, copies=2)
            Bc = BlockAntiDiagOperator(d=jnp.ones((m,), jnp.complex128))
            X0c = jnp.asarray(x0_np, jnp.complex128)
            A, X0, B, _, cfg = realify_problem(
                Ac, X0c, Bc, config=cfg, rdt=jnp.float32
            )
            # Rebuild the requested preconditioner on the REALIFIED A so
            # realify-vs-native comparisons stay apples-to-apples.
            if args.cheb:
                from lobpcg_tpu import ChebyshevFilter

                hi = 4.0 + BARRIER + SHIFT + 0.1
                T = ChebyshevFilter(op=A, lo=jnp.asarray(2.0, jnp.float32),
                                    hi=jnp.asarray(hi, jnp.float32),
                                    degree=args.cheb)
            elif T is not None:
                T = JacobiPreconditioner(
                    jnp.concatenate([jnp.real(T.d).astype(jnp.float32)] * 2)
                )

    if budget_gb is not None:
        from lobpcg_tpu.utils.plan import estimate_peak_gb

        peak = estimate_peak_gb(A, cfg, B, T, indefinite=True)
        if peak > 0.95 * budget_gb:
            return {"skipped": "compiled peak exceeds device budget",
                    "peak_gb": peak, "budget_gb": budget_gb}

    # Compile once (cached), then time `reps` solves and keep the best;
    # the iteration count is deterministic for a given program.

    def one_solve():
        # Rebuild X0 per call: donation invalidates the buffer.
        X0r = jnp.asarray(x0_np, dtype)
        if args.realify:
            X0r = X0  # realified X0 built above (donate unsupported)
        donate = args.donate and not args.realify
        t0 = time.perf_counter()
        if args.chunk:
            import dataclasses

            ccfg = dataclasses.replace(cfg, max_iter=args.chunk)
            X, P, total = X0r, None, 0
            while total < cfg.max_iter:
                r = ilobpcg(A, X, B, T, config=ccfg,
                            key=jax.random.PRNGKey(0), P0=P,
                            donate=donate)
                total += int(r.iterations)
                X, P = r.basis, r.momentum
                if int(r.converged) >= nev or int(r.iterations) == 0:
                    break
            r = r._replace(iterations=jnp.int32(total))
        else:
            r = ilobpcg(A, X0r, B, T, config=cfg,
                        key=jax.random.PRNGKey(0), donate=donate)
        if args.realify:
            lam, _, _ = derealify(r, nev)
        else:
            lam = np.asarray(r.eigenvalues)
        return time.perf_counter() - t0, lam, r

    if not args.no_warmup:
        one_solve()  # compile + warm-up
    walls = []
    for _ in range(max(1, args.reps)):
        wall, lam, r = one_solve()
        walls.append(wall)
    wall = min(walls)

    out = {
        "metric": "ilobpcg_bdg_well_wall_clock_to_tol",
        "value": wall,
        "unit": "s",
        "n": n,
        "nev": nev,
        "size_sub": ss,
        "tol": args.tol,
        # Primary metric: deterministic; wall-clock is best-of-reps.
        "iterations": int(r.iterations),
        "reps": max(1, args.reps),
        "wall_all": [round(w, 3) for w in walls],
        # For realified runs convergence counts duplicated real pairs;
        # report complex pairs so the field is comparable across modes.
        "converged": (int(r.converged) // 2 if args.realify
                      else int(r.converged)),
        "quality5": int(r.quality5_count),
        "rr_failed": int(r.rr_fail_count),
        "dtype": ("complex128->split-real f32" if args.realify
                  else str(dtype)),
        "gram_precision": args.gram_precision,
        "b_cache": not args.no_b_cache,
        "ax_cache": not args.no_ax_cache,
        "dual_basis": not args.no_dual_basis,
        "ortho_skip": args.ortho_skip,
        "stall_reset": args.stall_reset,
        "rr_dtype": str(cfg.resolved_rr_dtype(dtype)),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }
    if args.check:
        exact = well_eigs_oracle(WELL, nev, BARRIER)
        out["max_rel_err"] = float(
            np.max(np.abs(lam - exact) / np.abs(exact))
        )
    return out


def main() -> None:
    args = parse_args()
    from lobpcg_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(json.dumps(run(args)))


if __name__ == "__main__":
    main()
