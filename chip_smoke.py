"""Smoke test of the LOBPCG solvers on an NVIDIA GPU, at real sizes.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py           # one GPU: phases 0-4 below
    python chip_smoke.py --four    # four GPUs: the sharded flagship only

It drives the package's public entry points (``lobpcg`` / ``ilobpcg``
and the operators) in this one process, and fails (non-zero exit, no
result line) when JAX finds no GPU.  Phases, each printing one line and
raising on failure:

0. device: kind, count, card name and power limit, JAX version,
   XLA_FLAGS, compile-cache directory, native preprocessing library;
1. operator applies at real widths against a float64 host reference,
   each timed beside an XLA copy of the same shape;
2. the flagship indefinite solve (BdG well pencil, dim 4M, 56 pairs);
3. the same pencil at dim 1M with 150 pairs, then compile-only of the
   dim-4M x 150-pair program with its memory analysis;
4. the standard solver on the 3-D Dirichlet Laplacian through both
   operator families (stencil and BSR), float64.

The last line is ``{"ok": true, "device": {...}}``.  tests/test_gpu.py
calls the phase functions at small sizes; under pytest (CPU) it skips.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent
                       / "benchmarks"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lobpcg_tpu import (  # noqa: E402
    LaplacianND,
    SolverConfig,
    ilobpcg,
    lobpcg,
)
from lobpcg_tpu.operators.sparse import BSROperator, laplacian_3d_csr  # noqa: E402
from lobpcg_tpu.operators.stencil_nd import laplacian_nd_eigs  # noqa: E402
from lobpcg_tpu.utils.profiling import timed  # noqa: E402
from solve_bdg import (  # noqa: E402
    BARRIER,
    WELL,
    well_eigs_oracle,
    well_problem,
    well_problem_shapes,
)

U32 = 2.0 ** -24  # float32 unit roundoff
F32 = jnp.float32


def card() -> str:
    """Card name and power limit of every GPU, as nvidia-smi reports
    them (a subprocess that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return "; ".join(ln.strip() for ln in out.splitlines())


def _emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


@jax.jit
def _apply(op, X):
    # The operator is an argument, not a closure: its arrays must not be
    # baked into the program as constants.
    return op.matmat(X)


@jax.jit
def _copy(X):
    """Y = -X: an elementwise pass XLA cannot elide (read + write once)."""
    return -X


def _gbs(nbytes: int, fn, *args, reps: int = 10) -> float:
    """GB/s of the jitted `fn(*args)` moving `nbytes` per call."""
    _, dt = timed(fn, *args, warmup=2, reps=reps)
    return nbytes / dt / 1e9


# ---------------------------------------------------------------------------
# Phase 1: operators against a float64 host reference


def check_stencil_1d(n: int, k: int, *, window: int = 512,
                     card_name: str = "") -> dict:
    """The flagship A = Laplacian1D(segments=2) + DiagonalOperator at
    [n, k] f32, compared on row windows holding both Dirichlet edges and
    the segment boundary.  Bound: 4 f32 terms, so |err| <= 4 u ||A||_inf
    max|X| (forward error of a 4-term sum, u = 2^-24)."""
    A, _, _, _ = well_problem(n, 1, F32, precond=False)
    scale = float(A.left.scale)
    d = np.asarray(A.right.d, np.float64)
    X = jax.random.uniform(jax.random.PRNGKey(1), (n, k), F32, -1.0, 1.0)
    Y = _apply(A, X)
    seg = n // 2
    err = 0.0
    for lo, hi in ((0, window), (seg - window, seg + window),
                   (n - window, n)):
        a, b = max(lo - 1, 0), min(hi + 1, n)
        Xw = np.asarray(X[a:b], np.float64)
        rows = np.arange(lo, hi)
        x = Xw[rows - a]
        left = np.where((rows % seg == 0)[:, None], 0.0,
                        Xw[np.maximum(rows - 1, a) - a])
        right = np.where((rows % seg == seg - 1)[:, None], 0.0,
                         Xw[np.minimum(rows + 1, b - 1) - a])
        ref = scale * (2.0 * x - left - right) + d[lo:hi, None] * x
        err = max(err, float(np.abs(np.asarray(Y[lo:hi]) - ref).max()))
    tol = 4 * U32 * (4 * scale + np.abs(d).max()) * 1.0
    out = {"op": "Laplacian1D(segments=2)+Diagonal", "shape": [n, k],
           "max_abs_err": err, "tol": tol,
           "gbs": _gbs(2 * n * k * 4 + n * 4, _apply, A, X),
           "copy_gbs": _gbs(2 * n * k * 4, _copy, X), "card": card_name}
    out["fraction_of_copy"] = out["gbs"] / out["copy_gbs"]
    if not err <= tol:
        raise AssertionError(f"stencil 1-D error {err} > {tol}")
    return out


def check_stencil_3d(grid, k: int, *, card_name: str = "") -> dict:
    """LaplacianND on `grid` x k f32, compared on three i-planes (both
    Dirichlet faces and the middle).  Bound: 7 f32 terms, so
    |err| <= 7 u ||A||_inf max|X| with ||A||_inf = 12 scale."""
    nx = grid[0]
    h = 1.0 / (max(grid) + 1)
    scale = 1.0 / (h * h)
    A = LaplacianND(scale=jnp.asarray(scale, F32), grid=tuple(grid))
    n = int(np.prod(grid))
    X = jax.random.uniform(jax.random.PRNGKey(2), (n, k), F32, -1.0, 1.0)
    Y = _apply(A, X)
    Xg = X.reshape(*grid, k)
    Yg = Y.reshape(*grid, k)
    err = 0.0
    for i in (0, nx // 2, nx - 1):
        a, b = max(i - 1, 0), min(i + 2, nx)
        Xp = np.pad(np.asarray(Xg[a:b], np.float64),
                    ((int(i == 0), int(i == nx - 1)), (1, 1), (1, 1), (0, 0)))
        c = Xp[1, 1:-1, 1:-1]
        ref = scale * (
            6.0 * c - Xp[0, 1:-1, 1:-1] - Xp[2, 1:-1, 1:-1]
            - Xp[1, :-2, 1:-1] - Xp[1, 2:, 1:-1]
            - Xp[1, 1:-1, :-2] - Xp[1, 1:-1, 2:]
        )
        err = max(err, float(np.abs(np.asarray(Yg[i]) - ref).max()))
    tol = 7 * U32 * 12 * scale * 1.0
    out = {"op": "LaplacianND", "grid": list(grid), "k": k,
           "max_abs_err": err, "tol": tol,
           "gbs": _gbs(2 * n * k * 4, _apply, A, X),
           "copy_gbs": _gbs(2 * n * k * 4, _copy, X), "card": card_name}
    out["fraction_of_copy"] = out["gbs"] / out["copy_gbs"]
    if not err <= tol:
        raise AssertionError(f"stencil 3-D error {err} > {tol}")
    return out


def banded_csr(n: int, half_band: int, seed: int = 3):
    """Host CSR of a random banded n x n matrix (2*half_band+1 diagonals)."""
    import scipy.sparse as sp

    rng = np.random.RandomState(seed)
    offs = list(range(-half_band, half_band + 1))
    diags = [rng.uniform(-1.0, 1.0, n - abs(o)) for o in offs]
    M = sp.diags(diags, offs, format="csr")
    M.sort_indices()
    return M


def check_bsr(n: int, bs: int, k: int, half_band: int, *,
              card_name: str = "") -> dict:
    """BSROperator.from_csr of a banded matrix against scipy in f64 over
    the whole product.  rtol 1e-5 of max|ref|: an f32 product with f32
    accumulation is far inside it; a TF32 contraction is not."""
    M = banded_csr(n, half_band)
    op = BSROperator.from_csr(M.indptr, M.indices, M.data, block_size=bs,
                              dtype=F32)
    X = jax.random.uniform(jax.random.PRNGKey(3), (n, k), F32, -1.0, 1.0)
    Y = np.asarray(_apply(op, X), np.float64)
    ref = M @ np.asarray(X, np.float64)
    rel = float(np.abs(Y - ref).max() / np.abs(ref).max())
    nb, R = op.block_cols.shape
    nbytes = 2 * n * k * 4 + nb * R * (bs * bs * 4 + 4)
    out = {"op": "BSROperator", "shape": [n, k], "bs": bs,
           "blocks_per_row": R, "nnz": int(M.nnz), "max_rel_err": rel,
           "tol": 1e-5, "gbs": _gbs(nbytes, _apply, op, X),
           "copy_gbs": _gbs(2 * n * k * 4, _copy, X), "card": card_name}
    out["fraction_of_copy"] = out["gbs"] / out["copy_gbs"]
    if not rel <= 1e-5:
        raise AssertionError(f"BSR relative error {rel} > 1e-5")
    return out


# ---------------------------------------------------------------------------
# Phases 2-3: the BdG well pencil through ilobpcg


def _peak_bytes() -> int | None:
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def solve_well(n: int, nev: int, ss: int, *, tol: float = 1e-5,
               max_iter: int = 400, max_rel: float = 1e-4,
               card_name: str = "") -> dict:
    """ilobpcg on the well pencil: all nev pairs must converge and match
    the dense truncated-well oracle to max_rel.  The first call compiles
    and solves; the second is the timed solve."""
    A, B, T, x0 = well_problem(n, ss, F32)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=tol, max_iter=max_iter,
                       gram_precision="highest")
    walls = []
    for _ in range(2):
        X0 = jnp.asarray(x0, F32)
        t0 = time.perf_counter()
        r = ilobpcg(A, X0, B, T, config=cfg, key=jax.random.PRNGKey(0))
        lam = np.asarray(r.eigenvalues)
        walls.append(time.perf_counter() - t0)
    exact = well_eigs_oracle(WELL, nev, BARRIER)
    err = float(np.max(np.abs(lam - exact) / np.abs(exact)))
    its = int(r.iterations)
    out = {"n": n, "nev": nev, "size_sub": ss, "tol": tol,
           "iterations": its, "converged": int(r.converged),
           "max_rel_err": err, "first_call_s": walls[0],
           "wall_s": walls[1], "s_per_iteration": walls[1] / max(its, 1),
           "peak_bytes_in_use": _peak_bytes(), "card": card_name}
    if int(r.converged) != nev or not err <= max_rel:
        raise AssertionError(f"well solve failed: {out}")
    return out


def compile_only_well(n: int, nev: int, ss: int) -> dict:
    """Compile (not run) the dim-n well solve with the operators as
    shapes only; report XLA's memory analysis against the device."""
    from lobpcg_tpu.utils.plan import compile_solve, peak_bytes

    A, B, T = well_problem_shapes(n, F32)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-5, max_iter=400,
                       gram_precision="highest")
    t0 = time.perf_counter()
    compiled = compile_solve(A, cfg, B, T, indefinite=True)
    ma = compiled.memory_analysis()
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    peak = peak_bytes(compiled)
    return {"n": n, "nev": nev, "size_sub": ss,
            "compile_s": time.perf_counter() - t0,
            "argument_bytes": ma.argument_size_in_bytes,
            "output_bytes": ma.output_size_in_bytes,
            "temp_bytes": ma.temp_size_in_bytes,
            "alias_bytes": ma.alias_size_in_bytes,
            "peak_bytes": peak, "bytes_limit": limit,
            "fits_one_device": None if limit is None else peak <= limit}


# ---------------------------------------------------------------------------
# Phase 4: standard solver, both operator families


def solve_laplacian_3d(nx: int, nev: int = 10, ss: int = 16, *,
                       tol: float = 1e-8, max_iter: int = 3000,
                       card_name: str = "") -> dict:
    """lobpcg on the nx^3 Dirichlet Laplacian, float64, no
    preconditioner, through LaplacianND and through BSROperator; both
    must match the exact discrete spectrum to 1e-6 relative."""
    h = 1.0 / (nx + 1)
    scale = 1.0 / (h * h)
    exact = laplacian_nd_eigs((nx, nx, nx), scale, nev)
    ip, ix, v = laplacian_3d_csr(nx, nx, nx)
    ops = {
        "LaplacianND": LaplacianND(scale=jnp.asarray(scale, jnp.float64),
                                   grid=(nx, nx, nx)),
        "BSROperator": BSROperator.from_csr(ip, ix, v, block_size=8,
                                            dtype=jnp.float64),
    }
    out = {"grid": [nx] * 3, "nev": nev, "size_sub": ss, "tol": tol,
           "card": card_name}
    for name, op in ops.items():
        cfg = SolverConfig(nev=nev, size_sub=ss, tol=tol, max_iter=max_iter)
        t0 = time.perf_counter()
        r = lobpcg(op, config=cfg, key=jax.random.PRNGKey(0))
        lam = np.asarray(r.eigenvalues)
        err = float(np.max(np.abs(lam - exact) / exact))
        out[name] = {"iterations": int(r.iterations),
                     "converged": int(r.converged), "max_rel_err": err,
                     "first_call_s": time.perf_counter() - t0}
        if int(r.converged) != nev or not err <= 1e-6:
            raise AssertionError(f"3-D Laplacian via {name} failed: {out}")
    return out


# ---------------------------------------------------------------------------
# --four: the row-sharded flagship against the same solve on one device


def sharded_well(n: int, nev: int, ss: int, n_dev: int = 4, *,
                 max_rel: float = 1e-4, card_name: str = "") -> dict:
    """The well solve through shard_problem on row_mesh(n_dev) (ppermute
    halos in SpmdLaplacian1D, psum'd Grams) against the same solve on
    device 0; eigenvalues must agree to 1e-5 relative and both must pass
    the oracle check.  The basis shards must sit on n_dev distinct
    devices of the default backend."""
    from lobpcg_tpu.parallel import row_mesh, shard_problem

    A, B, T, x0 = well_problem(n, ss, F32)
    cfg = SolverConfig(nev=nev, size_sub=ss, tol=1e-5, max_iter=400,
                       gram_precision="highest")
    exact = well_eigs_oracle(WELL, nev, BARRIER)

    def run(A, X0, B, T, mesh=None):
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            if mesh is None:
                r = ilobpcg(A, X0, B, T, config=cfg,
                            key=jax.random.PRNGKey(0))
            else:
                with mesh:
                    r = ilobpcg(A, X0, B, T, config=cfg,
                                key=jax.random.PRNGKey(0))
            lam = np.asarray(r.eigenvalues)
            walls.append(time.perf_counter() - t0)
        err = float(np.max(np.abs(lam - exact) / np.abs(exact)))
        if int(r.converged) != nev or not err <= max_rel:
            raise AssertionError(
                f"{'sharded' if mesh else 'single'} solve failed: "
                f"converged {int(r.converged)}/{nev}, max_rel_err {err}")
        return r, lam, walls, err

    r1, lam1, w1, e1 = run(A, jnp.asarray(x0, F32), B, T)
    mesh = row_mesh(n_dev)
    As, X0s, Bs, Ts = shard_problem(mesh, A, jnp.asarray(x0, F32), B, T)
    r4, lam4, w4, e4 = run(As, X0s, Bs, Ts, mesh)
    devs = {s.device for s in r4.basis.addressable_shards}
    platform = jax.devices()[0].platform
    if len(devs) != n_dev or any(d.platform != platform for d in devs):
        raise AssertionError(f"basis shards on {devs}, want {n_dev} "
                             f"distinct {platform} devices")
    agree = float(np.max(np.abs(lam4 - lam1) / np.abs(lam1)))
    if not agree <= 1e-5:
        raise AssertionError(f"sharded vs single eigenvalues differ {agree}")
    return {"n": n, "nev": nev, "size_sub": ss, "devices": n_dev,
            "shard_devices": sorted(str(d) for d in devs),
            "single": {"iterations": int(r1.iterations), "max_rel_err": e1,
                       "first_call_s": w1[0], "wall_s": w1[1]},
            "sharded": {"iterations": int(r4.iterations),
                        "max_rel_err": e4, "first_call_s": w4[0],
                        "wall_s": w4[1]},
            "sharded_vs_single_rel": agree, "card": card_name}


def sharded_bsr(n: int, bs: int, k: int, half_band: int,
                n_dev: int = 4) -> dict:
    """ShardedBSROperator apply == the unsharded BSROperator apply."""
    from lobpcg_tpu.parallel import row_mesh
    from lobpcg_tpu.parallel.spmd_bsr import ShardedBSROperator

    M = banded_csr(n, half_band)
    op = BSROperator.from_csr(M.indptr, M.indices, M.data, block_size=bs,
                              dtype=F32)
    X = jax.random.uniform(jax.random.PRNGKey(4), (n, k), F32, -1.0, 1.0)
    Y1 = np.asarray(_apply(op, X))
    mesh = row_mesh(n_dev)
    sop = ShardedBSROperator.shard(op, mesh)
    with mesh:
        Y4 = np.asarray(_apply(sop, X))
    diff = float(np.abs(Y4 - Y1).max() / np.abs(Y1).max())
    if not diff <= 1e-6:
        raise AssertionError(f"sharded BSR apply differs: {diff}")
    return {"shape": [n, k], "bs": bs, "devices": n_dev,
            "sharded_vs_single_rel": diff}


# ---------------------------------------------------------------------------


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    jax.config.update("jax_enable_x64", True)
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU found (JAX's default device is "
            f"{dev.platform}); this script runs on a GPU only"
        )
    want = 4 if args.four else 1
    if len(devices) < want:
        raise SystemExit(f"chip_smoke: need {want} GPUs, found "
                         f"{len(devices)}")

    from lobpcg_tpu.utils import native
    from lobpcg_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    cache = {"hits": 0, "misses": 0}

    def on_event(event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            cache["hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            cache["misses"] += 1

    jax.monitoring.register_event_listener(on_event)
    name = card()
    print(f"card: {name}", flush=True)
    card0 = name.split("; ")[0]
    lib = native.load_library()
    _emit("0_device", kind=dev.device_kind, count=len(devices),
          jax=jax.__version__, xla_flags=os.environ.get("XLA_FLAGS", ""),
          compile_cache_dir=cache_dir,
          native_lib_built=native._lib_path().exists(),
          native_lib_loaded=lib is not None)
    t_all = time.perf_counter()

    if args.four:
        _emit("four_sharded_flagship",
              **sharded_well(4_000_000, 56, 64, 4, card_name=name))
        _emit("four_sharded_bsr", **sharded_bsr(1 << 20, 8, 128, 12, 4))
    else:
        for k in (64, 256):
            _emit("1_stencil_1d",
                  **check_stencil_1d(4_000_000, k, card_name=card0))
        _emit("1_stencil_3d",
              **check_stencil_3d((160, 160, 160), 128, card_name=card0))
        _emit("1_bsr", **check_bsr(1 << 20, 8, 128, 12, card_name=card0))
        _emit("2_flagship_4M_56",
              **solve_well(4_000_000, 56, 64, card_name=card0))
        _emit("3_well_1M_150",
              **solve_well(1_000_000, 150, 164, card_name=card0))
        _emit("3_compile_only_4M_150", **compile_only_well(4_000_000, 150,
                                                            160))
        _emit("4_laplacian_3d_64", **solve_laplacian_3d(64,
                                                         card_name=card0))

    print(f"card: {name}", flush=True)
    _emit("done", total_s=time.perf_counter() - t_all,
          compile_cache=dict(cache, dir=cache_dir,
                             entries=len(os.listdir(cache_dir))
                             if os.path.isdir(cache_dir) else 0))
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
