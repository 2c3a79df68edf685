"""Headline benchmark: blocked SpMM (operator application) nnz/s per GPU,
plus the flagship wall-clock-to-tolerance solves.

Everything runs in this one process, on the default device, which must
be a GPU (there is no CPU fallback: a number from another backend must
never be reported under a device metric).  Output, one JSON line each:

1. the SpMM headline, measured first, so it exists within minutes;
2. one line per solve ladder (the 4M x 56 flagship, then 1M x 150), each
   rung compiled first and skipped when XLA's compiled peak exceeds the
   device's allocator limit, under ONE global wall-clock budget
   (BENCH_BUDGET_S, default 1350 s); rung outcomes are "event" lines;
3. the SpMM headline again as the LAST line.

The SpMM workload is the reference's flagship operator shape: a
BdG-style block-Laplacian (A = diag(K, K), K = 1-D stencil) applied to
the search block X of a dim-4M, 150+-eigenpair solve — the hot op of
`lobpcg`'s inner loop (SURVEY.md §3.1 hot loops).  A 1-D stencil SpMM is
memory-bandwidth bound: per applied element X is read once and Y written
once, so nnz/s = nnz * k / (2 * n * k * bytes / BW).

The roofline BW is *attainable* bandwidth, measured in-process as an XLA
elementwise copy (negation, which XLA cannot elide) of the same shape;
the data-sheet fraction is reported alongside.
    vs_baseline = achieved / (0.80 * copy roofline)
>= 1.0 means the SpMM moves bytes at >= 80% of what a plain copy reaches.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import numpy as np

# Data-sheet device-memory bandwidth (bytes/s), keyed by the exact
# `device_kind` JAX reports.  Source: NVIDIA H100 Tensor Core GPU data
# sheet (H100 SXM: 80 GB HBM3 at 3.35 TB/s).  A device not listed here
# is an error, never a default.
HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def device_peak_bw(device_kind: str) -> float:
    """Data-sheet bandwidth of `device_kind`; raises for unknown kinds."""
    try:
        return HBM_BW[device_kind]
    except KeyError:
        raise ValueError(
            f"no data-sheet bandwidth for device {device_kind!r}; add it "
            "to bench.HBM_BW with its source"
        ) from None


def xla_copy(X):
    """Y = -X: an elementwise pass XLA cannot elide, reading and writing
    every element once — the attainable ceiling for the stencil."""
    return -X


# Flagship end-to-end solve (4M x 56) and the 1M x 150 shape, each as
# solve_bdg.py arguments, with fallback rungs from fastest to leanest.
FLAGSHIP_SOLVE_ARGS = [
    "--n", "4000000", "--nev", "56", "--size-sub", "64",
    "--donate", "--reps", "2", "--check",
    "--cheb", "3", "--gram-precision", "high",
]
FLAGSHIP_FALLBACKS = [
    ("full", []),
    ("dual_off", ["--no-dual-basis"]),
    ("b_cache_off", ["--no-b-cache", "--no-dual-basis"]),
    ("all_off", ["--no-b-cache", "--no-dual-basis", "--no-ax-cache"]),
]
SUB1M_SOLVE_ARGS = [
    "--n", "1000000", "--nev", "150", "--size-sub", "164",
    "--donate", "--reps", "2", "--check",
    "--cheb", "3", "--gram-precision", "high",
]
SUB1M_FALLBACKS = [
    ("dual_off", ["--no-dual-basis"]),
    ("b_cache_off", ["--no-b-cache", "--no-dual-basis"]),
]


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _solve_ladder_line(base_args, fallbacks, tag: str, deadline: float,
                       budget_gb: float) -> dict | None:
    """Walk a fallback ladder under the GLOBAL deadline, emitting one
    "event" line per rung outcome, and return the first successful
    rung's record."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent
                           / "benchmarks"))
    import solve_bdg

    skipped = []
    for rung_idx, (rung_id, extra) in enumerate(fallbacks):
        remaining = deadline - time.time()
        if remaining < 240:
            _emit({"event": "rung_skip", "ladder": tag, "rung_id": rung_id,
                   "reason": "global_budget_exhausted",
                   "remaining_s": remaining})
            skipped.append(rung_id)
            continue
        t0 = time.time()
        try:
            rec = solve_bdg.run(solve_bdg.parse_args(base_args + extra),
                                budget_gb=budget_gb)
        except Exception as e:  # noqa: BLE001 - report, try a leaner rung
            oom = "RESOURCE_EXHAUSTED" in str(e)
            _emit({"event": "rung_fail", "ladder": tag, "rung_id": rung_id,
                   "oom": oom, "error": str(e)[:300],
                   "elapsed_s": time.time() - t0})
            if oom:
                skipped.append(rung_id)
                continue
            return None
        if "skipped" in rec:
            _emit({"event": "rung_skip", "ladder": tag, "rung_id": rung_id,
                   **rec})
            skipped.append(rung_id)
            continue
        rec.update(ladder=tag, rung=rung_idx, rung_id=rung_id,
                   rungs_skipped=skipped)
        return rec
    return None


def _measure_spmm(peak_bw: float) -> dict:
    """The SpMM headline measurement."""
    import jax
    import jax.numpy as jnp

    from lobpcg_tpu import Laplacian1D
    from lobpcg_tpu.utils.profiling import timed

    n = 4_000_000  # reference headline problem dimension
    k = 256  # 150+ eigenpairs
    dtype = jnp.float32
    m = n // 2
    h = 1.0 / (m + 1)
    A = Laplacian1D(scale=jnp.asarray(1.0 / (h * h), dtype), n=n, segments=2)
    X = jax.random.uniform(jax.random.PRNGKey(0), (n, k), dtype, -0.5, 0.5)

    _, dt = timed(jax.jit(A.matmat), X, warmup=3, reps=20)
    _, dt_copy = timed(jax.jit(xla_copy), X, warmup=3, reps=20)

    bytes_moved = 2 * n * k * np.dtype(np.float32).itemsize
    copy_bw = bytes_moved / dt_copy
    nnz = (3 * m - 2) * 2  # tridiagonal stencil, two diagonal blocks
    nnz_per_s = nnz * k / dt
    achieved_bw = bytes_moved / dt
    roofline_nnz = nnz * k / (bytes_moved / copy_bw)
    dev = jax.devices()[0]
    return {
        "metric": "spmm_bdg_stencil_nnz_per_s_per_chip",
        "value": nnz_per_s,
        "unit": "nnz/s",
        "vs_baseline": nnz_per_s / (0.80 * roofline_nnz),
        "gbs": achieved_bw / 1e9,
        "copy_roofline_gbs": copy_bw / 1e9,
        "spec_fraction": achieved_bw / peak_bw,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }


def main() -> None:
    from lobpcg_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from lobpcg_tpu.utils.plan import device_budget_gb

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; found {dev.platform}")
    peak_bw = device_peak_bw(dev.device_kind)
    deadline = time.time() + float(os.environ.get("BENCH_BUDGET_S", "1350"))

    spmm = _measure_spmm(peak_bw)
    _emit(spmm)
    budget_gb = device_budget_gb(dev)
    for args, fallbacks, tag in (
        (FLAGSHIP_SOLVE_ARGS, FLAGSHIP_FALLBACKS, "flagship_4M"),
        (SUB1M_SOLVE_ARGS, SUB1M_FALLBACKS, "sub1M_150"),
    ):
        rec = _solve_ladder_line(args, fallbacks, tag, deadline, budget_gb)
        if rec is not None:
            _emit(rec)
    # The LAST line is always the headline metric.
    _emit(spmm)


if __name__ == "__main__":
    main()
