"""Checkpoint / resume for long eigensolves.

The reference has no checkpointing (SURVEY.md §5); its closest analog is
the warm start — the solver reuses caller-provided X when nonzero
(`src/core/lobpcg_impl.inc:92-96`), so "resume" = re-enter with the saved
X block.  LOBPCG is restart-friendly: the [n, size_sub] X basis alone
restarts the solve (P momentum rebuilds in a few iterations).

Two layers:

- `save_checkpoint` / `load_checkpoint`: atomic .npz snapshots of the
  basis + eigenvalues + bookkeeping.
- `solve_checkpointed`: chunked outer host loop around a jitted solver —
  run `every` iterations on device, snapshot at the chunk boundary,
  repeat until converged or max_iter.  The chunk boundary is the only
  host sync, so the device stays busy between snapshots.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Optional

import numpy as np

from lobpcg_tpu.config import SolverConfig

_FORMAT_VERSION = 1


def save_checkpoint(path, basis, eigenvalues=None, *, iterations: int = 0,
                    momentum=None, meta: Optional[dict] = None) -> None:
    """Atomically snapshot a solve: basis [n, size_sub] (+ eigenvalues,
    + the P momentum block for exact-speed resume).

    Atomic = write to `<path>.tmp` then rename, so a crash mid-write
    never corrupts the previous snapshot.
    """
    path = pathlib.Path(path)
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "basis": np.asarray(basis),
        "iterations": np.int64(iterations),
    }
    if momentum is not None:
        payload["momentum"] = np.asarray(momentum)
    if eigenvalues is not None:
        payload["eigenvalues"] = np.asarray(eigenvalues)
    for k, v in (meta or {}).items():
        payload["meta_" + k] = np.asarray(v)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path) -> dict:
    """Load a snapshot; returns {basis, iterations, eigenvalues?, meta_*}."""
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    v = int(out.pop("version", _FORMAT_VERSION))
    if v > _FORMAT_VERSION:
        raise ValueError(f"checkpoint format {v} is newer than supported")
    out["iterations"] = int(out["iterations"])
    return out


def solve_checkpointed(
    solve_fn,
    A,
    X0=None,
    B=None,
    T=None,
    *,
    config: SolverConfig,
    path,
    every: int = 10,
    key=None,
    resume: bool = True,
):
    """Run `solve_fn` (lobpcg / ilobpcg) in chunks of `every` iterations,
    snapshotting the basis to `path` at each chunk boundary.

    If `resume` and `path` exists, the solve continues from the stored
    basis and iteration count.  Returns the final result with
    `iterations` giving the cumulative count across chunks (including
    any from resumed snapshots).
    """
    import jax
    import jax.numpy as jnp

    path = pathlib.Path(path)
    total_it = 0
    X = X0
    P = None
    if resume and path.exists():
        ck = load_checkpoint(path)
        X = jnp.asarray(ck["basis"], A.dtype)
        if "momentum" in ck:
            P = jnp.asarray(ck["momentum"], A.dtype)
        total_it = ck["iterations"]

    if key is None:
        key = jax.random.PRNGKey(0)

    # ONE static config for every chunk (max_iter=every sizes the
    # history arrays); the varying chunk length is the *runtime* it_cap,
    # so all chunks — including a short tail — share a single compile
    # (a full-size solve recompiles for tens of seconds per distinct
    # chunk size).
    cfg = dataclasses.replace(config, max_iter=every)
    if P is None:
        # Explicit zero momentum: keeps the jitted signature identical
        # between the first chunk (no saved P) and later chunks (saved
        # P array), so they share one compile.  A zero P0 compacts to
        # p0_cnt=0 — semantically identical to P0=None.
        P = jnp.zeros((A.shape[0], config.size_sub), A.dtype)
    result = None
    while total_it < config.max_iter:
        chunk = min(every, config.max_iter - total_it)
        result = solve_fn(A, X, B, T, config=cfg, key=key, P0=P,
                          it_cap=chunk)
        total_it += int(result.iterations)
        X = result.basis
        P = result.momentum
        save_checkpoint(
            path,
            X,
            result.eigenvalues,
            iterations=total_it,
            momentum=P,
            meta={"converged": int(result.converged)},
        )
        if int(result.converged) >= config.nev:
            break
        if int(result.iterations) == 0:
            break
    if result is None:  # already past max_iter when resumed
        result = solve_fn(A, X, B, T, config=cfg, key=key, P0=P,
                          it_cap=1)
    return result._replace(iterations=jnp.int32(total_it))
