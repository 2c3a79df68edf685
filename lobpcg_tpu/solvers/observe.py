"""Observability inside the jitted solve loop.

The reference gates per-iteration printf on an int8 verbosity field
(`src/core/lobpcg_impl.inc:89-90,118-124,230-238`).  Under jit the
equivalents are `jax.debug.print` (streams from device at run time)
and fixed-shape history arrays carried through the while_loop.
Both are selected *statically* from SolverConfig so the silent path
compiles to nothing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lobpcg_tpu.solvers.state import SolveHistory


def history_init(config, m: int, lam_dtype, res_dtype):
    """Zeroed [max_iter, ...] trace arrays, or None when disabled."""
    if not config.record_history:
        return None
    return SolveHistory(
        eigenvalues=jnp.zeros((config.max_iter, m), lam_dtype),
        residual_norms=jnp.zeros((config.max_iter, config.nev), res_dtype),
        converged=jnp.zeros((config.max_iter,), jnp.int32),
        flags=jnp.zeros((config.max_iter,), jnp.int32),
    )


def history_update(hist, it, lam, res, conv, flag=None):
    """Write row `it`; no-op (None) when recording is off."""
    if hist is None:
        return None
    flags = hist.flags if flag is None else hist.flags.at[it].set(flag)
    return SolveHistory(
        eigenvalues=hist.eigenvalues.at[it].set(lam),
        residual_norms=hist.residual_norms.at[it].set(res),
        converged=hist.converged.at[it].set(conv),
        flags=flags,
    )


def log_iteration(config, name: str, it, lam, res, conv):
    """Per-iteration device-side logging, compiled in only when
    verbosity >= 1 (so verbosity=0 costs nothing)."""
    if config.verbosity >= 1:
        jax.debug.print(
            "[" + name + "] iter {i}: converged {c}/" + str(config.nev)
            + "  max_res {r:.3e}",
            i=it, c=conv, r=jnp.max(res),
        )
    if config.verbosity >= 2:
        jax.debug.print("[" + name + "] iter {i}: eigvals {l}", i=it, l=lam)


def log_start(config, name: str, a_norm, b_norm):
    """Mirror of the reference's pre-loop norm printout
    (`lobpcg_impl.inc:89-90`)."""
    if config.verbosity >= 1:
        jax.debug.print(
            "[" + name + "] ||A|| ~ {a:.6e}  ||B|| ~ {b:.6e}",
            a=a_norm, b=b_norm,
        )
