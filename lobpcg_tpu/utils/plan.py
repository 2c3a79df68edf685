"""Device-memory-aware solve planning: measure a solve's peak device
memory as XLA compiles it, and fit the fastest SolverConfig inside a
budget.

The solver's three memory/speed knobs (`dual_basis`, `use_b_cache`,
`use_ax_cache`) interact with XLA buffer liveness in ways no closed-form
model predicts well, so the peak comes from XLA itself:
``jax.jit(solve).lower(...).compile().memory_analysis()`` for the device
in use (arguments + outputs + temporaries - aliased buffers).  Nothing
runs; only the program is compiled.  The budget defaults to the device's
own allocator limit (``memory_stats()["bytes_limit"]``).

Reference context: the reference sizes its workspace exactly and
mallocs once (`/root/reference/lobpcg.h:586-686`); the analog here is
choosing compile-time knobs so XLA's arena fits the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

# Knob combinations, fastest first: full -> dual-basis branch compiled
# out (sound for well-conditioned B) -> b-cache off too -> all caches
# off.  Each entry overrides SolverConfig fields.
_LADDER = (
    {},
    {"dual_basis": False},
    {"use_b_cache": False, "dual_basis": False},
    {"use_b_cache": False, "dual_basis": False, "use_ax_cache": False},
)
_KNOBS = ("use_b_cache", "dual_basis", "use_ax_cache")


def _abstract(tree):
    """Array leaves -> ShapeDtypeStruct (ShapeDtypeStructs pass through)."""
    return jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(
            x.shape, x.dtype, sharding=getattr(x, "sharding", None)
        ) if hasattr(x, "shape") else x,
        tree,
    )


def compile_solve(A, config, B=None, T=None, *, indefinite: bool = False):
    """Compile (not run) the lobpcg / ilobpcg solve of this problem for
    the default device.  Operator leaves may be arrays or
    ``jax.ShapeDtypeStruct``s, so a full-size program can be compiled
    without allocating its operator.  Returns the compiled executable."""
    from lobpcg_tpu.solvers.ilobpcg import _ilobpcg_jit
    from lobpcg_tpu.solvers.lobpcg import _lobpcg_jit

    fn = _ilobpcg_jit if indefinite else _lobpcg_jit
    n = A.shape[0]
    X0 = jax.ShapeDtypeStruct((n, config.size_sub), A.dtype)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    return fn.lower(
        _abstract(A), _abstract(B), _abstract(T), X0, key, config,
        None, 0, None,
    ).compile()


def peak_bytes(compiled) -> int:
    """Peak device bytes of a compiled program from XLA's analysis."""
    ma = compiled.memory_analysis()
    return int(ma.argument_size_in_bytes + ma.output_size_in_bytes
               + ma.temp_size_in_bytes - ma.alias_size_in_bytes)


def estimate_peak_gb(A, config, B=None, T=None, *,
                     indefinite: bool = False) -> float:
    """Peak device memory (GiB) of the solve as XLA compiles it."""
    compiled = compile_solve(A, config, B, T, indefinite=indefinite)
    return peak_bytes(compiled) / (1 << 30)


def device_budget_gb(device=None) -> float:
    """The allocator limit of `device` (default: the first device) in
    GiB.  Raises if the backend reports no limit (e.g. the CPU)."""
    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise ValueError(
            f"{device.platform} device {device.device_kind!r} reports no "
            "bytes_limit; pass budget_gb explicitly"
        )
    return stats["bytes_limit"] / (1 << 30)


def plan_config(
    config,
    A,
    B=None,
    T=None,
    *,
    indefinite: bool = False,
    budget_gb: Optional[float] = None,
    margin: float = 0.95,
):
    """Return the fastest ladder variant of `config` whose compiled peak
    fits ``margin * budget_gb`` (default budget: the device's
    bytes_limit), walking full -> dual off -> b-cache+dual off -> all
    caches off.

    Knobs the caller already disabled stay disabled.  Raises
    ``ValueError`` if even the leanest configuration does not fit —
    the problem needs a sharded multi-device mesh
    (``lobpcg_tpu.parallel``) or a smaller subspace, not a doomed launch.
    """
    if budget_gb is None:
        budget_gb = device_budget_gb()
    budget = margin * budget_gb
    for rung in _LADDER:
        # Never re-enable a knob the caller turned off.
        kw = dict(rung)
        for field in _KNOBS:
            if not getattr(config, field):
                kw[field] = False
        cand = dataclasses.replace(config, **kw)
        peak = estimate_peak_gb(A, cand, B, T, indefinite=indefinite)
        if peak <= budget:
            return cand
    raise ValueError(
        f"no single-device configuration fits: dim {A.shape[0]} x "
        f"size_sub {config.size_sub} needs >= {peak:.2f} GiB (budget "
        f"{budget:.2f} GiB). Shard the problem over a mesh "
        f"(lobpcg_tpu.parallel.shard_problem) or shrink size_sub."
    )
