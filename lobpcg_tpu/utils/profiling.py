"""Profiling / timing helpers.

The reference has no profiler (SURVEY.md §5: a past "profiling" branch
left only vestigial struct fields).  On an accelerator the right tools are XLA
traces and wall-clock timing of whole jitted solves; these wrappers keep
that one import away.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir):
    """XLA device profiler trace around a block; view with TensorBoard or
    xprof (`jax.profiler.trace` under the hood)."""
    with jax.profiler.trace(str(logdir)):
        yield


def timed(fn, *args, warmup: int = 1, reps: int = 3):
    """Run `fn(*args)` `warmup` times (compile + cache), then time `reps`
    blocking executions.  Returns (last_output, seconds_per_call)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(max(reps, 1)):
        out = jax.block_until_ready(fn(*args))
    return out, (time.perf_counter() - t0) / max(reps, 1)
