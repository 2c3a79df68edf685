"""Device-memory planning (utils/plan.py): peaks from XLA's memory
analysis of the compiled solve, and the fit ladder's semantics.

On the CPU test backend the analysis is the CPU compile's; the tests
pass explicit budgets, derived from those measured peaks."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from lobpcg_tpu import SolverConfig, estimate_peak_gb, plan_config
from lobpcg_tpu.utils import plan
from fixtures import bdg_ops

M = 256  # n = 2 * M


def _cfg(**kw):
    return SolverConfig(nev=4, size_sub=8, max_iter=20, **kw)


def _peak(cfg, m=M, dtype=jnp.float64):
    A, B = bdg_ops(m, dtype)
    return estimate_peak_gb(A, cfg, B, indefinite=True)


def _rung_peaks():
    base = _cfg()
    return [_peak(dataclasses.replace(base, **rung)) for rung in plan._LADDER]


def test_peak_matches_measured_anchors():
    """The peak is XLA's own memory analysis of the compiled solve."""
    A, B = bdg_ops(M, jnp.float64)
    compiled = plan.compile_solve(A, _cfg(), B, indefinite=True)
    ma = compiled.memory_analysis()
    want = (ma.argument_size_in_bytes + ma.output_size_in_bytes
            + ma.temp_size_in_bytes - ma.alias_size_in_bytes)
    assert plan.peak_bytes(compiled) == want
    assert _peak(_cfg()) == pytest.approx(want / (1 << 30))
    # At least the X0 argument and the returned basis.
    assert want >= 2 * (2 * M) * 8 * 8


def test_peak_scales_with_shape_and_dtype():
    base = _peak(_cfg(), m=1024)
    assert 1.6 < _peak(_cfg(), m=2048) / base < 2.4
    assert 1.6 < _peak(_cfg(), m=1024, dtype=jnp.float64) / _peak(
        _cfg(), m=1024, dtype=jnp.float32) < 2.4


def test_abstract_operators_compile_the_same_program():
    """ShapeDtypeStruct operator leaves give the same peak as arrays, so
    a full-size program can be planned without allocating it."""
    A, B = bdg_ops(M, jnp.float64)
    sds = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), (A, B))
    assert estimate_peak_gb(sds[0], _cfg(), sds[1], indefinite=True) == \
        pytest.approx(_peak(_cfg()))


def test_plan_keeps_full_config_when_it_fits():
    A, B = bdg_ops(M, jnp.float64)
    planned = plan_config(_cfg(), A, B, indefinite=True, budget_gb=64.0)
    assert planned == _cfg()


def test_plan_drops_knobs_in_measured_speed_order():
    """For a budget at each rung's peak, the plan is the FIRST ladder
    rung that fits — never a later one."""
    A, B = bdg_ops(M, jnp.float64)
    peaks = _rung_peaks()
    for p in peaks:
        got = plan_config(_cfg(), A, B, indefinite=True, budget_gb=p,
                          margin=1.0)
        first = next(i for i, q in enumerate(peaks) if q <= p)
        assert got == dataclasses.replace(_cfg(), **plan._LADDER[first])


def test_plan_dual_off_rung_keeps_both_caches():
    """A budget the full config misses but the dual-off rung fits drops
    only the dual basis: both caches (the fastest Gram path) stay."""
    A, B = bdg_ops(M, jnp.float64)
    full, dual_off = _rung_peaks()[:2]
    assert dual_off < full
    planned = plan_config(_cfg(), A, B, indefinite=True,
                          budget_gb=dual_off, margin=1.0)
    assert not planned.dual_basis
    assert planned.use_b_cache and planned.use_ax_cache


def test_plan_respects_caller_disabled_knobs():
    A, B = bdg_ops(M, jnp.float64)
    planned = plan_config(_cfg(use_ax_cache=False), A, B, indefinite=True,
                          budget_gb=64.0)
    assert not planned.use_ax_cache  # never re-enabled
    assert planned.use_b_cache and planned.dual_basis


def test_plan_raises_when_nothing_fits():
    A, B = bdg_ops(M, jnp.float64)
    lean = min(_rung_peaks())
    with pytest.raises(ValueError, match="Shard the problem"):
        plan_config(_cfg(), A, B, indefinite=True, budget_gb=0.5 * lean,
                    margin=1.0)


def test_default_budget_is_conservative():
    """No budget: the device's bytes_limit.  A backend that reports none
    (the CPU) is an error, not a guessed default."""

    class _Dev:
        platform, device_kind = "gpu", "test"

        def memory_stats(self):
            return {"bytes_limit": 3 << 30}

    assert plan.device_budget_gb(_Dev()) == 3.0
    A, B = bdg_ops(M, jnp.float64)
    with pytest.raises(ValueError, match="bytes_limit"):
        plan_config(_cfg(), A, B, indefinite=True)
