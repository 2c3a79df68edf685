"""Solver configuration and dtype policy.

Reproduces the reference's compile-time / runtime knob surface
(`/root/reference/lobpcg.h:40-54`, per-type EPS_TOL in
`/root/reference/src/core/lobpcg_s.c:10`, `lobpcg_d.c:9`, `lobpcg_z.c:11`,
hard-coded constants `tol_skip=5e-3` in
`src/rayleigh/rayleigh_ritz_modified_impl.inc:55` and
`max_outer=max_inner=3` in `src/ortho/ortho_drop_impl.inc:70-71`)
as a single frozen dataclass, plus explicit-PRNG reproducibility that the
reference lacks (its `fill_random` is wall-clock seeded,
`src/residual/estimate_norm_impl.inc:21-24`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp

# Per-dtype default tolerance, mirroring the reference's EPS_TOL macro:
# 1e-5 for single precision (f32/c32), 1e-12 for double (f64/c64).
EPS_TOL = {
    jnp.dtype(jnp.float32): 1e-5,
    jnp.dtype(jnp.complex64): 1e-5,
    jnp.dtype(jnp.float64): 1e-12,
    jnp.dtype(jnp.complex128): 1e-12,
}

# Guard threshold used by the indefinite solver's beta ~ 0 and
# |diag| ~ 0 checks (`src/rayleigh/indefinite_rr_impl.inc:99`), made
# per-dtype instead of the reference's hard-coded 1e-30 (its own
# CODE_REVIEW.md flags that constant as unreachable in f32).
TINY = {
    jnp.dtype(jnp.float32): 1e-20,
    jnp.dtype(jnp.complex64): 1e-20,
    jnp.dtype(jnp.float64): 1e-30,
    jnp.dtype(jnp.complex128): 1e-30,
}

# Quality tolerance for the indefinite RR B-orthogonality check
# (`src/rayleigh/indefinite_rr_modified_impl.inc:196` uses 1e-12).
QUALITY_TOL = {
    jnp.dtype(jnp.float32): 1e-5,
    jnp.dtype(jnp.complex64): 1e-5,
    jnp.dtype(jnp.float64): 1e-12,
    jnp.dtype(jnp.complex128): 1e-12,
}

# Relative magnitude of the stall-reset perturbation (see
# SolverConfig.stall_reset): each active W column gets noise of
# STALL_NOISE x its own norm — large enough to rotate a degenerate
# direction out of the failing configuration, small enough to keep the
# residual information that drives convergence.
STALL_NOISE = 1e-2

# Projected-pencil width (3 * size_sub) beyond which single-precision
# Gram/RR math is auto-escalated to float64: the f32 KPS reduction was
# observed to misconverge at width 768 (1M x 150, size_sub 256), while
# width <= 576 converged cleanly.  That evidence comes only from runs on
# the previous accelerator (whose f32 linear algebra used reduced-
# precision passes); the threshold is to be re-decided on the H100.
# Double precision never needed escalation in testing.
RR_WIDTH_ESCALATE = {
    jnp.dtype(jnp.float32): 512,
    jnp.dtype(jnp.complex64): 512,
}


def real_dtype(dtype) -> jnp.dtype:
    """Real counterpart of a (possibly complex) dtype."""
    return jnp.dtype(jnp.zeros((), dtype).real.dtype)


def eps_tol(dtype) -> float:
    return EPS_TOL[jnp.dtype(dtype)]


def tiny(dtype) -> float:
    return TINY[jnp.dtype(dtype)]


def quality_tol(dtype) -> float:
    return QUALITY_TOL[jnp.dtype(dtype)]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver knobs (hashable; safe as a jit static argument).

    Mirrors the runtime fields of the reference's ``*_lobpcg_t`` struct
    (`/root/reference/lobpcg.h:40-54`) plus its hard-coded internals.
    """

    nev: int
    size_sub: int
    max_iter: int = 100
    tol: float = 1e-5

    # Orthogonalization tolerances; None -> per-dtype EPS_TOL.
    eps_ortho: Optional[float] = None
    eps_drop: Optional[float] = None

    # Cholesky-path condition threshold (rcond < tol_skip => ortho retry).
    tol_skip: float = 5e-3

    # ortho_drop / ortho_indefinite loop caps.
    max_outer: int = 3
    max_inner: int = 3

    # Power-iteration steps for operator norm estimation, and the block
    # width of the iteration: 1 = the reference's single random vector
    # (`estimate_norm_impl.inc:38-57`); 8 (default) runs 8 independent
    # starts in one [n, 8] block — better estimates for clustered
    # spectra.  The default was chosen on the previous accelerator, where
    # an [n, 8] step cost the same as an [n, 1] one; not yet re-measured
    # on the H100.  The estimate feeds every tolerance decision
    # (get_residual_norm's denominator), so underestimates from one
    # unlucky start loosen convergence silently.
    norm_iters: int = 10
    norm_block: int = 8

    # Residual-norm numerator: "2" = the reference's 2-norm
    # (`residual_impl.inc:83-91` — it ignores its B argument, a defect
    # SURVEY §2.7 flags; kept as the parity default), "b" = the
    # B-seminorm sqrt(|w^H B w|), the scientifically right norm for
    # generalized pencils (costs one extra [n, nev] B application per
    # iteration; identical to "2" when B is None).
    residual_norm: str = "2"

    # Projected generalized eigensolve for the indefinite pencil:
    #   'cholesky' - KPS reduction: chol(GA) + eigh, fully on-device; a
    #                potrf failure poisons the outputs with NaN (visible,
    #                never silently wrong).  The default: it needs no
    #                host round trip inside the solve loop.
    #   'auto'     - cholesky with a QZ host fallback when chol(GA)
    #                fails — prefer on CPU / callback-capable backends
    #   'qz'       - scipy QZ via pure_callback      (host round-trip)
    rr_method: str = "cholesky"

    # Precision of the numerically-sensitive contractions (Grams, basis
    # transforms; ops/gram.mm/_hdot), as jax.lax.Precision.  'highest' =
    # full f32 products; 'high' lets XLA's GPU backend use reduced-
    # precision tensor-core passes for f32 (TF32-class accuracy, about
    # three decimal digits per product).  On an H100, 'high' stalled the
    # 4M x 56 BdG well solve (0 of 56 pairs in 300 iterations, the
    # dual-basis branch taken every iteration) where 'highest'
    # converged.  The operator apply is not affected (operators choose
    # their own precision).
    gram_precision: str = "highest"

    # Cache AX between iterations (the reference's AX field).
    use_ax_cache: bool = True

    # ilobpcg only: compute B@X / B@P once at the top of each iteration
    # and thread the pre-applied blocks through the ortho projector, the
    # B-Gram (ops.gram.gram_blocks_pre) and the recovery residual —
    # eliminating ~6 redundant [n, m] B applications per iteration (the
    # reference re-applies B at every site, `gram_impl.inc:49-67`,
    # `ortho_indefinite_impl.inc:84-130`).  Costs up to two extra [n, m]
    # transients live through the ortho/RR phase (~2 GB at dim 4M x 256
    # f32) — disable at capacity-bound sizes.  Correctness relies only on
    # B being Hermitian (the problem contract).
    use_b_cache: bool = True

    # ilobpcg only: compile the quality=5 dual-basis projection path
    # (`ilobpcg_impl.inc:228-256`).  Both lax.cond branches contribute
    # to the loop's peak HBM, and the dual-basis branch holds an extra
    # [n, size_sub] accurate-basis block (~2 GB at dim 4M x 128) —
    # disable for well-conditioned pencils (e.g. BdG with B =
    # antidiag(I, I), where quality never degrades) to reclaim that
    # headroom at capacity-bound sizes.  When False, a quality=5
    # iteration projects with the accurate basis (still counted in
    # quality5_count/history).
    dual_basis: bool = True

    # Ortho entry check: before the projection+SVQB
    # pass, test whether W is already B-orthonormal against [X, P] up to
    # column scaling (one B application + two k x k contractions, using
    # the pre-applied B blocks when available) and skip the whole pass
    # when it is.  Also seeds the inner SVQB loop's early exit from the
    # seed Gram, skipping redundant second-pass SVQBs.  Off by default:
    # the reference runs the full pass every iteration
    # (`ilobpcg_impl.inc:168-178`); enable after profiling shows late
    # iterations would skip.
    ortho_skip: bool = False

    # Stagnation stabilizer (ilobpcg; beyond the reference, whose driver
    # thrashes identically near the f32 convergence floor,
    # `ilobpcg_impl.inc:228-256`): when the converged prefix has not
    # grown for this many consecutive iterations (an rr-failed iteration
    # jumps the counter straight to the threshold), the next iteration
    # perturbs W with COLUMN-NORM-SCALED noise
    # (STALL_NOISE x ||w_j|| per column) before orthogonalization,
    # breaking the deterministic discard-and-rebuild cycle behind a
    # 5.6x iteration spread seen across bit-different f32 programs on
    # the previous accelerator (34 vs 192 iterations, 8 rr_fails).  Not
    # yet measured on the H100.
    # Dead (masked) columns have zero norm, so the scaling preserves
    # the exact-zero invariant with no extra masking copy.  0 = off
    # (reference-parity behavior; the perturbation branch is compiled
    # out entirely).
    stall_reset: int = 0

    # Mixed precision (BASELINE.json config "mixed float/double"): when
    # set (e.g. "float64"), the k x k Gram matrices are *accumulated* in
    # this precision (preferred_element_type on the contraction — the
    # tall blocks stay in the operator dtype) and the projected
    # eigensolves / Cholesky / coefficient math run in it; coefficient
    # matrices are cast back to the operator dtype for the tall
    # project-back GEMMs.  Complexness follows the operator dtype
    # (complex64 operator + rr_dtype="float64" -> complex128 Grams).
    # Requires jax_enable_x64 for float64 to exist at all.
    rr_dtype: Optional[str] = None

    # Row-chunk size for WIDENED (rr_dtype wider than storage) Gram
    # contractions.  A backend that emulates f64 splits both tall
    # operands of an f64-accumulated f32 dot into stacked multi-pass
    # components (~8x the operand bytes: a 57 GiB compile peak at the
    # 1M x 256 escalated solve on the previous accelerator, the only
    # evidence so far — the H100 has f64 in hardware, so this is to be
    # re-decided there); chunking bounds the splits to
    # [*, k, rr_chunk_rows] scan transients with an exact f64 k x k
    # accumulator.  None/0 = off.  Leave OFF for row-sharded solves
    # (the chunking reshape conflicts with a sharded leading axis).
    rr_chunk_rows: Optional[int] = None

    # Observability (reference: the int8 `verbosity` struct field gating
    # per-iteration printf, `src/core/lobpcg_impl.inc:89-90,118-124,
    # 230-238`).  0 = silent; 1 = per-iteration converged count + max
    # residual via jax.debug.print; 2 = also eigenvalues.
    verbosity: int = 0

    # Record the per-iteration (eigenvalues, residual norms, converged)
    # trace into fixed [max_iter, ...] arrays returned as result.history.
    record_history: bool = False

    def __post_init__(self):
        if self.nev > self.size_sub:
            raise ValueError(
                f"nev ({self.nev}) > size_sub ({self.size_sub})"
            )
        if self.rr_method not in ("cholesky", "qz", "auto"):
            raise ValueError(f"unknown rr_method: {self.rr_method!r}")
        if self.gram_precision not in ("highest", "high"):
            raise ValueError(
                f"unknown gram_precision: {self.gram_precision!r}"
            )
        if self.residual_norm not in ("2", "b"):
            raise ValueError(
                f"unknown residual_norm: {self.residual_norm!r}"
            )
        if self.norm_block < 1:
            raise ValueError(f"norm_block must be >= 1: {self.norm_block}")
        if self.stall_reset < 0:
            raise ValueError(
                f"stall_reset must be >= 0: {self.stall_reset}"
            )

    def resolved_eps(self, dtype) -> tuple[float, float]:
        e = eps_tol(dtype)
        return (
            self.eps_ortho if self.eps_ortho is not None else e,
            self.eps_drop if self.eps_drop is not None else e,
        )

    def resolved_rr_dtype(self, op_dtype):
        """The dtype for Gram/RR math, matched to the operator dtype's
        complexness; None when mixed precision is off.

        rr_dtype=None means AUTO: single-precision solves whose projected
        pencil width 3*size_sub exceeds RR_WIDTH_ESCALATE default to
        float64 Gram/RR math (requires jax_enable_x64; warns and stays
        single otherwise).  Pass rr_dtype equal to the storage precision
        (e.g. "float32") to opt out of escalation explicitly.
        """
        if self.rr_dtype is None:
            thr = RR_WIDTH_ESCALATE.get(jnp.dtype(op_dtype))
            if thr is None or 3 * self.size_sub <= thr:
                return None
            import jax

            if not jax.config.jax_enable_x64:
                import warnings

                warnings.warn(
                    f"size_sub={self.size_sub} gives a projected pencil "
                    f"width of {3 * self.size_sub} > {thr}, where the "
                    "single-precision reduction is known to misconverge; "
                    "enable jax_enable_x64 to allow the automatic "
                    'rr_dtype="float64" escalation (or set rr_dtype '
                    "explicitly to silence this).",
                    stacklevel=3,
                )
                return None
            rr = jnp.dtype(jnp.float64)
        else:
            rr = jnp.dtype(self.rr_dtype)
        if jnp.issubdtype(jnp.dtype(op_dtype), jnp.complexfloating):
            if not jnp.issubdtype(rr, jnp.complexfloating):
                rr = jnp.dtype(jnp.result_type(rr, jnp.complex64))
        return rr


def validate_problem(n: int, config: SolverConfig) -> None:
    """Mirror of the reference's entry validation
    (`src/core/lobpcg_impl.inc:66-75`)."""
    if 3 * config.size_sub > n:
        raise ValueError(
            f"3*size_sub ({3 * config.size_sub}) > problem size ({n})"
        )
