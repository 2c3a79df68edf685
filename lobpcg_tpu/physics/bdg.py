"""Bogoliubov-de Gennes (BdG) operators for condensate excitation spectra.

The reference planned but never built this layer
(`/root/reference/TODO.md:281-291`: "matmulK (kinetic + trap +
interactions)", "matmulM (kinetic + 3*interactions + dipolar)",
"preconditioner"; `README.md:56`).  This module implements that
capability on top of the operator algebra.

For a real condensate wavefunction psi with density n = |psi|^2 and
contact coupling g, the linearized excitations in the f_+/- = u +- v
basis satisfy the generalized indefinite pencil

    A [f+; f-] = omega * B [f+; f-],
    A = diag(M, K),  B = antidiag(I, I),

with  K = H0 + V - mu + g n        ("kinetic + trap + interactions")
      M = K + 2 g n                ("kinetic + 3*interactions")
so that K M f = omega^2 f — for the uniform gas this reproduces the
Bogoliubov dispersion omega = sqrt(eps (eps + 2 g n)).  `ilobpcg` solves
the pencil directly (B-positive start vectors [w; w] select the +omega
branch, `tests/test_ilobpcg.c:194-204` pattern).

The dipolar exchange term of M is a convolution — supply it as an extra
LinearOperator via `dipolar=` (FFT-applied on backends with complex
support; elsewhere use a real-kernel convolution or the realified
path).

The preconditioner slot: `bdg_preconditioner` builds either a Jacobi
inverse-diagonal or a Chebyshev approximate inverse of diag(M, K).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from lobpcg_tpu.operators.chebyshev import ChebyshevFilter
from lobpcg_tpu.operators.linop import (
    BlockAntiDiagOperator,
    DiagonalOperator,
    JacobiPreconditioner,
    LinearOperator,
    operator,
)


@operator(data_fields=("top", "bottom"))
class BlockDiag2Operator(LinearOperator):
    """diag(top, bottom) with distinct blocks (A = diag(M, K))."""

    top: LinearOperator
    bottom: LinearOperator

    def matmat(self, X):
        m = self.top.shape[0]
        return jnp.concatenate(
            [self.top.matmat(X[:m]), self.bottom.matmat(X[m:])], axis=0
        )

    @property
    def shape(self):
        n = self.top.shape[0] + self.bottom.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.top.dtype


def bdg_operators(
    kinetic: LinearOperator,
    psi: jax.Array,
    g: float,
    mu: float,
    v_trap: Optional[jax.Array] = None,
    dipolar: Optional[LinearOperator] = None,
):
    """(A, B, K, M) for the BdG pencil from a condensate state.

    kinetic: the single-particle kinetic operator H0 (e.g. -1/2 Lap_h as
        a Laplacian1D/BSROperator/CallableOperator) on the grid.
    psi:     real condensate amplitude on the grid, [m].
    g, mu:   contact coupling and chemical potential.
    v_trap:  optional trap potential on the grid, [m].
    dipolar: optional exchange operator added to M (the reference's
        "+ dipolar" term).
    """
    dt = kinetic.dtype
    n_dens = (jnp.abs(psi) ** 2).astype(dt)
    v = jnp.zeros_like(n_dens) if v_trap is None else v_trap.astype(dt)
    base = v - mu + g * n_dens

    K = kinetic + DiagonalOperator(base)
    M = kinetic + DiagonalOperator(base + 2.0 * g * n_dens)
    if dipolar is not None:
        M = M + dipolar

    A = BlockDiag2Operator(top=M, bottom=K)
    m = psi.shape[0]
    B = BlockAntiDiagOperator(d=jnp.ones((m,), dt))
    return A, B, K, M


def bdg_preconditioner(
    A: LinearOperator,
    diag_A: jax.Array,
    *,
    kind: str = "jacobi",
    hi: Optional[float] = None,
    lo: Optional[float] = None,
    degree: int = 8,
) -> LinearOperator:
    """The planned-but-unbuilt reference preconditioner, two ways:

    - 'jacobi': T = diag(A)^-1 (pass diag_A = the [2m] diagonal).
    - 'chebyshev': T ~ A^-1 on [lo, hi] by `degree` Chebyshev steps
      (requires A's spectrum within (0, hi]; shift A first if needed).
    """
    if kind == "jacobi":
        return JacobiPreconditioner(diag_A)
    if kind == "chebyshev":
        if hi is None:
            raise ValueError("chebyshev preconditioner needs hi (>= ||A||)")
        lo = hi / 30.0 if lo is None else lo
        return ChebyshevFilter(
            op=A, lo=jnp.asarray(lo, A.dtype), hi=jnp.asarray(hi, A.dtype),
            degree=degree,
        )
    raise ValueError(f"unknown preconditioner kind {kind!r}")


def bdg_positive_start(key, m: int, size_sub: int, dtype) -> jax.Array:
    """B-positive initialization X = [w; w] (selects the +omega branch;
    reference pattern `tests/test_ilobpcg.c:194-204`)."""
    from lobpcg_tpu.utils.prng import fill_random

    w = fill_random(key, (m, size_sub), dtype)
    return jnp.concatenate([w, w], axis=0)
