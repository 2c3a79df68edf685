"""Chebyshev approximate-inverse preconditioner.

The reference accepts an arbitrary user preconditioner T
(`include/lobpcg/linop.h`, applied at `src/core/lobpcg_impl.inc:152-155`)
but ships none.  On an accelerator the natural one is a matrix polynomial:
p(A) costs `degree` extra operator applications per T-apply — pure SpMM
throughput, which the hardware has in abundance — and collapses the
iteration count for stiff spectra (1/h^2-scaled Laplacians need
thousands of unpreconditioned iterations).

T = p(A) ~ A^{-1} via the Chebyshev semi-iteration for A y = x over the
interval [lo, hi] (Saad, Iterative Methods, Alg. 12.1): after d steps the
residual polynomial is the scaled-and-shifted Chebyshev T_d, so
|1 - lambda p(lambda)| is Chebyshev-small on [lo, hi] and p stays
POSITIVE there — T is an SPD preconditioner, which LOBPCG requires (the
raw Chebyshev polynomial itself oscillates in sign on [lo, hi] and makes
the solver diverge).

Pick hi >= lambda_max (estimate_norm) and lo somewhere above the wanted
eigenvalues; even lo = hi/30 cuts iterations several-fold.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lobpcg_tpu.operators.linop import LinearOperator, operator


@operator(data_fields=("op", "lo", "hi"), meta_fields=("degree", "chunk"))
class ChebyshevFilter(LinearOperator):
    """T ~ A^{-1} on [lo, hi] by `degree` Chebyshev-iteration steps.

    Use as the `T` argument of lobpcg/ilobpcg.  Requires the operator's
    spectrum within (0, hi] (shift first if A is indefinite).

    `chunk`: apply the (linear) recurrence per column block of that
    width — the iteration holds ~4 [n, chunk] blocks live, so chunking
    halves/quarters the transient HBM at capacity-bound sizes.
    """

    op: LinearOperator
    lo: jax.Array  # scalar: lower edge of the approximated interval
    hi: jax.Array  # scalar: upper edge (>= spectral radius)
    degree: int = 8
    chunk: int = 0  # 0 = whole block at once

    def matmat(self, X):
        n, k = X.shape
        if self.chunk and self.chunk < k and k % self.chunk == 0:
            # lax.map serializes the chunks (a plain Python loop would
            # let the scheduler run them concurrently and keep every
            # chunk's recurrence transients live at once).
            C = k // self.chunk
            Xc = jnp.moveaxis(X.reshape(n, C, self.chunk), 1, 0)
            Yc = jax.lax.map(self._apply, Xc)
            return jnp.moveaxis(Yc, 0, 1).reshape(n, k)
        return self._apply(X)

    def _apply(self, X):
        dt = X.dtype
        theta = jnp.asarray((self.hi + self.lo) / 2.0, dt)
        delta = jnp.asarray((self.hi - self.lo) / 2.0, dt)
        sigma1 = theta / delta

        rho = 1.0 / sigma1
        d = X / theta
        y = d
        for _ in range(self.degree - 1):
            rho_next = 1.0 / (2.0 * sigma1 - rho)
            d = rho_next * rho * d + (2.0 * rho_next / delta) * (
                X - self.op.matmat(y)
            )
            y = y + d
            rho = rho_next
        return y

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return self.op.dtype
