"""Residuals, residual norms, and operator-norm estimation.

Reference: `src/residual/residual_impl.inc:32-99` and
`src/residual/estimate_norm_impl.inc:19-57`.

The residual W = A X - B X diag(lambda) is one fused SpMM +
broadcast-scale-subtract; XLA fuses the scale/subtract into the operator
application epilogue.  `estimate_norm` keeps the reference's 10-step power
iteration but with an explicit PRNG key (the reference's wall-clock
seeding is a reproducibility defect its own CODE_REVIEW flags).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from lobpcg_tpu.ops.gram import apply_block_op
from lobpcg_tpu.operators.linop import LinearOperator
from lobpcg_tpu.utils.prng import fill_random


def get_residual(
    X: jax.Array,
    AX: Optional[jax.Array],
    lam: jax.Array,
    A: LinearOperator,
    B: Optional[LinearOperator] = None,
    BX: Optional[jax.Array] = None,
) -> jax.Array:
    """W = A X - B X diag(lam).  AX may be a cached A@X (the reference's
    AX field, `residual_impl.inc:38-41`); BX likewise a pre-applied B@X
    (the ilobpcg recovery path reuses its top-of-iteration application)."""
    W = A.matmat(X) if AX is None else AX
    if BX is None:
        BX = apply_block_op(B, X)
    return W - BX * lam[None, :].astype(BX.dtype)


def get_residual_norm(
    W: jax.Array,
    lam: jax.Array,
    a_norm,
    b_norm,
    nev: int,
    BW: Optional[jax.Array] = None,
) -> jax.Array:
    """Backward-error style relative norms for the first nev columns:
    resNorm[i] = ||W[:, i]|| / (||A|| + |lam_i| * ||B||).
    Reference: `residual_impl.inc:77-99` (note: it uses the 2-norm even
    with B present — a defect its signature betrays, the B/wrk params
    are dead — we keep that as the parity default).

    ``BW``: pre-applied B @ W[:, :nev].  When given, the numerator is the
    B-seminorm ||w_i||_B = sqrt(|w_i^H B w_i|) — the scientifically right
    residual norm for generalized pencils (SolverConfig.residual_norm="b").
    The |.| guard makes it a valid seminorm for indefinite B too."""
    if BW is not None:
        nom = jnp.sqrt(jnp.abs(
            jnp.sum(W[:, :nev].conj() * BW[:, :nev], axis=0).real
        ))
    else:
        nom = jnp.sqrt(jnp.sum(jnp.abs(W[:, :nev]) ** 2, axis=0))
    b_norm = jnp.where(b_norm > 0, b_norm, 1.0)
    # lam may be high precision (mixed-precision RR); norms stay in the
    # storage real dtype so the solver carry keeps a fixed dtype.
    denom = a_norm + jnp.abs(lam[:nev]).astype(nom.dtype) * b_norm
    return (nom / denom).astype(nom.dtype)


def estimate_norm(
    A: LinearOperator,
    key: jax.Array,
    iters: int = 10,
    block: int = 1,
) -> jax.Array:
    """||A|| estimate via power iteration from a random start block.
    Reference: `estimate_norm_impl.inc:38-57` (single vector there).

    ``block`` > 1 runs the power iteration on a [n, block] block — each
    column normalized independently, the estimate is the max per-column
    growth.  A [n, 8] block streams A once per step, like a [n, 1]
    one, while giving 8 independent starts — materially better
    estimates for clustered
    spectra (a single random start can have tiny overlap with the
    dominant eigenspace).  block=1 reproduces the reference exactly.
    """
    n = A.shape[0]
    v = fill_random(key, (n, block), A.dtype)
    nrm0 = jnp.sqrt(jnp.sum(jnp.abs(v) ** 2, axis=0))
    v = v / jnp.where(nrm0 > 0, nrm0, 1.0).astype(v.dtype)

    def body(_, carry):
        v, _ = carry
        w = A.matmat(v)
        nrm = jnp.sqrt(jnp.sum(jnp.abs(w) ** 2, axis=0))
        w = jnp.where(nrm > 0, w / jnp.where(nrm > 0, nrm, 1.0).astype(w.dtype), w)
        return w, nrm

    _, nrm = jax.lax.fori_loop(0, iters, body, (v, nrm0))
    return jnp.max(nrm)
