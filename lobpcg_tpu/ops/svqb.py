"""SVQB orthonormalization (Duersch & Ye 2018, Alg. 4), fixed-shape.

Reference: `src/ortho/svqb_impl.inc:48-106` (operator metric) and
`src/ortho/svqb_mat_impl.inc:49-100` (dense metric, no dropping).

On-device design: the Gram eigendecomposition runs on the tiny k x k matrix
on device (`eigh`), and column dropping becomes a stable argsort
compaction over a fixed width — the retained count travels as an i32
scalar instead of a shrinking shape.  Dead (masked) coordinates are kept
exactly decoupled by identity injection, so the transform is the identity
on them and their output columns stay zero.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from lobpcg_tpu.ops import masking
from lobpcg_tpu.ops.gram import gram_self, gram_self_mat, mm, scale_diag
from lobpcg_tpu.operators.linop import LinearOperator


def _svqb_transform(G, count, tau, drop, dtype):
    """Shared core: from Gram matrix (live block only; dead zero) to the
    fused transform T = D * V * D_final with drop compaction.

    Internal math runs in G's dtype (the mixed-precision rr_dtype when
    set); T is cast to `dtype` (the storage dtype) at the end.
    Returns (T [k,k], n_kept i32).
    """
    k = G.shape[0]
    rdt = jnp.zeros((), G.dtype).real.dtype
    G = masking.inject_diag(G, count, 1.0)

    # Diagonal scaling D_ii = 1/sqrt(|G_ii|)  (svqb_impl.inc:66-70)
    D, Gs = scale_diag(G)
    D = D.astype(rdt)

    # Eigensolve of the scaled Gram (svqb_impl.inc:78)
    w, V = jnp.linalg.eigh(Gs)

    # Sentinel eigenpairs live on dead coordinates (eigenvalue exactly 1
    # by construction); identify by coordinate mass.
    sent = masking.dead_mass(V, count) > 0.5

    absw = jnp.abs(w)
    live_absw = jnp.where(sent, 0.0, absw)
    maxeig = jnp.max(live_absw)
    thresh = tau * maxeig

    if drop:
        dropped = (absw < thresh) | sent
    else:
        dropped = sent

    # D_final_jj = 1/sqrt(max(|lambda_j|, thresh))  (svqb_impl.inc:88-99)
    floor = jnp.maximum(absw, jnp.maximum(thresh, jnp.finfo(rdt).tiny))
    df = 1.0 / jnp.sqrt(floor)
    T = (D[:, None] * V) * df[None, :].astype(V.dtype)

    perm, n_kept = masking.compact_by_flag(dropped)
    T = masking.permute_cols(T, perm)
    T = masking.mask_cols(T, n_kept)
    return T.astype(dtype), n_kept


def svqb(
    U: jax.Array,
    count,
    B: Optional[LinearOperator] = None,
    *,
    tau: float,
    drop: bool,
    rr_dtype=None,
):
    """B-orthonormalize the first `count` columns of U (SVQB).

    Returns (U_new, n_kept).  Columns >= n_kept of U_new are zero.
    When drop=False, eigenvalues are clamped at tau*max|lambda| but all
    live columns are kept (n_kept == count).
    """
    U = masking.mask_cols(U, count)
    G = gram_self(U, B, out_dtype=rr_dtype)
    T, n_kept = _svqb_transform(G, count, tau, drop, U.dtype)
    U_new = mm(U, T)
    return masking.mask_cols(U_new, n_kept), n_kept


def robust_basis_init(X, B, key, *, tau, rr_dtype=None):
    """Full-rank B-orthonormal start basis from an arbitrary X0.

    SVQB with dropping removes dependent/zero columns; the dropped slots
    are refilled with random data and one more SVQB pass orthonormalizes
    the result.  Fixed shapes throughout (no cond): if X0 was already
    full rank the refill is a no-op.  This strengthens the reference,
    which only randomizes an all-zero X0 (`lobpcg_impl.inc:92-96`) and
    lets a singular start Gram reach Cholesky unchecked (its
    CODE_REVIEW.md C8).
    """
    from lobpcg_tpu.utils.prng import fill_random

    m = X.shape[1]
    X1, kept = svqb(X, jnp.int32(m), B, tau=tau, drop=True, rr_dtype=rr_dtype)
    rand = fill_random(key, X.shape, X.dtype)
    live = masking.as_mask(m, kept)
    X2 = jnp.where(live[None, :], X1, rand)
    X3, _ = svqb(X2, jnp.int32(m), B, tau=tau, drop=False, rr_dtype=rr_dtype)
    return X3


def svqb_mat(
    U: jax.Array,
    mat: jax.Array,
    *,
    tau: float,
):
    """SVQB against an explicit dense metric; never drops
    (`src/ortho/svqb_mat_impl.inc:54,99`).  All columns treated live.
    Runs entirely in U's dtype — in the mixed-precision path callers pass
    coefficient matrices already held in rr_dtype."""
    k = U.shape[1]
    G = gram_self_mat(U, mat)
    T, _ = _svqb_transform(G, jnp.int32(k), tau, False, U.dtype)
    return mm(U, T)
