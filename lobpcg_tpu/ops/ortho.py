"""Robust basis maintenance: ortho_drop / ortho_indefinite (+_mat).

Reference: `src/ortho/ortho_drop_impl.inc:43-125`,
`src/ortho/ortho_indefinite_impl.inc:71-169`,
`src/ortho/ortho_indefinite_mat_impl.inc:52-123`.

The outer/inner iteration structure (project against V, SVQB-orthonormalize,
check Frobenius errors, early-exit) is kept, expressed as
`lax.while_loop`s with the early-exit tolerance checks in the loop
condition — so converged calls really do stop early on device.  Column
counts travel as i32 scalars (see ops.masking).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from lobpcg_tpu.ops import masking
from lobpcg_tpu.ops.gram import (
    _hdot,
    apply_block_op,
    as_blocks,
    b_mm,
    bh_dot,
    frob_norm,
    gram_blocks,
    gram_cross_mat,
    gram_self_mat,
    herm_tile_gram,
    mm,
    ortho_err,
)
from lobpcg_tpu.ops.gram import scale_diag
from lobpcg_tpu.ops.svqb import _svqb_transform, svqb_mat
from lobpcg_tpu.operators.linop import LinearOperator


def _guard(x, eps):
    """Reference pattern: norms below eps are replaced by 1 to avoid
    dividing by ~0 (`ortho_drop_impl.inc:69`)."""
    return jnp.where(x < eps, jnp.ones_like(x), x)


def _bnorm(B, vb):
    """||B V||_F over V's column blocks — one [n, m] B-application
    transient at a time."""
    total = None
    for b in vb:
        Bb = apply_block_op(B, b)
        t = jnp.sum(jnp.abs(Bb) ** 2).real
        total = t if total is None else total + t
    return jnp.sqrt(total)


def _inner_err_ok(U, BU, G, nu, B, eps_ortho, *, indefinite):
    """The inner-loop convergence criterion evaluated on a given state:
    ortho_drop normalizes by ||B U||*||U|| (`ortho_drop_impl.inc:97-110`);
    ortho_indefinite by ||U||^2 (`ortho_indefinite_impl.inc:141-151`)."""
    err = ortho_err(G, nu)
    U_norm = _guard(frob_norm(U), eps_ortho)
    if indefinite:
        denom = U_norm * U_norm
    else:
        BU_norm = U_norm if B is None else _guard(frob_norm(BU), eps_ortho)
        denom = BU_norm * U_norm
    return err / denom < eps_ortho


def _svqb_inner_loop(
    U, BU0, G0, nu, B, eps_ortho, eps_drop, max_inner, *, indefinite,
    rr_dtype=None, seed_done=False
):
    """Shared inner loop: repeat svqb until ||U^H B U - I_sig|| is small.

    Both the k x k Gram G = U^H B U and the [n, m] application BU are
    carried (initialized by the caller from its single seed application),
    so each iteration costs ONE operator application, and on exit BU
    matches the returned U exactly — the caller's outer-loop convergence
    check and the driver's B-Gram assembly reuse it instead of
    re-applying B (ops.gram.gram_blocks_pre).  The BU carry costs one
    [n, m] block in the loop state; it pays for itself by deleting one
    B application per outer step AND the three B applications of the
    per-iteration B-Gram downstream.

    ortho_drop normalizes by ||B*U||*||U|| (`ortho_drop_impl.inc:97-110`);
    ortho_indefinite by ||U||^2 (`ortho_indefinite_impl.inc:141-151`).
    Returns (U, BU, nu).

    ``seed_done`` (the ortho_skip experiment):
    evaluate the convergence criterion on the SEED state (G0/BU0) so an
    already-orthonormal entry skips the SVQB pass entirely — on outer
    passes >= 2 the projection often no longer perturbs U, and the
    default always-run-once structure re-SVQBs for nothing.  Off (the
    parity default) the first pass always runs, like the reference.
    """

    def cond(carry):
        _, _, _, _, i, done = carry
        return (i < max_inner) & ~done

    def body(carry):
        U, _, G, nu, i, _ = carry
        T, nu2 = _svqb_transform(G, nu, eps_drop, True, U.dtype)
        U2 = masking.mask_cols(mm(U, T), nu2)
        BU2 = apply_block_op(B, U2)
        G2 = _hdot(U2, BU2, rr_dtype)
        done = _inner_err_ok(
            U2, BU2, G2, nu2, B, eps_ortho, indefinite=indefinite
        )
        return U2, BU2, G2, nu2, i + 1, done

    done0 = (
        _inner_err_ok(U, BU0, G0, nu, B, eps_ortho, indefinite=indefinite)
        if seed_done else jnp.bool_(False)
    )
    U, BU, _, nu, _, _ = jax.lax.while_loop(
        cond, body, (U, BU0, G0, nu, jnp.int32(0), done0)
    )
    return U, BU, nu


def _entry_state(U, nu, B, vb, Bvb, BV_norm, eps_ortho, eps_drop,
                 rr_dtype, *, indefinite):
    """ortho_skip entry check: is U already
    B-orthonormal up to COLUMN SCALING, and B-orthogonal to V?

    Column scaling first: W arrives unnormalized (fresh residuals /
    preconditioner output), so testing the raw Gram against I would
    never pass; the scaled test D G D with D = 1/sqrt|diag G| asks the
    right question — are the directions already orthogonal — and the
    scaling itself is the cheap fix for what remains.  Returns
    (U_scaled, B@U_scaled, skip) — on skip the caller's loop never runs
    and the scaled U (with its matching BU) is the result.  Cost when
    not skipped: one B application + two k x k contractions.

    Degenerate-column floor: the 1/sqrt(|G_ii|) scaling
    amplifies a near-B-null column by a huge factor, and if the scaled
    Gram then happens to pass the eps_ortho test the skip would bypass
    the SVQB eps_drop machinery that exists to DROP such columns — so
    the skip additionally requires every live |G_ii| to sit above an
    eps_drop-scale floor relative to the largest; otherwise fall
    through to the full pass.
    """
    BU = apply_block_op(B, U)
    G = _hdot(U, BU, rr_dtype)
    D, Gs = scale_diag(G)
    Dc = D.astype(U.dtype)
    U = U * Dc[None, :]  # dead cols: guarded D = 1, stay exactly zero
    BU = BU * Dc[None, :]
    gd = jnp.abs(jnp.diagonal(G))
    live = (
        jax.lax.broadcasted_iota(jnp.int32, gd.shape, 0) < jnp.int32(nu)
    )
    gmax = jnp.max(jnp.where(live, gd, 0.0))
    gmin = jnp.min(jnp.where(live, gd, jnp.inf))
    floor_ok = gmin >= eps_drop * gmax  # vacuously true when nu == 0
    ok_self = floor_ok & _inner_err_ok(
        U, BU, Gs, nu, B, eps_ortho, indefinite=indefinite
    )
    coef = (
        bh_dot(Bvb, U, rr_dtype) if Bvb is not None
        else bh_dot(vb, BU, rr_dtype)
    )
    U_norm = _guard(frob_norm(U), eps_ortho)
    rerr = frob_norm(coef) / (BV_norm * U_norm)
    return U, BU, ok_self & (rerr < eps_ortho)


def ortho_drop(
    U: jax.Array,
    nu,
    V: jax.Array,
    nv,
    B: Optional[LinearOperator] = None,
    *,
    eps_ortho: float,
    eps_drop: float,
    max_outer: int = 3,
    max_inner: int = 3,
    rr_dtype=None,
    Bvb=None,
    return_bu: bool = False,
    entry_check: bool = False,
):
    """B-orthogonalize U against V (B positive semi-definite), with
    column dropping.  Returns (U_new, retained_count).

    V is the external basis — a [n, kv] array or a tuple of blocks
    (X, P); dead V columns are exactly zero by the driver invariant
    (soft locking writes zero-masked P), so no tall masking copy is
    needed (`nv` stays in the signature for the contract).
    Reference: `src/ortho/ortho_drop_impl.inc:43-125`.

    Operator-application economy (B Hermitian by the problem contract):
    ``Bvb`` — pre-applied (B@X, B@P) — turns the projector coefficient
    V^H B U into (B V)^H U and sources ||B V|| directly, removing one B
    application per outer step plus the entry norm pass;
    ``return_bu=True`` additionally returns the exit B@U (matching the
    returned U exactly) so the caller's B-Gram can reuse it.  See
    ortho_indefinite for the same contract on the signature-weighted
    path.
    """
    nu = jnp.int32(nu)
    del nv
    vb = as_blocks(V, U.shape[1])
    U = masking.mask_cols(U, nu)

    if Bvb is not None:
        bv2 = sum(jnp.sum(jnp.abs(Bb) ** 2).real for Bb in Bvb)
        BV_norm = _guard(jnp.sqrt(bv2), eps_ortho)
    else:
        BV_norm = _guard(_bnorm(B, vb), eps_ortho)

    def cond(carry):
        _, _, _, outer, done = carry
        return (outer < max_outer) & ~done

    def body(carry):
        U, _, nu, outer, _ = carry
        # Project: U -= V (V^H B U), then one more application of the
        # projected U seeds the inner loop — two B applications per outer
        # step (one with Bvb) plus one per inner step; the final check
        # reuses the inner loop's last BU instead of a fourth application.
        coef = (
            bh_dot(Bvb, U) if Bvb is not None else
            bh_dot(vb, apply_block_op(B, U))
        )
        U = masking.mask_cols(U - b_mm(vb, coef), nu)
        BU = apply_block_op(B, U)
        G0 = _hdot(U, BU, rr_dtype)
        U, BU, nu = _svqb_inner_loop(
            U, BU, G0, nu, B, eps_ortho, eps_drop, max_inner,
            indefinite=False, rr_dtype=rr_dtype, seed_done=entry_check,
        )
        # Check ||V^H B U||_F (BU is exactly B @ the returned U).
        coef2 = bh_dot(vb, BU)
        U_norm = _guard(frob_norm(U), eps_ortho)
        rerr = frob_norm(coef2) / (BV_norm * U_norm)
        return U, BU, nu, outer + 1, rerr < eps_ortho

    if entry_check:
        # ortho_skip: an already-orthonormal U (after column scaling)
        # skips the loop entirely; its real BU seeds the carry so the
        # skip path still returns a valid B@U.
        U, BU0, done0 = _entry_state(
            U, nu, B, vb, Bvb, BV_norm, eps_ortho, eps_drop, rr_dtype,
            indefinite=False,
        )
    else:
        # done starts False, so the body (and the BU carry) runs at
        # least once — the zeros seed is never returned.
        BU0, done0 = jnp.zeros_like(U), jnp.bool_(False)
    U, BU, nu, _, _ = jax.lax.while_loop(
        cond, body, (U, BU0, nu, jnp.int32(0), done0)
    )
    if return_bu:
        return U, nu, BU
    return U, nu


def ortho_indefinite(
    U: jax.Array,
    nu,
    V: jax.Array,
    nv,
    B: Optional[LinearOperator] = None,
    sig: Optional[jax.Array] = None,
    *,
    eps_ortho: float,
    eps_drop: float,
    max_outer: int = 3,
    max_inner: int = 3,
    rr_dtype=None,
    Bvb=None,
    return_bu: bool = False,
    entry_check: bool = False,
):
    """Signature-weighted B-orthogonalization of U against V (B indefinite).

    Projection uses the B-orthogonal projector V sig (V^H B U) where
    sig = V^H B V (computed when not supplied).  V may be a tuple of
    blocks (X, P); dead V columns are exactly zero (driver invariant).
    Reference: `src/ortho/ortho_indefinite_impl.inc:71-169`.

    Operator-application economy (B is Hermitian by the problem
    contract): when the caller supplies ``Bvb`` — the pre-applied tuple
    (B@X, B@P) — the projector coefficients V^H B U are computed as
    (B V)^H U, the external Gram sig and ||B V|| come from Bvb, and the
    only remaining applications are the one seed per outer step plus one
    per inner step.  With ``return_bu=True`` the final B@U (exactly
    matching the returned U) is returned third, so the driver's B-Gram
    re-uses it (gram_blocks_pre) instead of re-applying B.  The
    reference re-applies B at each of these sites
    (`ortho_indefinite_impl.inc:84-130`, `gram_impl.inc:49-67`).
    """
    nu = jnp.int32(nu)
    del nv
    vb = as_blocks(V, U.shape[1])
    U = masking.mask_cols(U, nu)

    if Bvb is not None:
        if sig is None:
            # sig = V^H B V from the pre-applied blocks; dead V columns
            # give exactly-zero rows/cols, so the projector vanishes on
            # them — no injection needed.  Upper-triangle assembly (B
            # Hermitian): 3 tall dots instead of 4.
            sig = herm_tile_gram(vb, Bvb)
        bv2 = sum(jnp.sum(jnp.abs(Bb) ** 2).real for Bb in Bvb)
        BV_norm = _guard(jnp.sqrt(bv2), eps_ortho)
    else:
        if sig is None:
            sig = gram_blocks(vb, B)
        BV_norm = _guard(_bnorm(B, vb), eps_ortho)

    def cond(carry):
        _, _, _, outer, done = carry
        return (outer < max_outer) & ~done

    def body(carry):
        U, _, nu, outer, _ = carry
        coef = (
            bh_dot(Bvb, U) if Bvb is not None else
            bh_dot(vb, apply_block_op(B, U))
        )
        tmp = mm(sig, coef)
        U = masking.mask_cols(U - b_mm(vb, tmp), nu)
        BU = apply_block_op(B, U)
        G0 = _hdot(U, BU, rr_dtype)
        U, BU, nu = _svqb_inner_loop(
            U, BU, G0, nu, B, eps_ortho, eps_drop, max_inner,
            indefinite=True, rr_dtype=rr_dtype, seed_done=entry_check,
        )
        coef2 = bh_dot(vb, BU)
        U_norm = _guard(frob_norm(U), eps_ortho)
        rerr = frob_norm(coef2) / (BV_norm * U_norm)
        return U, BU, nu, outer + 1, rerr < eps_ortho

    if entry_check:
        # ortho_skip: see ortho_drop — scaled entry test, real BU seed.
        U, BU0, done0 = _entry_state(
            U, nu, B, vb, Bvb, BV_norm, eps_ortho, eps_drop, rr_dtype,
            indefinite=True,
        )
    else:
        # done starts False, so the outer body (and with it the BU
        # carry) always executes at least once — the zeros seed is never
        # returned.
        BU0, done0 = jnp.zeros_like(U), jnp.bool_(False)
    U, BU, nu, _, _ = jax.lax.while_loop(
        cond, body, (U, BU0, nu, jnp.int32(0), done0)
    )
    if return_bu:
        return U, nu, BU
    return U, nu


def ortho_indefinite_mat(
    U: jax.Array,
    V: jax.Array,
    mat: jax.Array,
    *,
    eps_ortho: float,
    eps_drop: float,
    max_outer: int = 3,
    max_inner: int = 3,
) -> jax.Array:
    """Coefficient-space orthogonalization against an explicit dense
    indefinite metric, with double projection
    U -= V (V^H mat V) (V^H mat U) applied as two single projections
    (reference computes it right-to-left the same way,
    `src/ortho/ortho_indefinite_mat_impl.inc:77-98`).  No dropping.
    """
    MV_norm = _guard(
        frob_norm(mm(mat, V)),
        eps_ortho,
    )

    def inner(U):
        def cond(c):
            _, i, done = c
            return (i < max_inner) & ~done

        def body(c):
            U, i, _ = c
            U = svqb_mat(U, mat, tau=eps_drop)
            G = gram_self_mat(U, mat)
            err = ortho_err(G)
            U_norm = _guard(frob_norm(U), eps_ortho)
            return U, i + 1, err / (U_norm * U_norm) < eps_ortho

        U, _, _ = jax.lax.while_loop(cond, body, (U, jnp.int32(0), jnp.bool_(False)))
        return U

    def cond(carry):
        _, outer, done = carry
        return (outer < max_outer) & ~done

    def body(carry):
        U, outer, _ = carry
        # Double projection, right to left.
        c1 = gram_cross_mat(V, U, mat)
        t1 = mm(V, c1)
        c2 = gram_cross_mat(V, t1, mat)
        U = U - mm(V, c2)
        U = inner(U)
        c3 = gram_cross_mat(V, U, mat)
        U_norm = _guard(frob_norm(U), eps_ortho)
        rerr = frob_norm(c3) / (MV_norm * U_norm)
        return U, outer + 1, rerr < eps_ortho

    U, _, _ = jax.lax.while_loop(cond, body, (U, jnp.int32(0), jnp.bool_(False)))
    return U
