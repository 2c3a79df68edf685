"""Rayleigh-Ritz projected eigensolves (standard family).

Reference: `src/rayleigh/rayleigh_ritz_impl.inc:37-99` (initial RR) and
`src/rayleigh/rayleigh_ritz_modified_impl.inc:42-269` (per-iteration RR
with the Cholesky/ortho dual path, trcon condition check, and the
Duersch Alg. 7 Cp extraction).

On-device design notes:
- The B-Gram whitening transform (the reference's potrf + trsm_run,
  `rayleigh_ritz_impl.inc:60-75`) is computed SPECTRALLY — eigh of the
  Jacobi-scaled Gram, DiR = D U s^{-1/2} — never via
  `jnp.linalg.cholesky`/`solve_triangular`, whose XLA expanders may run
  their internal dots at DEFAULT (reduced) precision and cap the
  factorable condition number (ops/pencil.py docstring).
  Non-definiteness (eigh s_min <= 0) is signalled with the reference's
  `useOrtho = 2` retry flag, exactly like the old potrf-NaN detection.
- The triangular condition check replaces LAPACK's `trcon` 1-norm
  *estimator* with the exact spectral rcond of the scaled Gram
  (sqrt(s_min/s_max) — the same quantity trcon estimates for the
  triangular factor), a free by-product of the whitening eigh.
- Dead subspace coordinates (masked P/W columns, see ops.masking) carry
  identity in the B-Gram and a large sentinel in the (transformed) A-Gram
  so their Ritz pairs sort to the top end and never pollute the lowest nx.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from lobpcg_tpu.ops import masking
from lobpcg_tpu.ops.gram import (
    _hdot,
    as_blocks,
    blocks_dtype,
    frob_norm,
    gram_blocks,
    gram_blocks_pre,
    gram_self,
    mm,
    scale_diag as _scale_diag,
)
from lobpcg_tpu.operators.linop import LinearOperator


class RRResult(NamedTuple):
    Cx: jax.Array  # [k, nx]
    Cp: jax.Array  # [k, nx] — columns >= p_count are zero
    lam: jax.Array  # [nx] real
    flag: jax.Array  # i32: 0/1 = ok (value of useOrtho), 2 = retry needed
    p_count: jax.Array  # i32 — number of valid Cp columns (the
    # reference's nretain bookkeeping, `rayleigh_ritz_modified_impl.inc:56`)


def _whiten_block(M):
    """Spectral whitening of ONE Hermitian block: F = D U s^{-1/2} from
    eigh(D M D) = U s U^H satisfies F^H M F = I when M is HPD.  Stays
    full-precision where the cholesky/triangular-solve expanders may
    emit default-precision dots (see ops.pencil._whiten_scored).

    Dead coordinates (exactly isolated identity rows/cols by the
    inject_diag invariant) are ordinary unit eigendirections of the
    scaled block here; the eigensolver may mix them with live
    directions at an accidental s ~ 1 degeneracy, which is fine —
    the chol_branch plants its dead sentinels in PENCIL form (see
    there), which is alignment-indifferent.

    Returns (F, ok, s_min, s_max) over the full scaled spectrum —
    matching the old Cholesky pivot score's accounting, where dead
    pivots contributed exactly 1.
    """
    D, Ms = _scale_diag(M)
    s, U = jnp.linalg.eigh(Ms)  # ascending
    ok = jnp.isfinite(s[0]) & (s[0] > 0) & (s[-1] > 0)
    s_safe = jnp.where(s > 0, s, 1.0)
    F = (D[:, None].astype(U.dtype) * U) * jax.lax.rsqrt(s_safe)[
        None, :
    ].astype(U.dtype)
    return F, ok, s_safe[0], s_safe[-1]


def _block_dinv_r(G, nx: int):
    """Whitening transform for the B-Gram over [X | P W]: DiR with
    DiR^H G DiR = I, BLOCK-upper-triangular with the block boundary at
    nx (block Gram-Schmidt: whiten the X block, B-orthogonalize the
    [P W] complement against it via the Schur complement, whiten that).

    Replaces the reference's potrf + trsm_run pipeline
    (`rayleigh_ritz_impl.inc:60-75`) without jnp.linalg.cholesky /
    solve_triangular, whose XLA expanders may run their internal dots at
    DEFAULT (reduced) precision and cap the factorable condition number
    (ops/pencil.py docstring).

    The block-triangular structure is LOAD-BEARING, not cosmetic:
    Duersch's Cp extraction (_cp_extract) reads the first nx rows of
    the H-eigenvectors as "X-content", which is only meaningful when
    the first nx whitened basis vectors span exactly span(X).  A fully
    mixing spectral whitening of the whole Gram makes Cp a rotation of
    the unwanted subspace that keeps X components in P, and the
    three-term recurrence measurably stalls (n=256 f64 repro: 134
    iterations with the triangular factor -> no convergence in 300
    with full spectral mixing).  Mixing WITHIN the trailing [P W]
    block is harmless — the extraction uses no finer structure, and
    dead-coordinate sentinels are planted in alignment-indifferent
    pencil form by the caller.

    Returns (DiR [k,k], ok bool, rcond real): ok = both stages
    positive definite (the potrf-succeeded analog); rcond =
    sqrt(min stage s_min / max stage s_max), on the scale of the
    triangular-factor rcond the reference's trcon check thresholds
    with tol_skip (`rayleigh_ritz_modified_impl.inc:168-178`).
    """
    k = G.shape[0]
    Fx, ok1, s1_lo, s1_hi = _whiten_block(G[:nx, :nx])  # X: always live
    E = mm(Fx.conj().T, G[:nx, nx:])  # whitened-X cross coefficients
    Sc = G[nx:, nx:] - mm(E.conj().T, E)  # Schur complement
    Sc = 0.5 * (Sc + Sc.conj().T)
    Fs, ok2, s2_lo, s2_hi = _whiten_block(Sc)
    top = jnp.concatenate([Fx, -mm(Fx, mm(E, Fs))], axis=1)
    bot = jnp.concatenate(
        [jnp.zeros((k - nx, nx), Fs.dtype), Fs], axis=1
    )
    DiR = jnp.concatenate([top, bot], axis=0)
    ok = ok1 & ok2
    rcond = jnp.where(
        ok,
        jnp.sqrt(jnp.minimum(s1_lo, s2_lo) / jnp.maximum(s1_hi, s2_hi)),
        jnp.asarray(0.0, s1_lo.real.dtype),
    )
    return DiR, ok, rcond


def _sentinel(H, live):
    """Inject big*I into dead coordinates; big > any live eigenvalue."""
    big = 2.0 * frob_norm(H) + 1.0
    return masking.inject_diag(H, live, big.astype(H.dtype))


def _cp_extract(Z, nx: int, DiR: Optional[jax.Array], n_live):
    """Duersch Alg. 7: Cp = [D_inv_R] V_perp Q, Q = QR-basis of Z1_perp^T.

    Z1_perp^T is the plain transpose (no conjugate — parity with the C
    code's element copy, `rayleigh_ritz_modified_impl.inc:228-235`).

    Only the *live* unwanted eigenvectors participate: eigenvalues are
    sorted ascending and dead-coordinate sentinels carry the largest
    values, so live unwanted eigenvectors are the first (n_live - nx)
    columns of Z_perp.  Sentinel columns are masked before the QR and the
    result is truncated to p_count = clip(n_live - nx, 0, nx) columns —
    otherwise QR's orthonormal-complement columns are pure sentinel
    directions, Cp picks them up, and the next iteration's basis gets
    numerically-zero live P columns whose Ritz pairs are spurious
    (lambda ~ 0, residual ~ 0, falsely converged).  This is the
    fixed-shape analog of the reference's shrinking `nretain`
    (`rayleigh_ritz_modified_impl.inc:56`).

    Returns (Cp [k, nx], p_count i32).
    """
    k = Z.shape[0]
    Zp = Z[:, nx:]  # [k, k-nx] unwanted eigenvectors
    zp_live = jnp.clip(n_live - nx, 0, k - nx)
    p_count = jnp.clip(n_live - nx, 0, nx).astype(jnp.int32)
    Zp = masking.mask_cols(Zp, zp_live)
    Z1t = jnp.swapaxes(Zp[:nx, :], 0, 1)  # [k-nx, nx]
    # jnp.linalg.qr is DELIBERATE here despite possible default-precision
    # internal dots — unlike the whitening transforms (see
    # _block_dinv_r), Q's orthonormality is not load-bearing: P is never
    # assumed orthonormal downstream (the next RR's Gram whitening
    # absorbs its conditioning), so reduced-precision orthogonality error only
    # perturbs the momentum directions slightly.  A Gram-eigh
    # orthonormalization was tried instead and is WORSE: for a
    # rank-deficient Z1t (late-stage W ~ 0) it rsqrt-amplifies
    # roundoff-level eigendirections into junk unit-norm live P columns
    # whose Ritz values are spurious near-zeros (measured: f64
    # generalized-pencil solves "converged" to three ~1e-14 eigenvalues),
    # where QR's completion columns are at least exactly orthonormal
    # and act as harmless noise directions.
    Q, _ = jnp.linalg.qr(Z1t)
    Cp = mm(Zp, Q)
    if DiR is not None:
        Cp = mm(DiR, Cp)
    return masking.mask_cols(Cp, p_count), p_count


def rayleigh_ritz(
    X: jax.Array,
    A: LinearOperator,
    B: Optional[LinearOperator] = None,
    rr_dtype=None,
):
    """Initial RR on a full-width block: returns (Cx [m,m], lam [m]).

    Reference: `rayleigh_ritz_impl.inc:37-99` — B-Gram, D-scaling,
    Cholesky, congruence transform, eigh, back-transform.
    Mixed precision: Grams accumulate in rr_dtype and the projected solve
    runs in it; Cx is cast back to X's dtype, lam stays high.
    """
    G = gram_self(X, B, out_dtype=rr_dtype)
    # Single full-width block: no Cp extraction downstream, so the plain
    # (fully mixing) spectral whitening is fine here.
    DiR, def_ok, _, _ = _whiten_block(G)
    # Old-potrf parity: a non-definite start Gram poisons the outputs
    # visibly (the public drivers B-orthonormalize X first, so this only
    # fires on a rank-deficient user-supplied basis).
    DiR = jnp.where(def_ok, DiR, jnp.asarray(jnp.nan, DiR.dtype))
    Ap = gram_self(X, A, out_dtype=rr_dtype)
    T1 = mm(Ap, DiR)
    H = mm(DiR.conj().T, T1)
    w, V = jnp.linalg.eigh(H)
    Cx = mm(DiR, V)
    return Cx.astype(X.dtype), w


def _a_gram(blocks, AX, A, out_dtype=None):
    """G_A = S^H A S assembled per column block of S = [X | P | W];
    reuses the AX cache for the X block (`rayleigh_ritz_modified_impl.inc:
    71-78, 189-196`).  S is never concatenated and only upper-triangle
    tall contractions run (A Hermitian; see ops.gram.herm_tile_gram —
    the lower tiles are mirrored, 6 dots instead of 9).  Applications
    run one block at a time, so only a single [n, m] transient is live.
    """
    from lobpcg_tpu.ops.gram import applied_blocks, herm_tile_gram

    pre = {0: AX} if AX is not None else {}
    applied = applied_blocks(A, blocks, pre)
    return herm_tile_gram(blocks, applied, out_dtype)


def rayleigh_ritz_modified(
    S: jax.Array,
    AX: Optional[jax.Array],
    np_act,
    nw_act,
    use_ortho,
    A: LinearOperator,
    B: Optional[LinearOperator] = None,
    *,
    nx: int,
    tol_skip: float = 5e-3,
    rr_dtype=None,
    Bblocks=None,
) -> RRResult:
    """Per-iteration RR over the masked [X|P|W] subspace.

    S is the search subspace, either a materialized [n, 3m] array or a
    tuple of blocks (X, P, W) — the driver passes blocks so S never
    exists in HBM.  np_act / nw_act are the live P / W column counts; X
    is always fully live.  `use_ortho` (traced i32) selects the branch;
    the Cholesky branch reports flag=2 when potrf fails or
    rcond < tol_skip, matching `rayleigh_ritz_modified_impl.inc:144-178`.

    ``Bblocks``: optional pre-applied (B@X, B@P, B@W) matching the S
    blocks — the Cholesky branch's B-Gram then costs zero operator
    applications (gram_blocks_pre).
    """
    blocks = as_blocks(S, nx)
    k = sum(b.shape[1] for b in blocks)
    m = nx
    live = masking.blocks_mask((m, m, k - 2 * m), (m, np_act, nw_act))
    n_live = m + np_act + nw_act
    # No tall [n, 3m] masking copy: dead-coordinate exclusion happens on
    # the k x k Grams via inject_diag (zeroing dead rows/cols exactly),
    # which costs O(k^2) instead of two resident n x 3m buffers — the
    # single largest HBM consumer at capacity-bound sizes.
    GA = masking.inject_diag(
        _a_gram(blocks, AX, A, out_dtype=rr_dtype), live, 0.0
    )
    sdt = blocks_dtype(S)

    def ortho_branch(_):
        H = _sentinel(GA, live)
        w, Z = jnp.linalg.eigh(H)
        Cx = Z[:, :nx]
        lam = w[:nx]
        Cp, p_cnt = _cp_extract(Z, nx, None, n_live)
        return RRResult(
            Cx.astype(sdt), Cp.astype(sdt), lam, jnp.int32(1), p_cnt
        )

    def chol_branch(_):
        GB = (
            gram_blocks(blocks, B, out_dtype=rr_dtype) if Bblocks is None
            else gram_blocks_pre(blocks, Bblocks, out_dtype=rr_dtype)
        )
        GB = masking.inject_diag(GB, live, 1.0)
        DiR, def_ok, rcond = _block_dinv_r(GB, nx)
        ok = def_ok & (rcond >= tol_skip)
        # Guard the non-definite case so downstream stays finite (the
        # flag=2 retry discards this branch's outputs anyway).
        DiR = jnp.where(def_ok, DiR, jnp.eye(k, dtype=DiR.dtype))
        T1 = mm(GA, DiR)
        H = mm(DiR.conj().T, T1)
        H = 0.5 * (H + H.conj().T)
        # Dead-coordinate sentinels in PENCIL form: after a (possibly
        # coordinate-mixing) spectral whitening the dead directions are
        # no longer coordinate-aligned in H, so inject_diag on H would
        # hit the wrong entries.  Instead GA + big * P_dead gives every
        # dead pencil pair eigenvalue exactly `big` (GB's dead diagonal
        # is exactly 1 and DiR whitens GB on all coordinates), i.e.
        # H' = H + big * K^H K with K = the dead ROWS of DiR.  big is
        # a Gershgorin bound off the ACTUAL H — strictly above every
        # live Ritz value, never overflowing (an a-priori ||DiR||^2
        # amplification bound measured up to ~1e34 and overflowed f32).
        gersh = jnp.max(jnp.sum(jnp.abs(H), axis=1)).real
        big = (2.0 * gersh + 1.0).astype(H.dtype)
        dead_rows = jnp.where(live, 0.0, 1.0).astype(DiR.dtype)
        K = DiR * dead_rows[:, None]
        H = H + big * mm(K.conj().T, K)
        w, Z = jnp.linalg.eigh(H)
        Cx = mm(DiR, Z[:, :nx])
        lam = w[:nx]
        Cp, p_cnt = _cp_extract(Z, nx, DiR, n_live)
        flag = jnp.where(ok, jnp.int32(0), jnp.int32(2))
        return RRResult(Cx.astype(sdt), Cp.astype(sdt), lam, flag, p_cnt)

    return jax.lax.cond(use_ortho >= 1, ortho_branch, chol_branch, None)
