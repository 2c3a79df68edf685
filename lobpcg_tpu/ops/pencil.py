"""Projected generalized (nonsymmetric pencil) eigensolve for the
indefinite Rayleigh-Ritz: GA v = lambda GB v on a tiny k x k pair.

The reference calls LAPACK GGEV (`src/rayleigh/indefinite_rr_impl.inc:82-95`).
XLA has no nonsymmetric generalized eigensolver, so (SURVEY.md §7 hard
part 1) this module provides:

- 'cholesky' (default): the Kressner-Pandur-Shao reduction for a
  Hermitian-definite GA, implemented via SPECTRAL whitening — for any F
  with F F^H = GA^{-1} the pencil reduces to the Hermitian eigenproblem
  M = F^H GB F, eigh(M) = (mu, Q), lambda = 1/mu, v = F Q, and
  v^H GB v = mu so the signature is sign(mu) for free.  F comes from
  eigh of the Jacobi-scaled GA (F = D U s^{-1/2}), NOT from
  chol + trsm: on a backend where `jnp.linalg.cholesky` /
  `solve_triangular` lower to XLA expanders whose internal dots run at
  DEFAULT precision (reduced-precision passes for f32 operands), the
  factorable condition number is capped near 1/eps of that precision —
  on the previous accelerator this silently destroyed every pencil
  solve at width 768 (20k x 150 ss=256 f32: 300 iterations, 299
  rr_fails, where the CPU converged in 10).  eigh keeps full precision
  and every congruence here goes through ops.gram.mm
  (Precision.HIGHEST), so the reduction does not depend on the
  backend's factorization precision.  Fully on-device, no host
  round-trip inside the solver loop.
  When GA is *indefinite*, a definite-combination ladder (KPS Thm 2.3:
  any definite pencil admits an HPD combination c GA + s GB) retries the
  reduction on C = c GA + s GB over a fixed (c, s) candidate grid and
  maps the eigenvalues back, still fully on-device; only a genuinely
  non-definite pencil fails (NaN poison + ok=False, surfaced as
  `rr_failed` by the driver).
- 'qz': scipy.linalg.eig (QZ) via `jax.pure_callback` — handles
  non-definite pencils; serializes at each iteration but the matrix is
  only (3*size_sub)^2.
- 'auto': cholesky + ladder, with a QZ fallback selected by `lax.cond`
  when no definite combination exists.

Eigenvalue guard: |beta| (resp. |mu|) below `tiny` maps to +-1e30
sentinels, matching `indefinite_rr_impl.inc:99-108`.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from lobpcg_tpu.ops.gram import mm, scale_diag

BIG = 1e30


def _sentinel_lambda(num, den, tiny, rdt):
    """lambda = num/den, guarded: |den| <= tiny -> +-BIG by sign(Re num)."""
    ok = jnp.abs(den) > tiny
    lam = jnp.where(ok, (num / jnp.where(ok, den, 1.0)).real, 0.0)
    sent = jnp.where(num.real >= 0, BIG, -BIG)
    return jnp.where(ok, lam, sent).astype(rdt)


def _kps_reduce(F_safe: jax.Array, GBh: jax.Array, tiny: float):
    """Shared KPS body: given a whitening factor F with F F^H = C^{-1}
    for an HPD C, solve the pencil C v = lam_C GB v.  Returns
    (lam_C [k] real, V [k,k]).

    Derivation: M q = mu q with M = F^H GB F and v = F q gives
    (F F^H) GB v = mu v, i.e. GB v = mu C v, i.e. C v = (1/mu) GB v;
    and v^H GB v = q^H M q = mu (the signature for free).  All
    contractions at Precision.HIGHEST (ops.gram.mm).
    """
    rdt = jnp.zeros((), GBh.dtype).real.dtype
    M = mm(F_safe.conj().T, mm(GBh, F_safe))
    M = 0.5 * (M + M.conj().T)
    mu, Q = jnp.linalg.eigh(M)
    V = mm(F_safe, Q.astype(GBh.dtype))
    lam_C = _sentinel_lambda(
        jnp.ones_like(mu).astype(GBh.dtype), mu.astype(GBh.dtype), tiny, rdt
    )
    return lam_C, V


# Definite-combination candidates (c, t): C = c*GA + t*rho*GB with
# rho = ||GA||_F / ||GB||_F.  (1, 0) first so the plain HPD-GA case costs
# exactly the old path; the rest sweep both GA signs and growing |s| to
# find the HPD combination a definite pencil is guaranteed to have.
#
# Grid coverage limits (documented, not silent): KPS Thm 2.3 guarantees
# *some* HPD combination exists for a definite pencil, not that it lies
# on this grid — a pencil whose HPD wedge is narrower than the angle
# spacing or needs |s| > 4*rho is declared failed (ok=False) and the
# driver recovers via `rr_failed` (discard iteration, rebuild W) rather
# than returning garbage.  Inaccurate-but-factorable boundary cases are
# additionally caught downstream by the B-orthogonality quality check
# (`indefinite_rr_modified_impl.inc:183-196` parity), which routes them
# through the dual-basis projection.
_LADDER_C = (1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0,
             1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0)
_LADDER_T = (0.0, 0.0, 0.5, -0.5, 0.5, -0.5, 1.0, -1.0, 1.0, -1.0,
             2.0, -2.0, 2.0, -2.0, 4.0, -4.0, 4.0, -4.0)


def _whiten_scored(M: jax.Array, live=None):
    """Jacobi-scaled spectral whitening with an exact conditioning score.

    Returns (F, ok, score): F satisfies F F^H = M^{-1} when M is HPD
    (F = D U s^{-1/2} from eigh(D M D) = U s U^H; scale_diag's D is
    1/sqrt|diag|), ok = the scaled matrix is positive definite, and
    score = s_min / s_max — the exact rcond of the SCALED matrix (the
    Cholesky version used a pivot-decay proxy for the same quantity).
    Scaling first keeps the score invariant to diagonal scaling, so a
    legitimately wide eigenvalue spread in GA (diag ~ lam spans 1e6 for
    1/h^2-scaled operators) does not read as ill-conditioning;
    non-definite candidates score -1.

    ``live`` (bool mask, or None = all live): DEAD coordinates — exact
    isolated rows/cols by the inject_diag invariant — are shifted above
    the live spectrum before the eigh so (a) they cannot mix into live
    eigenvectors through an accidental degeneracy with a live scaled
    eigenvalue near +-1 (the sentinel detection downstream reads
    per-eigenvector dead-coordinate mass, which mixing would smear) and
    (b) a ladder combination c GA + s GB whose dead diagonal lands
    negative does not spuriously disqualify an otherwise-definite live
    block.  ok/score are over LIVE eigenvalues only.
    """
    D, Ms = scale_diag(M)
    k = M.shape[0]
    n_dead = None
    if live is not None:
        shift = jnp.max(jnp.sum(jnp.abs(Ms), axis=1)).real + 2.0
        dead_diag = jnp.where(live, 0.0, 1.0).astype(Ms.dtype)
        # Replace the (possibly negative) dead diagonal outright.
        Ms = Ms * (1.0 - jnp.diag(dead_diag)) + shift.astype(
            Ms.dtype
        ) * jnp.diag(dead_diag)
        n_dead = jnp.sum(~live).astype(jnp.int32)
    s, U = jnp.linalg.eigh(Ms)  # ascending; shifted dead at the top
    rdt = s.dtype
    s_hi = (
        s[-1] if n_dead is None
        else s[jnp.clip(k - 1 - n_dead, 0, k - 1)]
    )
    ok = jnp.isfinite(s[0]) & (s[0] > 0) & (s_hi > 0)
    s_safe = jnp.where(s > 0, s, 1.0)
    score = jnp.where(ok, s[0] / s_hi, jnp.asarray(-1.0, rdt))
    F = (D[:, None].astype(U.dtype) * U) * jax.lax.rsqrt(s_safe)[
        None, :
    ].astype(U.dtype)
    return F, ok, score


def pencil_eig_cholesky(GA: jax.Array, GB: jax.Array, tiny: float,
                        live=None):
    """KPS reduction with a definite-combination ladder.
    Returns (lam [k] real, V [k,k], ok scalar bool).

    Plain path (HPD GA — true for the BdG family: GA = S^H A S with A SPD
    and S full column rank) costs one Jacobi-scaled eigh.  When GA is
    indefinite, or its factor is near the definiteness boundary (scaled
    pivot-decay score below sqrt(eps)), the ladder factors every
    combination C = c GA + s GB and picks the BEST-CONDITIONED definite
    candidate — not the first that factors — so barely-HPD grid hits do
    not silently drive an inaccurate reduction (the pencil (C, GB) has
    the same eigenvectors and lam = (lam_C - s) / c).  ok=False only when
    no ladder combination is definite (see the grid-coverage note above)
    — outputs are then NaN-poisoned so the failure is visible, and the
    driver flags `rr_failed`.  Reference counterpart: LAPACK GGEV,
    `include/lobpcg/blas_wrapper.h:489-519`.
    """
    k = GA.shape[0]
    dt = GA.dtype
    rdt = jnp.zeros((), dt).real.dtype
    GAh = 0.5 * (GA + GA.conj().T)
    GBh = 0.5 * (GB + GB.conj().T)

    F0, ok0, sc0 = _whiten_scored(GAh, live)
    # Healthy fast path: HPD and comfortably conditioned.  sqrt(eps) ~
    # 3.5e-4 (f32) / 1.5e-8 (f64) on the scale-invariant score keeps the
    # one-factorization path for every well-posed iteration;
    # near-boundary GA escalates to the scored ladder (which still
    # contains (1, 0), so a merely-suspicious GA that really is the best
    # candidate wins there).
    floor = float(np.sqrt(np.finfo(np.dtype(rdt)).eps))
    good0 = ok0 & (sc0 >= floor)

    def plain(_):
        return F0, jnp.asarray(1.0, rdt), jnp.asarray(0.0, rdt), ok0

    def ladder(_):
        nGA = jnp.sqrt(jnp.sum(jnp.abs(GAh) ** 2)).real
        nGB = jnp.sqrt(jnp.sum(jnp.abs(GBh) ** 2)).real
        rho = jnp.where(nGB > 0, nGA / jnp.where(nGB > 0, nGB, 1.0), 1.0)
        cs = jnp.asarray(_LADDER_C, rdt)
        ss = jnp.asarray(_LADDER_T, rdt) * rho
        Cs = (
            cs[:, None, None].astype(dt) * GAh[None]
            + ss[:, None, None].astype(dt) * GBh[None]
        )
        Fs, oks, scs = jax.vmap(lambda C: _whiten_scored(C, live))(Cs)
        idx = jnp.argmax(scs)  # best-conditioned definite candidate
        return Fs[idx], cs[idx], ss[idx], jnp.any(oks)

    F, c, s, ok = jax.lax.cond(good0, plain, ladder, None)
    F_safe = jnp.where(ok, F, jnp.eye(k, dtype=dt))
    lam_C, V = _kps_reduce(F_safe, GBh, tiny)
    # Map back: lam = (lam_C - s) / c; +-BIG sentinels keep sentinel
    # magnitude with the sign they get under division by c = +-1.
    lam = jnp.where(
        jnp.abs(lam_C) >= 0.5 * BIG,
        jnp.sign(lam_C) * c * BIG,
        (lam_C - s) * c,  # c in {+1,-1} so 1/c == c
    ).astype(rdt)
    nan = jnp.asarray(jnp.nan, rdt)
    lam = jnp.where(ok, lam, nan)
    V = jnp.where(ok, V, jnp.asarray(jnp.nan, V.dtype))
    return lam, V, ok


def _qz_host(GA: np.ndarray, GB: np.ndarray):
    """Host QZ via scipy; returns (alpha, beta, VR) with VR cast back to
    the input dtype (for real dtypes the reference's dggev also produces
    real VR columns up to conjugate-pair packing, which the C code reads
    as real — same caveat here)."""
    import scipy.linalg as sla

    w, vr = sla.eig(GA, GB, homogeneous_eigvals=True)
    alpha, beta = np.asarray(w)[0], np.asarray(w)[1]
    dt = GA.dtype
    cdt = np.result_type(dt, np.complex64)
    return (
        alpha.astype(cdt),
        beta.astype(cdt),
        vr.real.astype(dt) if np.isrealobj(np.zeros((), dt)) else vr.astype(dt),
    )


def pencil_eig_qz(GA: jax.Array, GB: jax.Array, tiny: float):
    """GGEV parity path: QZ on host through pure_callback."""
    k = GA.shape[0]
    dt = GA.dtype
    rdt = jnp.zeros((), dt).real.dtype
    cdt = jnp.result_type(dt, jnp.complex64)
    shapes = (
        jax.ShapeDtypeStruct((k,), cdt),
        jax.ShapeDtypeStruct((k,), cdt),
        jax.ShapeDtypeStruct((k, k), dt),
    )
    alpha, beta, VR = jax.pure_callback(_qz_host, shapes, GA, GB, vmap_method="sequential")
    lam = _sentinel_lambda(alpha, beta, tiny, rdt)
    return lam, VR, jnp.bool_(True)


def pencil_eig(
    GA: jax.Array, GB: jax.Array, *, method: str, tiny: float, live=None
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Dispatch: returns (lam [k] real, V [k,k] raw eigenvectors,
    ok scalar bool — False means the solve failed and outputs are NaN)."""
    if method == "cholesky":
        return pencil_eig_cholesky(GA, GB, tiny, live)
    if method == "qz":
        return pencil_eig_qz(GA, GB, tiny)
    if method == "auto":
        lam_c, V_c, ok = pencil_eig_cholesky(GA, GB, tiny, live)

        def fallback(_):
            lam_q, V_q, _ = pencil_eig_qz(GA, GB, tiny)
            return lam_q, V_q, jnp.bool_(True)

        return jax.lax.cond(
            ok, lambda _: (lam_c, V_c, jnp.bool_(True)), fallback, None
        )
    raise ValueError(f"unknown pencil method {method!r}")
