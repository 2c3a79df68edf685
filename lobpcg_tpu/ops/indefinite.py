"""Indefinite Rayleigh-Ritz (Kressner-Pandur-Shao family).

Reference: `src/rayleigh/indefinite_rr_impl.inc:51-149` (initial),
`src/rayleigh/indefinite_rr_modified_impl.inc:58-255` (per-iteration with
double B-normalization, quality check, signature sort, Cx/Cp/Cx_ortho
extraction), `src/rayleigh/bubble_sort_sig_impl.inc:9-48` (signature
sort order: positives ascending, then negatives descending, then
zero-signature entries last).

On-device design: the GGEV projected solve runs through ops.pencil
(on-device Cholesky+eigh fast path by default); the bubble sort becomes
a stable lexsort; sentinel (masked-coordinate) eigenpairs are detected by
their coordinate mass, assigned signature 0, and therefore sort last —
exactly the slot the reference's sort gives zero-signature entries.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from lobpcg_tpu.ops import masking
from lobpcg_tpu.ops.gram import (
    as_blocks,
    blocks_dtype,
    frob_norm,
    gram_blocks,
    gram_blocks_pre,
    gram_self,
    mm,
)
from lobpcg_tpu.ops.ortho import ortho_indefinite_mat
from lobpcg_tpu.ops.pencil import pencil_eig
from lobpcg_tpu.ops.rayleigh import _a_gram
from lobpcg_tpu.ops.svqb import svqb_mat
from lobpcg_tpu.operators.linop import LinearOperator


class IndefiniteRRResult(NamedTuple):
    Cx: jax.Array  # [k, nx] accurate eigenvector coefficients
    Cp: jax.Array  # [k, nx] = [0; lower block of Cx], orthogonalized
    Cx_ortho: jax.Array  # [k, nx] stabilized basis (== Cx when quality ok)
    lam: jax.Array  # [nx] real
    sig: jax.Array  # [k] i32 signature, sorted order (0 = dead sentinel)
    quality: jax.Array  # i32: 1 good, 5 poor (dual-basis projection)
    rr_ok: jax.Array  # bool: projected pencil solve succeeded


def signature_sort(lam: jax.Array, sig: jax.Array) -> jax.Array:
    """Permutation: sig>0 ascending by lam, then sig<0 descending by lam,
    then sig==0 last (stable).  Matches `bubble_sort_sig_impl.inc:9-48`."""
    group = jnp.where(sig > 0, 0, jnp.where(sig < 0, 1, 2)).astype(jnp.int32)
    val = jnp.where(sig > 0, lam, jnp.where(sig < 0, -lam, 0.0))
    return jnp.lexsort((val, group))


def _b_normalize(V: jax.Array, GB: jax.Array, tiny: float):
    """One normalization pass: scale columns by 1/sqrt(|diag(V^H GB V)|).
    Returns (V_scaled, diag) — diag carries the signature information."""
    GBV = mm(GB, V)
    d = jnp.einsum("ij,ij->j", V.conj(), GBV)
    ad = jnp.abs(d)
    scale = jnp.where(ad > tiny, 1.0 / jnp.sqrt(jnp.where(ad > tiny, ad, 1.0)), 1.0)
    return V * scale[None, :].astype(V.dtype), d


def indefinite_rayleigh_ritz(
    X: jax.Array,
    A: LinearOperator,
    B: LinearOperator,
    *,
    method: str,
    tiny: float,
    rr_dtype=None,
):
    """Initial indefinite RR on a full-width block.

    Returns (Cx [m,m], lam [m] real sorted, sig [m] i32 sorted, ok bool).
    Reference: `indefinite_rr_impl.inc:51-149` (single B-normalization).
    Mixed precision: the projected pencil solve and B-normalization run in
    rr_dtype; Cx is cast back to X's dtype, lam stays high.
    """
    GA = gram_self(X, A, out_dtype=rr_dtype)
    GB = gram_self(X, B, out_dtype=rr_dtype)
    lam, V, ok = pencil_eig(GA, GB, method=method, tiny=tiny)
    V, d = _b_normalize(V, GB, tiny)
    sig = jnp.where(d.real >= 0, 1, -1).astype(jnp.int32)
    perm = signature_sort(lam, sig)
    return (
        masking.permute_cols(V, perm).astype(X.dtype),
        lam[perm],
        sig[perm],
        ok,
    )


def indefinite_rayleigh_ritz_modified(
    S: jax.Array,
    AX: Optional[jax.Array],
    np_act,
    nw_act,
    A: LinearOperator,
    B: LinearOperator,
    *,
    nx: int,
    method: str,
    tiny: float,
    quality_tol: float,
    eps_ortho: float,
    eps_drop: float,
    max_outer: int = 3,
    max_inner: int = 3,
    rr_dtype=None,
    Bblocks=None,
) -> IndefiniteRRResult:
    """Per-iteration indefinite RR over the masked [X|P|W] subspace.

    Double B-normalization, B-orthogonality quality check, signature
    sort, Cx / Cp = [0; Z2] extraction, and the quality=5 dual-basis
    fallback (svqb_mat-stabilized Cx_ortho).
    Reference: `indefinite_rr_modified_impl.inc:58-255`.

    ``Bblocks``: optional pre-applied (B@X, B@P, B@W) matching ``S``'s
    blocks — the B-Gram is then assembled with zero operator
    applications (gram_blocks_pre; the driver reuses its top-of-iteration
    B@X / B@P and the ortho pass's exit B@W).
    """
    blocks = as_blocks(S, nx)
    k = sum(b.shape[1] for b in blocks)
    m = nx
    live = masking.blocks_mask((m, m, k - 2 * m), (m, np_act, nw_act))
    sdt = blocks_dtype(S)

    # No tall [n, 3m] masking copy (see rayleigh_ritz_modified): the
    # inject_diag below zeroes dead Gram rows/cols exactly; blocks keep
    # the concatenated S out of HBM entirely.
    GA = _a_gram(blocks, AX, A, out_dtype=rr_dtype)
    GB = (
        gram_blocks(blocks, B, out_dtype=rr_dtype) if Bblocks is None
        else gram_blocks_pre(blocks, Bblocks, out_dtype=rr_dtype)
    )
    # Dead coordinates: unit pencil eigenpair (lambda = 1, sig would be
    # +1); detected below via coordinate mass and forced to sig = 0 so
    # the sort pushes them past every live eigenpair.
    GA = masking.inject_diag(GA, live, 1.0)
    GB = masking.inject_diag(GB, live, 1.0)

    lam_all, V, rr_ok = pencil_eig(
        GA, GB, method=method, tiny=tiny, live=live
    )

    # Double B-normalization (`indefinite_rr_modified_impl.inc:141-180`).
    V, _ = _b_normalize(V, GB, tiny)
    V, d2 = _b_normalize(V, GB, tiny)
    sig = jnp.where(d2.real >= 0, 1, -1).astype(jnp.int32)

    # Sentinel eigenpairs live on dead coordinates.
    sent = masking.dead_mass(V, live) > 0.5
    sig = jnp.where(sent, 0, sig)

    # Quality check over live eigenvectors
    # (`indefinite_rr_modified_impl.inc:183-196`).
    live_cols = (~sent)[None, :].astype(V.dtype)
    Vl = V * live_cols
    GBVl = mm(GB, Vl)
    G2 = mm(Vl.conj().T, GBVl)
    dd = jnp.abs(jnp.diagonal(G2)) - jnp.where(sent, 0.0, 1.0)
    E = G2 - jnp.diag(jnp.diagonal(G2)) + jnp.diag(dd.astype(G2.dtype))
    eerr = frob_norm(E)
    cerr = frob_norm(Vl)
    bcerr = frob_norm(GBVl)
    quality_ok = (bcerr < tiny) | (eerr <= quality_tol * cerr * bcerr)

    # Sort and extract.
    perm = signature_sort(lam_all, sig)
    V = masking.permute_cols(V, perm)
    lam_all = lam_all[perm]
    sig = sig[perm]

    Cx = V[:, :nx]
    lam = lam_all[:nx]
    # Cp = [0; Z2]: top nx rows zeroed (`indefinite_rr_modified_impl.inc:214-228`).
    row_idx = jax.lax.broadcasted_iota(jnp.int32, (k, 1), 0)
    Cp0 = jnp.where(row_idx >= nx, Cx, jnp.zeros_like(Cx))

    def good(_):
        Cp = ortho_indefinite_mat(
            Cp0, Cx, GB,
            eps_ortho=eps_ortho, eps_drop=eps_drop,
            max_outer=max_outer, max_inner=max_inner,
        )
        return IndefiniteRRResult(
            Cx.astype(sdt), Cp.astype(sdt), Cx.astype(sdt), lam, sig,
            jnp.int32(1), rr_ok,
        )

    def poor(_):
        Cx_o = svqb_mat(Cx, GB, tau=eps_drop)
        Cp = ortho_indefinite_mat(
            Cp0, Cx_o, GB,
            eps_ortho=eps_ortho, eps_drop=eps_drop,
            max_outer=max_outer, max_inner=max_inner,
        )
        return IndefiniteRRResult(
            Cx.astype(sdt), Cp.astype(sdt), Cx_o.astype(sdt), lam, sig,
            jnp.int32(5), rr_ok,
        )

    return jax.lax.cond(quality_ok, good, poor, None)
