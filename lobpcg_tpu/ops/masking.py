"""Active-column masking: the fixed-shape replacement for the reference's
dynamic-shape column dropping and memmove compaction.

The C code shrinks arrays when SVQB drops columns
(`src/ortho/svqb_impl.inc:91-98`) and memmoves converged columns out of
P/W for soft locking (`src/core/lobpcg_impl.inc:139-145`).  Under XLA all
shapes must be static, so every column block here keeps its full width and
carries either an i32 "active count" (columns [0, count) live — the
common case) or an explicit boolean live-mask (needed for the [X|P|W]
subspace, where live columns are X-full + P-prefix + W-prefix).  Masked
columns are exactly zero.  Gram matrices over masked blocks get identity
(or large-sentinel) diagonals injected in the dead coordinates so
Cholesky / eigh stay well-posed inside `lax.while_loop`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _iota(width: int) -> jax.Array:
    return jax.lax.broadcasted_iota(jnp.int32, (width, 1), 0)[:, 0]


def as_mask(width: int, live) -> jax.Array:
    """Normalize `live` to a boolean [width] mask.

    `live` may be an i32 scalar (prefix count) or a boolean array.
    """
    live = jnp.asarray(live)
    if live.ndim == 1:
        return live.astype(bool)
    return _iota(width) < live


def blocks_mask(widths: tuple[int, ...], counts) -> jax.Array:
    """Live mask for concatenated blocks, each with its own prefix count.

    E.g. the [X|P|W] subspace: widths=(m, m, m), counts=(m, np, nw).
    """
    parts = [as_mask(w, c) for w, c in zip(widths, counts)]
    return jnp.concatenate(parts)


def mask_cols(U: jax.Array, live) -> jax.Array:
    """Zero the dead columns of U."""
    m = as_mask(U.shape[1], live)
    return U * m[None, :].astype(U.dtype)


def shift_cols(U: jax.Array, shift, new_count) -> jax.Array:
    """Drop the first `shift` columns and compact the rest to the front.

    Equivalent to the reference's soft-locking compaction
    (`src/core/lobpcg_impl.inc:139-145`): output column j = U[:, j+shift]
    for j < new_count, zero otherwise.
    """
    w = U.shape[1]
    src = jnp.clip(_iota(w) + shift, 0, w - 1)
    out = jnp.take(U, src, axis=1)
    return mask_cols(out, new_count)


def permute_cols(U: jax.Array, perm: jax.Array) -> jax.Array:
    """Reorder columns by an index vector (used for drop compaction and
    the indefinite signature sort)."""
    return jnp.take(U, perm, axis=1)


def inject_diag(G: jax.Array, live, diag_val) -> jax.Array:
    """Replace dead rows/cols of a Gram matrix with diag_val * e_j e_j^T.

    For dead j: row j and column j are zeroed, G[j, j] = diag_val.
    Keeps the matrix exactly block-diagonal between live and dead
    coordinates so the dead coordinates' eigenpairs decouple.
    """
    k = G.shape[0]
    lm = as_mask(k, live)
    keep = (lm[:, None] & lm[None, :]).astype(G.dtype)
    dead_diag = jnp.where(lm, 0.0, 1.0).astype(G.dtype)
    return G * keep + jnp.asarray(diag_val, G.dtype) * jnp.diag(dead_diag)


def dead_mass(V: jax.Array, live) -> jax.Array:
    """Per-eigenvector mass on dead coordinates: [k] real vector.

    Because injected Grams are exactly block-diagonal, eigenvectors of the
    dead block have mass ~1 here and live ones ~0; used to identify
    sentinel eigenpairs after eigh.
    """
    k = V.shape[0]
    dead = ~as_mask(k, live)
    w = jnp.abs(V) ** 2
    return jnp.sum(w * dead[:, None], axis=0)


def compact_by_flag(drop_flag: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Stable permutation putting kept (flag False) columns first.

    Returns (perm, n_kept).  Matches the C SVQB drop semantics
    (`src/ortho/svqb_impl.inc:91-98`): kept columns preserve their
    relative (ascending-eigenvalue) order.
    """
    key = drop_flag.astype(jnp.int32)
    perm = jnp.argsort(key, stable=True)
    n_kept = jnp.sum(1 - key).astype(jnp.int32)
    return perm, n_kept


def prefix_count(ok: jax.Array) -> jax.Array:
    """Length of the True-prefix of a boolean vector — the convergence
    counting rule of the reference (`src/core/lobpcg_impl.inc:222-228`)."""
    all_prefix = jnp.cumprod(ok.astype(jnp.int32))
    return jnp.sum(all_prefix).astype(jnp.int32)
