"""Gram-matrix assembly: the contraction-over-n hot spot.

Reference: `src/gram/gram_impl.inc:49-105` (operator form) and
`src/gram/gram_mat_impl.inc:33-89` (explicit dense metric form, used on
coefficient space inside the indefinite RR).

Design: one `jnp.matmul` per Gram — a [k, n] x [n, k] contraction that
XLA hands to the device's matrix-product library.  Under row-sharding
of the n axis the contraction lowers to a local partial product plus an
all-reduce (psum) over the mesh, which is exactly the distributed-Gram
plan of SURVEY.md SS2.6.  No upper/lower-triangle asymmetry: we always
form the full k x k matrix (k <= 3*size_sub, tiny) and let `eigh`'s
symmetrization handle round-off.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from lobpcg_tpu.operators.linop import LinearOperator


# Precision of the numerically-sensitive contractions below.  The
# default (HIGHEST: full f32 products, no TF32 tensor-core rounding on a
# GPU) is trace-time switchable to HIGH (which XLA's GPU backend may
# compute with reduced-precision tensor-core passes) via `precision_ctx`
# — the solvers wrap their trace in it according to
# SolverConfig.gram_precision.  A plain
# module global is safe here: it is only read while TRACING (the value
# is baked into the compiled program), and tracing is driven
# single-threaded by the public solver entry points.
_PRECISION = [jax.lax.Precision.HIGHEST]

_PRECISION_NAMES = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
}


class precision_ctx:
    """Context manager: set the Gram-contraction precision for any
    tracing performed inside (restores the previous value on exit)."""

    def __init__(self, name_or_precision):
        self._new = _PRECISION_NAMES.get(
            name_or_precision, name_or_precision
        )

    def __enter__(self):
        self._old = _PRECISION[0]
        _PRECISION[0] = self._new

    def __exit__(self, *exc):
        _PRECISION[0] = self._old
        return False


def mm(A: jax.Array, B: jax.Array) -> jax.Array:
    """Numerically-sensitive matmul at the Gram precision.

    At DEFAULT precision an f32 product may run in TF32 on a GPU (about
    three decimal digits); for Gram assembly and basis transforms that
    destroys orthogonality at operator scales like 1/h^2 ~ 1e6.
    Precision HIGHEST (default; see `precision_ctx`) requests the full
    f32 product.  Operators choose their own precision for the apply.
    """
    return jnp.matmul(
        A, B, precision=_PRECISION[0],
        preferred_element_type=B.dtype,
    )


def apply_block_op(op: Optional[LinearOperator], X: jax.Array) -> jax.Array:
    """Y = Op @ X for a whole block; identity when op is None.

    Block-native replacement for the reference's per-column loop
    (`src/gram/gram_impl.inc:29-33`).
    """
    if op is None:
        return X
    return op.matmat(X)


def applied_blocks(op, blocks, pre=None):
    """[op @ b for b in blocks], reusing ``pre[j]`` where given.  Feeds
    herm_tile_gram.  Applications happen one block at a time, so only a
    single [n, m] transient is live (the memory posture of _a_gram /
    gram_blocks)."""
    pre = pre or {}
    return [
        pre[j] if pre.get(j) is not None else apply_block_op(op, b)
        for j, b in enumerate(blocks)
    ]


# Row-chunking for WIDENED-precision contractions (trace-time, like
# _PRECISION).  Why: a backend without native f64 products emulates an
# f64-accumulated f32 dot by splitting BOTH tall operands into stacked
# multi-pass components, several times the operand bytes.  The only
# evidence is from the previous accelerator this code ran on (a 57 GiB
# compile peak at the 1M x 256 escalated solve); the H100 has f64 in
# hardware, so whether the knob still earns its place is open.
# Chunking the contraction over rows via lax.scan bounds the split
# stacks to [*, k, chunk] — the k x k f64 accumulator is exact f64
# accumulation, bit-comparable to the unchunked dot up to addition
# order.  0 = off.  Do NOT enable on row-sharded solves: the [n, k] ->
# [n/c, c, k] reshape conflicts with a sharded leading axis.
_MIXED_CHUNK = [0]


class mixed_chunk_ctx:
    """Context manager: set the widened-Gram row-chunk size for any
    tracing performed inside (restores the previous value on exit)."""

    def __init__(self, rows):
        self._new = int(rows or 0)

    def __enter__(self):
        self._old = _MIXED_CHUNK[0]
        _MIXED_CHUNK[0] = self._new

    def __exit__(self, *exc):
        _MIXED_CHUNK[0] = self._old
        return False


def with_gram_ctx(fn):
    """Decorator for solver impl functions (signature
    ``fn(A, B, T, X0, key, config, *rest)``): applies the trace-time
    Gram contexts — contraction precision and widened-Gram row
    chunking — from ``config`` around the traced body, so DIRECT jit
    users of the impl (mem_analysis, graft entries) get the same
    compiled program as the public entry points."""
    import functools

    @functools.wraps(fn)
    def wrapped(A, B, T, X0, key, config, *rest, **kw):
        with precision_ctx(config.gram_precision), \
                mixed_chunk_ctx(config.rr_chunk_rows):
            return fn(A, B, T, X0, key, config, *rest, **kw)

    return wrapped


def _hdot(V: jax.Array, U: jax.Array, out_dtype=None) -> jax.Array:
    """V^H @ U with full-precision accumulation.

    `out_dtype` (mixed precision): accumulate the contraction in a higher
    precision via preferred_element_type — the tall inputs stay in their
    storage dtype in HBM; only the k x k result is high-precision.
    Widened contractions row-chunk under `mixed_chunk_ctx` (see
    _MIXED_CHUNK for the f64-emulation memory rationale).
    """
    dt = jnp.dtype(out_dtype) if out_dtype is not None else U.dtype
    c = _MIXED_CHUNK[0]
    n = V.shape[0]
    if c and dt != jnp.dtype(V.dtype) and n >= 2 * c:
        num = n // c
        Vr = V[: num * c].reshape(num, c, V.shape[1])
        Ur = U[: num * c].reshape(num, c, U.shape[1])

        def step(acc, vu):
            v, u = vu
            p = jnp.matmul(v.conj().T, u, precision=_PRECISION[0],
                           preferred_element_type=dt)
            return acc + p, None

        acc = jnp.zeros((V.shape[1], U.shape[1]), dt)
        acc, _ = jax.lax.scan(step, acc, (Vr, Ur))
        if num * c < n:
            acc = acc + jnp.matmul(
                V[num * c:].conj().T, U[num * c:],
                precision=_PRECISION[0], preferred_element_type=dt,
            )
        return acc
    return jnp.matmul(
        V.conj().T, U, precision=_PRECISION[0],
        preferred_element_type=dt,
    )


def gram_self(
    U: jax.Array, B: Optional[LinearOperator] = None, out_dtype=None,
    chunk: Optional[int] = None,
) -> jax.Array:
    """G = U^H B U  (B None -> U^H U).  Reference: `gram_impl.inc:49-67`.

    `chunk`: assemble G column-block by column-block so only a [n, chunk]
    B-application transient is live at a time instead of the full [n, k]
    BU (the low-memory mode; trades extra reads of U for ~2nk fewer
    resident scalars).
    """
    k = U.shape[1]
    if chunk is None or B is None or chunk >= k:
        BU = apply_block_op(B, U)
        return _hdot(U, BU, out_dtype)
    cols = []
    for j in range(0, k, chunk):
        BUj = B.matmat(U[:, j : j + chunk])
        cols.append(_hdot(U, BUj, out_dtype))
    return jnp.concatenate(cols, axis=1)


def gram_cross(
    V: jax.Array, U: jax.Array, B: Optional[LinearOperator] = None,
    out_dtype=None,
) -> jax.Array:
    """G = V^H B U.  Reference: `gram_impl.inc:85-105`."""
    BU = apply_block_op(B, U)
    return _hdot(V, BU, out_dtype)


def gram_self_mat(U: jax.Array, mat: jax.Array, out_dtype=None) -> jax.Array:
    """G = U^H mat U with an explicit dense metric.
    Reference: `src/gram/gram_mat_impl.inc:33-58`."""
    return _hdot(U, mm(mat, U), out_dtype)


def gram_cross_mat(
    V: jax.Array, U: jax.Array, mat: jax.Array, out_dtype=None
) -> jax.Array:
    """G = V^H mat U with an explicit dense metric.
    Reference: `src/gram/gram_mat_impl.inc:64-89`."""
    return _hdot(V, mm(mat, U), out_dtype)


def as_blocks(S, nx: int):
    """Normalize a subspace argument to a tuple of column blocks.

    Kernels accept either a materialized [n, 3m] array (convenient for
    direct calls/tests) or a tuple of [n, m] blocks (X, P, W) — the
    driver always passes blocks so the concatenated S never exists in
    HBM (at capacity-bound sizes the S copies were the largest
    allocations in the solve).
    """
    if isinstance(S, (tuple, list)):
        return tuple(S)
    k = S.shape[1]
    return tuple(S[:, j : j + nx] for j in range(0, k, nx))


def blocks_width(S) -> int:
    if isinstance(S, (tuple, list)):
        return sum(b.shape[1] for b in S)
    return S.shape[1]


def blocks_dtype(S):
    if isinstance(S, (tuple, list)):
        return S[0].dtype
    return S.dtype


def bh_dot(blocks, Y: jax.Array, out_dtype=None) -> jax.Array:
    """[sum_i k_i, c] stack of blocks_i^H Y (full-precision accumulate)."""
    return jnp.concatenate([_hdot(b, Y, out_dtype) for b in blocks], axis=0)


def b_mm(blocks, C: jax.Array) -> jax.Array:
    """Sum_i blocks_i @ C[rows_i] — project-back without materializing S."""
    out = None
    j = 0
    for b in blocks:
        w = b.shape[1]
        t = mm(b, C[j : j + w])
        out = t if out is None else out + t
        j += w
    return out


def herm_tile_gram(blocks, applied, out_dtype=None) -> jax.Array:
    """G = S^H (Op S) assembled from UPPER-TRIANGLE tall contractions
    only, mirroring the lower tiles as G_ji = G_ij^H — valid because Op
    is Hermitian (the problem contract for both A and B).  For 3 blocks
    this is 6 [m, n] x [n, m] contractions instead of 9, a third of the
    tall Gram work.  The reference's gram kernels
    also exploit symmetry — via BLAS upper-triangle updates
    (`src/gram/gram_impl.inc:49-67`); this is the block-tile analog.

    ``applied[j]`` must be Op @ blocks[j].  Dead (zero) columns stay
    exactly zero under mirroring, preserving the masking invariant.
    """
    nb = len(blocks)
    tiles = [[None] * nb for _ in range(nb)]
    for j in range(nb):
        for i in range(j + 1):
            tiles[i][j] = _hdot(blocks[i], applied[j], out_dtype)
            if i != j:
                tiles[j][i] = tiles[i][j].conj().T
    return jnp.concatenate(
        [jnp.concatenate(row, axis=1) for row in tiles], axis=0
    )


def gram_blocks(blocks, B: Optional[LinearOperator] = None,
                out_dtype=None) -> jax.Array:
    """G = S^H B S over column blocks (B Hermitian): only one [n, m]
    B-application transient is live at a time, S is never concatenated,
    and only upper-triangle tall contractions run (herm_tile_gram)."""
    nb = len(blocks)
    tiles = [[None] * nb for _ in range(nb)]
    for j, b in enumerate(blocks):
        Bb = apply_block_op(B, b)
        for i in range(j + 1):
            tiles[i][j] = _hdot(blocks[i], Bb, out_dtype)
            if i != j:
                tiles[j][i] = tiles[i][j].conj().T
    return jnp.concatenate(
        [jnp.concatenate(row, axis=1) for row in tiles], axis=0
    )


def gram_blocks_pre(blocks, Bblocks, out_dtype=None) -> jax.Array:
    """G = S^H (B S) from PRE-APPLIED operator blocks: zero operator
    applications.  The ilobpcg driver computes B@X / B@P once per
    iteration and receives B@W from the ortho pass's last inner-loop
    application, so the per-iteration B-Gram costs only the k x k
    contractions (the reference re-applies B here,
    `src/gram/gram_impl.inc:49-67`)."""
    return herm_tile_gram(blocks, Bblocks, out_dtype)


def scale_diag(G: jax.Array):
    """Guarded Jacobi scaling: D_ii = 1/sqrt(|G_ii|), Gs = D G D.
    Shared by SVQB and the Rayleigh-Ritz Cholesky path (the reference's
    D-scaling steps, `svqb_impl.inc:66-70`, `rayleigh_ritz_impl.inc:50`)."""
    rdt = jnp.zeros((), G.dtype).real.dtype
    gd = jnp.abs(jnp.diagonal(G)).astype(rdt)
    D = jnp.where(gd > 0, 1.0 / jnp.sqrt(jnp.where(gd > 0, gd, 1.0)), 1.0)
    Gs = (D[:, None] * G) * D[None, :].astype(G.dtype)
    return D, Gs


def frob_norm(X: jax.Array) -> jax.Array:
    """Frobenius norm returning the real dtype."""
    return jnp.sqrt(jnp.sum(jnp.abs(X) ** 2).real)


def ortho_err(G: jax.Array, count=None) -> jax.Array:
    """||G - I_sig||_F using |G_jj| - 1 on the diagonal, so it works for
    +-1 signature diagonals.  Reference: `src/ortho/ortho_err_upper_impl.inc:2-13`
    (upper-triangle-only there; full-matrix here — same quantity up to the
    symmetric off-diagonal factor, and we only compare it to tolerances).

    When `count` is given, dead rows/cols (index >= count) are excluded.
    """
    k = G.shape[0]
    diag_err = jnp.abs(jnp.diagonal(G)) - 1.0
    off = G - jnp.diag(jnp.diagonal(G))
    if count is not None:
        idx = jax.lax.broadcasted_iota(jnp.int32, (k, 1), 0)[:, 0]
        live = idx < count
        keep = live[:, None] & live[None, :]
        off = off * keep.astype(off.dtype)
        diag_err = jnp.where(live, diag_err, 0.0)
    # Match the reference's upper-triangle accounting: off-diagonals of a
    # Hermitian error matrix are counted once.
    upper = jnp.triu(jnp.ones((k, k), dtype=bool), k=1)
    off2 = jnp.sum((jnp.abs(off) ** 2) * upper)
    return jnp.sqrt(off2.real + jnp.sum(diag_err**2))
