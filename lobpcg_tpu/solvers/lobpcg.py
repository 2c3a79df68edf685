"""Standard / generalized LOBPCG driver.

Reference: `src/core/lobpcg_impl.inc:60-248`.  The C driver's mutable
state struct becomes a carried pytree in one jitted `lax.while_loop`; the
memmove soft-locking compaction becomes column shifting with an i32
converged count (ops.masking.shift_cols); the useOrtho=2 Cholesky-failure
retry becomes a `lax.cond`.

The whole solve — operator applications, Gram assembly, small dense
eigensolves, projections — stays inside one XLA program: the "user
callback boundary" of the reference is graph composition here, so XLA can
fuse and overlap across iteration phases.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from lobpcg_tpu.config import SolverConfig, validate_problem
from lobpcg_tpu.operators.linop import LinearOperator
from lobpcg_tpu.ops import masking
from lobpcg_tpu.ops.gram import (
    with_gram_ctx,
    apply_block_op,
    b_mm,
    mm,
)
from lobpcg_tpu.ops.ortho import ortho_drop
from lobpcg_tpu.ops.rayleigh import (
    RRResult,
    rayleigh_ritz,
    rayleigh_ritz_modified,
)
from lobpcg_tpu.ops.svqb import robust_basis_init
from lobpcg_tpu.ops.residual import (
    estimate_norm,
    get_residual,
    get_residual_norm,
)
from lobpcg_tpu.solvers import observe
from lobpcg_tpu.solvers.state import LOBPCGResult
from lobpcg_tpu.utils.prng import fill_random


class _Carry(NamedTuple):
    # X/P/W travel as separate blocks — the concatenated [n, 3m] S never
    # exists in HBM (at capacity-bound sizes XLA's copies of S were the
    # largest allocations in the solve).
    X: jax.Array  # [n, m]
    P: jax.Array  # [n, m], active-prefix compacted (dead cols zero)
    W: jax.Array  # [n, m], active-prefix compacted (dead cols zero)
    AX: jax.Array  # [n, m] cached A @ X
    lam: jax.Array  # [m] real
    res: jax.Array  # [nev] real
    conv: jax.Array  # i32
    use_ortho: jax.Array  # i32 (0 chol path, 1 ortho path; sticky)
    it: jax.Array  # i32
    p_cnt: jax.Array  # i32 — valid P columns (reference's nretain)
    retries: jax.Array  # i32 — ortho-retry (RR flag 2) occurrences
    hist: object  # SolveHistory or None (static per config)


@with_gram_ctx
def _lobpcg_impl(A, B, T, X0, key, config: SolverConfig, P0=None,
                 p0_cnt=0, it_cap=None):
    n = A.shape[0]
    m = config.size_sub
    nev = config.nev
    dtype = A.dtype
    eps_ortho, eps_drop = config.resolved_eps(dtype)
    rrdt = config.resolved_rr_dtype(dtype)

    k_a, k_b, k_x, k_r = jax.random.split(key, 4)
    a_norm = estimate_norm(A, k_a, config.norm_iters, config.norm_block)
    b_norm = (
        estimate_norm(B, k_b, config.norm_iters, config.norm_block)
        if B is not None
        else jnp.ones((), a_norm.dtype)
    )

    def res_norm(W, lam):
        # residual_norm="b": B-seminorm numerator (one extra [n, nev]
        # B application); "2" keeps the reference's 2-norm parity.
        BW = (
            apply_block_op(B, W[:, :nev])
            if config.residual_norm == "b" and B is not None else None
        )
        return get_residual_norm(W, lam, a_norm, b_norm, nev, BW)

    observe.log_start(config, "lobpcg", a_norm, b_norm)

    X = fill_random(k_x, (n, m), dtype) if X0 is None else X0.astype(dtype)

    # Rank-repair + B-orthonormalization of the start basis (dependent /
    # zero X0 columns are dropped, refilled randomly, re-orthonormalized;
    # robustness the reference lacks, its CODE_REVIEW.md C8).
    X = robust_basis_init(X, B, k_r, tau=eps_drop, rr_dtype=rrdt)

    # Initial Rayleigh-Ritz + projection (`lobpcg_impl.inc:99-104`).
    Cx0, lam = rayleigh_ritz(X, A, B, rr_dtype=rrdt)
    X = mm(X, Cx0)
    AX = A.matmat(X)
    W = get_residual(X, AX, lam, A, B)
    res = res_norm(W, lam)

    # With the cache off, the carry holds a dummy instead of the n x m
    # AX block (2 n*m resident scalars at while-loop double-buffering) —
    # the A-Gram and residual recompute A@X per iteration instead.
    if not config.use_ax_cache:
        AX = jnp.zeros((1, 1), dtype)

    P_init = (
        jnp.zeros((n, m), dtype) if P0 is None else P0.astype(dtype)
    )
    hist0 = observe.history_init(config, m, lam.dtype, res.dtype)
    carry0 = _Carry(
        X,
        P_init,
        W,
        AX,
        lam,
        res,
        jnp.int32(0),
        jnp.int32(0),
        jnp.int32(0),
        jnp.int32(p0_cnt) if P0 is not None else jnp.int32(0),
        jnp.int32(0),
        hist0,
    )

    # Reuse B applications across the ortho pass and the RR B-Gram (see
    # solvers.ilobpcg / SolverConfig.use_b_cache); pointless when B is
    # None (applications are the identity).
    cache_b = config.use_b_cache and B is not None

    def do_ortho(W, nw, X, P, np_act, Bvb=None):
        # Orthogonalize W against [X, P_active] (`lobpcg_impl.inc:158-166`).
        return ortho_drop(
            W,
            nw,
            (X, P),
            m + np_act,
            B,
            eps_ortho=eps_ortho,
            eps_drop=eps_drop,
            max_outer=config.max_outer,
            max_inner=config.max_inner,
            rr_dtype=rrdt,
            Bvb=Bvb,
            return_bu=cache_b,
            entry_check=config.ortho_skip,
        )

    # Runtime iteration cap (traced, <= config.max_iter): chunked
    # drivers (utils.checkpoint.solve_checkpointed) vary it without
    # recompiling — the static max_iter only sizes history arrays.
    # Clamped: iterations beyond max_iter would scatter history rows out
    # of bounds (JAX clamps the index, silently overwriting the last row).
    limit = (
        config.max_iter if it_cap is None
        else jnp.minimum(jnp.int32(it_cap), config.max_iter)
    )

    def cond(c: _Carry):
        return (c.it < limit) & (c.conv < nev)

    def body(c: _Carry):
        it0 = c.it == 0
        # conv == 0 at it 0, so no special case is needed for warm P.
        np_act = jnp.minimum(c.p_cnt, m - c.conv)
        nw = jnp.where(it0, jnp.int32(m), m - c.conv)
        W = c.W

        # Preconditioner (`lobpcg_impl.inc:152-155`).
        if T is not None:
            W = masking.mask_cols(T.matmat(W), nw)

        # Optional robust orthogonalization of W.  With cache_b, B@X and
        # B@P are applied ONCE here and threaded through the ortho
        # projector and the RR B-Gram; the no-ortho branch applies B@W
        # itself (1 application, replacing the 3 the B-Gram would do).
        if cache_b:
            BX = apply_block_op(B, c.X)
            BP = apply_block_op(B, c.P)
            Bvb = (BX, BP)
            W, nw, BW = jax.lax.cond(
                c.use_ortho >= 1,
                lambda args: do_ortho(*args, Bvb=Bvb),
                lambda args: (args[0], args[1], apply_block_op(B, args[0])),
                (W, nw, c.X, c.P, np_act),
            )
            Bblocks = (BX, BP, BW)
        else:
            Bvb = None
            W, nw = jax.lax.cond(
                c.use_ortho >= 1,
                lambda args: do_ortho(*args),
                lambda args: (args[0], args[1]),
                (W, nw, c.X, c.P, np_act),
            )
            Bblocks = None

        AX = c.AX if config.use_ax_cache else None
        rr = rayleigh_ritz_modified(
            (c.X, c.P, W),
            AX,
            np_act,
            nw,
            c.use_ortho,
            A,
            B,
            nx=m,
            tol_skip=config.tol_skip,
            rr_dtype=rrdt,
            Bblocks=Bblocks,
        )

        # Cholesky/cond failure: orthogonalize W and retry with the ortho
        # branch (`lobpcg_impl.inc:180-196`).
        def retry(args):
            W, nw = args
            if cache_b:
                W2, nw2, BW2 = do_ortho(W, nw, c.X, c.P, np_act, Bvb=Bvb)
                Bb2 = (BX, BP, BW2)
            else:
                W2, nw2 = do_ortho(W, nw, c.X, c.P, np_act)
                Bb2 = None
            rr2 = rayleigh_ritz_modified(
                (c.X, c.P, W2),
                AX,
                np_act,
                nw2,
                jnp.int32(1),
                A,
                B,
                nx=m,
                tol_skip=config.tol_skip,
                rr_dtype=rrdt,
                Bblocks=Bb2,
            )
            return rr2, W2, jnp.int32(1)

        def no_retry(args):
            W, nw = args
            return rr, W, jnp.maximum(c.use_ortho, rr.flag)

        flag0 = rr.flag  # first-attempt RR status (2 = retry fired)
        rr, W, use_ortho = jax.lax.cond(
            rr.flag == 2, retry, no_retry, (W, nw)
        )
        retries = c.retries + (flag0 == 2).astype(jnp.int32)

        # Project back [X, P] = S [Cx | Cp]  (`lobpcg_impl.inc:204-208`),
        # blockwise: no S, no XP concat.
        blocks = (c.X, c.P, W)
        Xn = b_mm(blocks, rr.Cx)
        Pn = b_mm(blocks, rr.Cp)

        AXn = A.matmat(Xn)
        Wres = get_residual(Xn, AXn, rr.lam, A, B)
        if not config.use_ax_cache:
            AXn = jnp.zeros((1, 1), dtype)
        res = res_norm(Wres, rr.lam)
        convn = masking.prefix_count(res <= config.tol)

        # Soft-locking compaction for the next iteration
        # (`lobpcg_impl.inc:139-145`, done here statelessly).  The P
        # count drops by the newly converged prefix, and never exceeds
        # the number of valid Cp columns this RR produced.
        act = m - convn
        p_next = jnp.clip(rr.p_count - convn, 0, act)
        Pc = masking.shift_cols(Pn, convn, p_next)
        Wc = masking.shift_cols(Wres, convn, act)

        observe.log_iteration(config, "lobpcg", c.it, rr.lam, res, convn)
        hist = observe.history_update(
            c.hist, c.it, rr.lam, res, convn, flag0
        )
        return _Carry(
            Xn, Pc, Wc, AXn, rr.lam, res, convn, use_ortho, c.it + 1,
            p_next, retries, hist
        )

    cf = jax.lax.while_loop(cond, body, carry0)

    return LOBPCGResult(
        eigenvalues=cf.lam[:nev],
        # eigenvectors would duplicate a slice of `basis` in the jitted
        # output (an extra n*nev HBM buffer live at solve peak); the
        # public wrapper slices it lazily after temps are freed.
        eigenvectors=None,
        residual_norms=cf.res,
        converged=cf.conv,
        iterations=cf.it,
        basis=cf.X,
        momentum=cf.P,
        history=cf.hist,
        ortho_retries=cf.retries,
    )


_lobpcg_jit = functools.partial(jax.jit, static_argnums=(5,))(_lobpcg_impl)
# Donating X0/P0 frees their HBM during the solve (2 GB each at the
# dim-4M x 128 flagship shape — the difference between fitting and OOM on
# a 16 GB chip).  Opt-in via lobpcg(..., donate=True): the caller's X0/P0
# buffers are invalidated.
_lobpcg_jit_donate = functools.partial(
    jax.jit, static_argnums=(5,), donate_argnums=(3, 6)
)(_lobpcg_impl)


def _prepare_p0(P0, A, config):
    """Validate and prefix-compact a warm-restart momentum block.

    The solver invariant requires live P columns to form a zero-padded
    prefix; a checkpoint produced by this library satisfies that, but a
    user-assembled P0 may not — compact nonzero columns to the front (a
    cheap host-side [n, m] shuffle) and count them.
    """
    if P0 is None:
        return None, 0
    if P0.shape != (A.shape[0], config.size_sub):
        raise ValueError(
            f"P0 has shape {P0.shape}, expected "
            f"({A.shape[0]}, {config.size_sub})"
        )
    import numpy as _np

    nonzero = _np.asarray(jnp.max(jnp.abs(P0), axis=0) > 0)
    order = _np.argsort(~nonzero, kind="stable")
    p0_cnt = int(nonzero.sum())
    if not (order == _np.arange(order.size)).all():
        P0 = jnp.take(P0, jnp.asarray(order), axis=1)
    return P0, p0_cnt


def _check_rr_chunk_unsharded(config: SolverConfig, *objs) -> None:
    """rr_chunk_rows row-chunks widened Gram contractions via an
    [n, k] -> [n/c, c, k] reshape, which conflicts with a leading axis
    sharded over more than one device (GSPMD must gather or repartition
    the tall blocks at every chunked contraction).  Raise up front
    instead of tracing a silently catastrophic program.
    Only concrete arrays can be inspected; tracer inputs skip the check.
    """
    if not config.rr_chunk_rows:
        return
    for obj in objs:
        if obj is None:
            continue
        for leaf in jax.tree_util.tree_leaves(obj):
            sh = getattr(leaf, "sharding", None)
            shape = getattr(leaf, "shape", ())
            if sh is None or not shape:
                continue
            try:
                row_sharded = (
                    len(sh.device_set) > 1
                    and sh.shard_shape(tuple(shape))[0] != shape[0]
                )
            except Exception:  # noqa: BLE001 - abstract shardings: skip
                continue
            if row_sharded:
                raise ValueError(
                    "rr_chunk_rows is set but an input is row-sharded "
                    f"over {len(sh.device_set)} devices (leaf shape "
                    f"{tuple(shape)}): the chunking reshape conflicts "
                    "with a sharded leading axis.  Unset rr_chunk_rows "
                    "for sharded solves — the psum'd distributed Grams "
                    "do not hit the single-chip f64-emulation operand "
                    "splits it exists to bound."
                )


def lobpcg(
    A: LinearOperator,
    X0: Optional[jax.Array] = None,
    B: Optional[LinearOperator] = None,
    T: Optional[LinearOperator] = None,
    *,
    P0: Optional[jax.Array] = None,
    nev: Optional[int] = None,
    size_sub: Optional[int] = None,
    tol: float = 1e-5,
    max_iter: int = 100,
    key: Optional[jax.Array] = None,
    config: Optional[SolverConfig] = None,
    donate: bool = False,
    it_cap=None,
) -> LOBPCGResult:
    """Solve A x = lambda B x for the nev smallest eigenpairs.

    Drop-in capability match for the reference's `lobpcg()` entry point
    (`lobpcg.h:69-75` -> `src/core/lobpcg_impl.inc:60`): B=None gives the
    standard problem, T is an optional preconditioner, X0 an optional
    initial guess ([n, size_sub]; first nev columns meaningful).

    donate=True donates the X0/P0 buffers to the solve (they are
    invalidated) — frees 2 n*size_sub scalars of HBM at capacity-bound
    problem sizes.

    it_cap: optional *runtime* iteration cap (an i32 scalar <=
    config.max_iter).  Unlike max_iter it is traced, so chunked drivers
    can vary it per call without triggering a recompile.
    """
    if config is None:
        if nev is None:
            raise ValueError("either nev or config must be given")
        config = SolverConfig(
            nev=nev,
            size_sub=size_sub if size_sub is not None else nev,
            tol=tol,
            max_iter=max_iter,
        )
    validate_problem(A.shape[0], config)
    if key is None:
        key = jax.random.PRNGKey(0)
    if X0 is not None and X0.shape[1] != config.size_sub:
        raise ValueError(
            f"X0 has {X0.shape[1]} columns, expected size_sub={config.size_sub}"
        )
    if X0 is not None and X0.shape[0] != A.shape[0]:
        raise ValueError(
            f"X0 has {X0.shape[0]} rows, expected A.shape[0]={A.shape[0]}"
        )
    if isinstance(it_cap, int) and it_cap > config.max_iter:
        raise ValueError(
            f"it_cap ({it_cap}) > config.max_iter ({config.max_iter})"
        )
    _check_rr_chunk_unsharded(config, A, X0, B, T)
    P0, p0_cnt = _prepare_p0(P0, A, config)
    fn = _lobpcg_jit_donate if donate else _lobpcg_jit
    from lobpcg_tpu.ops import gram

    # Tracing (first call per config/shape) bakes the Gram-contraction
    # contraction precision into the program; cached calls ignore the context.
    with gram.precision_ctx(config.gram_precision), \
            gram.mixed_chunk_ctx(config.rr_chunk_rows):
        r = fn(A, B, T, X0, key, config, P0, p0_cnt, it_cap)
    return r._replace(eigenvectors=r.basis[:, : config.nev])
