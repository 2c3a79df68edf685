"""Indefinite LOBPCG driver (Kressner-Pandur-Shao).

Reference: `src/core/ilobpcg_impl.inc:54-282`.  Same while-loop skeleton
as solvers.lobpcg plus: initial SVQB B-orthonormalization, GGEV-based RR
with signature tracking (ops.indefinite), signature-weighted W
orthogonalization every iteration, and the quality=5 dual-basis
projection: when the projected pencil's eigenvectors lose
B-orthogonality, the accurate Cx drives the residual while the
svqb-stabilized Cx_ortho drives the iteration basis
(`ilobpcg_impl.inc:204-256`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from lobpcg_tpu.config import (
    SolverConfig,
    quality_tol,
    tiny,
    validate_problem,
)
from lobpcg_tpu.operators.linop import LinearOperator
from lobpcg_tpu.ops import masking
from lobpcg_tpu.ops.gram import (
    with_gram_ctx,
    apply_block_op,
    b_mm,
    mm,
)
from lobpcg_tpu.ops.indefinite import (
    indefinite_rayleigh_ritz,
    indefinite_rayleigh_ritz_modified,
)
from lobpcg_tpu.ops.ortho import ortho_indefinite
from lobpcg_tpu.ops.residual import (
    estimate_norm,
    get_residual,
    get_residual_norm,
)
from lobpcg_tpu.ops.svqb import robust_basis_init, svqb
from lobpcg_tpu.solvers import observe
from lobpcg_tpu.solvers.lobpcg import (
    _check_rr_chunk_unsharded,
    _prepare_p0,
)
from lobpcg_tpu.solvers.state import ILOBPCGResult
from lobpcg_tpu.utils.prng import fill_random


class _Carry(NamedTuple):
    # Blockwise state — the concatenated [n, 3m] S never exists in HBM.
    X: jax.Array  # [n, m]
    P: jax.Array  # [n, m], active-prefix compacted (dead cols zero)
    W: jax.Array  # [n, m], active-prefix compacted (dead cols zero)
    AX: jax.Array  # [n, m]
    lam: jax.Array  # [m] real
    sig: jax.Array  # [m] i32 signature of the X block
    res: jax.Array  # [nev] real
    conv: jax.Array  # i32
    it: jax.Array  # i32
    p_cnt: jax.Array  # i32 — valid P columns (0 after an rr-fail reset)
    q5: jax.Array  # i32 — quality=5 dual-basis iterations
    rr_fail: jax.Array  # i32 — failed projected pencil solves
    stall: jax.Array  # i32 — iterations without convergence progress
    res_best: jax.Array  # best (lowest) max-residual seen, for stall
    hist: object  # SolveHistory or None (static per config)


@with_gram_ctx
def _ilobpcg_impl(A, B, T, X0, key, config: SolverConfig, P0=None,
                  p0_cnt=0, it_cap=None):
    n = A.shape[0]
    m = config.size_sub
    nev = config.nev
    dtype = A.dtype
    eps_ortho, eps_drop = config.resolved_eps(dtype)
    rrdt = config.resolved_rr_dtype(dtype)
    tn = tiny(dtype if rrdt is None else rrdt)
    qt = quality_tol(dtype)

    k_a, k_b, k_x, k_r, k_stall = jax.random.split(key, 5)
    a_norm = estimate_norm(A, k_a, config.norm_iters, config.norm_block)
    b_norm = estimate_norm(B, k_b, config.norm_iters, config.norm_block)

    def res_norm(W, lam):
        # residual_norm="b": B-seminorm numerator (one extra [n, nev]
        # B application); "2" keeps the reference's 2-norm parity.
        BW = (
            apply_block_op(B, W[:, :nev])
            if config.residual_norm == "b" else None
        )
        return get_residual_norm(W, lam, a_norm, b_norm, nev, BW)

    observe.log_start(config, "ilobpcg", a_norm, b_norm)

    X = fill_random(k_x, (n, m), dtype) if X0 is None else X0.astype(dtype)

    # B-orthonormalize the start basis with rank repair
    # (`ilobpcg_impl.inc:101-102` plus dropped-column refill).
    X = robust_basis_init(X, B, k_r, tau=eps_drop, rr_dtype=rrdt)

    # Initial indefinite RR (`ilobpcg_impl.inc:105-109`).
    Cx0, lam0, sig0, rr_ok0 = indefinite_rayleigh_ritz(
        X, A, B, method=config.rr_method, tiny=tn, rr_dtype=rrdt
    )
    X = mm(X, Cx0)
    AX = A.matmat(X)
    W = get_residual(X, AX, lam0, A, B)
    res = res_norm(W, lam0)

    # Cache off -> dummy in the carry (see lobpcg.py).
    if not config.use_ax_cache:
        AX = jnp.zeros((1, 1), dtype)

    P_init = (
        jnp.zeros((n, m), dtype) if P0 is None else P0.astype(dtype)
    )
    hist0 = observe.history_init(config, m, lam0.dtype, res.dtype)
    warm_p = jnp.int32(p0_cnt) if P0 is not None else jnp.int32(0)
    carry0 = _Carry(
        X, P_init, W, AX, lam0, sig0, res, jnp.int32(0), jnp.int32(0),
        warm_p, jnp.int32(0), (~rr_ok0).astype(jnp.int32), jnp.int32(0),
        jnp.max(res), hist0
    )

    # Runtime iteration cap (see solvers.lobpcg): traced, so chunked
    # drivers vary it per call with ONE compile.  Clamped to max_iter so
    # history scatters stay in bounds.
    limit = (
        config.max_iter if it_cap is None
        else jnp.minimum(jnp.int32(it_cap), config.max_iter)
    )

    def cond(c: _Carry):
        return (c.it < limit) & (c.conv < nev)

    def body(c: _Carry):
        it0 = c.it == 0
        np_act = jnp.minimum(c.p_cnt, m - c.conv)
        nw = jnp.where(it0, jnp.int32(m), m - c.conv)
        W = c.W

        # Stagnation stabilizer (SolverConfig.stall_reset): perturb W
        # with column-norm-scaled noise when the solve has thrashed —
        # near the f32 floor a failed pencil solve discards the
        # iteration and rebuilds W from X deterministically, so without
        # a perturbation the retry can cycle (r4 quartet: 34 vs 192
        # iterations for bit-different programs of the same problem).
        # Column scaling keeps dead (zero) columns exactly zero.
        tripped = jnp.bool_(False)
        if config.stall_reset:
            tripped = c.stall >= config.stall_reset

            def perturb(W):
                from lobpcg_tpu.config import STALL_NOISE

                z = fill_random(
                    jax.random.fold_in(k_stall, c.it), (n, m), dtype
                )
                nrm = jnp.sqrt(
                    jnp.sum(jnp.abs(W) ** 2, axis=0, keepdims=True)
                ).astype(dtype)
                return W + z * (STALL_NOISE * nrm)

            W = jax.lax.cond(tripped, perturb, lambda w: w, W)

        if T is not None:
            W = masking.mask_cols(T.matmat(W), nw)

        # Indefinite orthogonalization against [X, P_active], every
        # iteration (`ilobpcg_impl.inc:168-178`).  With use_b_cache, B is
        # applied to X and P ONCE here and the pre-applied blocks feed
        # the ortho projector, the RR B-Gram (gram_blocks_pre via
        # Bblocks), and the recovery residual — ~6 fewer [n, m] B
        # applications per iteration than re-applying at each site the
        # way the reference does (`gram_impl.inc:49-67`).
        if config.use_b_cache:
            BX = apply_block_op(B, c.X)
            BP = apply_block_op(B, c.P)
            W, nw, BW = ortho_indefinite(
                W, nw, (c.X, c.P), m + np_act, B,
                eps_ortho=eps_ortho, eps_drop=eps_drop,
                max_outer=config.max_outer, max_inner=config.max_inner,
                rr_dtype=rrdt, Bvb=(BX, BP), return_bu=True,
                entry_check=config.ortho_skip,
            )
            Bblocks = (BX, BP, BW)
        else:
            W, nw = ortho_indefinite(
                W, nw, (c.X, c.P), m + np_act, B,
                eps_ortho=eps_ortho, eps_drop=eps_drop,
                max_outer=config.max_outer, max_inner=config.max_inner,
                rr_dtype=rrdt, entry_check=config.ortho_skip,
            )
            Bblocks = None
        blocks = (c.X, c.P, W)

        AX = c.AX if config.use_ax_cache else None
        rr = indefinite_rayleigh_ritz_modified(
            blocks, AX, np_act, nw, A, B,
            nx=m, method=config.rr_method, tiny=tn, quality_tol=qt,
            eps_ortho=eps_ortho, eps_drop=eps_drop,
            max_outer=config.max_outer, max_inner=config.max_inner,
            rr_dtype=rrdt, Bblocks=Bblocks,
        )

        def project_good(_):
            Xn = b_mm(blocks, rr.Cx)
            Pn = b_mm(blocks, rr.Cp)
            AXn = A.matmat(Xn)
            Wres = get_residual(Xn, AXn, rr.lam, A, B)
            if not config.use_ax_cache:
                AXn = jnp.zeros((1, 1), dtype)
            return Xn, Pn, AXn, Wres

        def project_poor(_):
            # Residual from the accurate basis; iterate the stable one
            # (`ilobpcg_impl.inc:228-256`).
            X_acc = b_mm(blocks, rr.Cx)
            Xn = b_mm(blocks, rr.Cx_ortho)
            Pn = b_mm(blocks, rr.Cp)
            AXn = (
                A.matmat(Xn) if config.use_ax_cache
                else jnp.zeros((1, 1), dtype)
            )
            Wres = get_residual(X_acc, None, rr.lam, A, B)
            return Xn, Pn, AXn, Wres

        def do_update(_):
            if config.dual_basis:
                Xn, Pn, AXn, Wres = jax.lax.cond(
                    rr.quality == 1, project_good, project_poor, None
                )
            else:
                # Dual-basis path compiled out (SolverConfig.dual_basis):
                # no extra accurate-basis block in the loop's peak HBM.
                Xn, Pn, AXn, Wres = project_good(None)
            return Xn, Pn, AXn, Wres, rr.lam, rr.sig[:m]

        def do_recover(_):
            # The projected pencil solve failed (rr.rr_ok False — e.g.
            # NaN crept into P/W near the f32 convergence floor, making
            # GA non-definite).  The reference writes to stderr and
            # carries garbage (`indefinite_rr_impl.inc:88-95`); here the
            # iteration's update is DISCARDED instead: keep the finite
            # X/eigenvalues, reset the momentum, and rebuild W from X so
            # the next iteration restarts from a clean [X, W] subspace.
            # B is re-applied here rather than reusing the cached BX:
            # referencing BX would keep it live across the whole
            # project-back cond, raising peak device memory by one
            # [n, m] block at its hottest point (benchmarks/
            # mem_analysis.py shows it); one extra B apply on the rare
            # failure path is the cheap side of that trade.
            Wres = get_residual(
                c.X, c.AX if config.use_ax_cache else None, c.lam, A, B,
            )
            return (c.X, jnp.zeros_like(c.P), c.AX, Wres, c.lam, c.sig)

        Xn, Pn, AXn, Wres, lam_n, sig_n = jax.lax.cond(
            rr.rr_ok, do_update, do_recover, None
        )

        res = res_norm(Wres, lam_n)
        convn = masking.prefix_count(res <= config.tol)

        act = m - convn
        p_next = jnp.where(rr.rr_ok, act, 0)
        Pc = masking.shift_cols(Pn, convn, p_next)
        Wc = masking.shift_cols(Wres, convn, act)

        observe.log_iteration(config, "ilobpcg", c.it, lam_n, res, convn)
        flag = (
            rr.quality + 8 * (~rr.rr_ok).astype(jnp.int32)
            + 16 * tripped.astype(jnp.int32)
        )
        hist = observe.history_update(
            c.hist, c.it, lam_n, res, convn, flag
        )
        # Stall accounting.  Progress = the converged prefix grew OR the
        # worst residual improved geometrically (10%) on the best seen —
        # healthy solves reduce residuals every iteration, so legitimate
        # pre-convergence plateaus of the PREFIX never count as stall.
        # Reset on progress or after a perturbation fired (so it cannot
        # fire every iteration); an rr-failed iteration jumps straight
        # to the threshold — the very next iteration perturbs instead
        # of replaying the failed deterministic rebuild.
        res_max = jnp.max(res)
        improved = (convn > c.conv) | (res_max < 0.9 * c.res_best)
        K = jnp.int32(max(config.stall_reset, 1))
        stall_n = jnp.where(
            improved | tripped,
            jnp.int32(0),
            jnp.minimum(
                c.stall + 1 + K * (~rr.rr_ok).astype(jnp.int32), 2 * K
            ),
        )
        return _Carry(
            Xn, Pc, Wc, AXn, lam_n, sig_n, res, convn, c.it + 1, p_next,
            # rr-failed iterations also produce quality==5 (NaN lam fails
            # the quality check) but take do_recover, not the dual-basis
            # path — gate on rr_ok so the counters don't double-count.
            c.q5 + ((rr.quality == 5) & rr.rr_ok).astype(jnp.int32),
            c.rr_fail + (~rr.rr_ok).astype(jnp.int32),
            stall_n, jnp.minimum(c.res_best, res_max), hist
        )

    cf = jax.lax.while_loop(cond, body, carry0)

    return ILOBPCGResult(
        eigenvalues=cf.lam[:nev],
        # eigenvectors would duplicate a slice of `basis` in the jitted
        # output (an extra n*nev HBM buffer live at solve peak); the
        # public wrapper slices it lazily after temps are freed.
        eigenvectors=None,
        residual_norms=cf.res,
        signature=cf.sig[:nev],
        converged=cf.conv,
        iterations=cf.it,
        basis=cf.X,
        momentum=cf.P,
        history=cf.hist,
        quality5_count=cf.q5,
        rr_fail_count=cf.rr_fail,
    )


_ilobpcg_jit = functools.partial(jax.jit, static_argnums=(5,))(_ilobpcg_impl)
# See solvers.lobpcg: donating X0/P0 frees 2 n*m scalars of HBM.
_ilobpcg_jit_donate = functools.partial(
    jax.jit, static_argnums=(5,), donate_argnums=(3, 6)
)(_ilobpcg_impl)


def ilobpcg(
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
) -> ILOBPCGResult:
    """Solve A x = lambda B x with **indefinite** B for the eigenvalues
    closest to the positive spectrum edge (KPS ordering: positive
    ascending first).

    Capability match for the reference's `ilobpcg()` entry point
    (`lobpcg.h:77-83` -> `src/core/ilobpcg_impl.inc:54`).  B is required.
    """
    if B is None:
        raise ValueError("ilobpcg: B operator must not be None")
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
    fn = _ilobpcg_jit_donate if donate else _ilobpcg_jit
    from lobpcg_tpu.ops import gram

    # See solvers.lobpcg: precision is baked in at trace time.
    with gram.precision_ctx(config.gram_precision), \
            gram.mixed_chunk_ctx(config.rr_chunk_rows):
        r = fn(A, B, T, X0, key, config, P0, p0_cnt, it_cap)
    return r._replace(eigenvectors=r.basis[:, : config.nev])
