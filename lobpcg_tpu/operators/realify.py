"""Split-real ("realified") complex solves.

A complex Hermitian pencil A z = lambda B z with A = Ar + i Ai (Ar
symmetric, Ai antisymmetric) embeds into the real symmetric pencil

    M(A) w = lambda M(B) w,   M(H) = [[Hr, -Hi], [Hi, Hr]],

of twice the dimension, with every eigenvalue DOUBLED: if z = x + i y is
an eigenvector then w1 = [x; y] and w2 = [-y; x] both are.  Solving the
real pencil for 2*nev pairs and combining each duplicated pair yields
the nev complex eigenpairs — entirely in f32/f64 real arithmetic.  This
serves backends or libraries without complex support, and lets a
complex128-specified problem be solved in float32 storage.  Whether it
ever beats the native complex path on a GPU is not measured.

`realify_operator` rewrites an operator tree structurally (real-data
operators become diag(Op, Op); complex dense/diagonal data becomes the
2x2 real block embedding), `realify_problem` converts (A, B, T, X0) and
the solver config, and `derealify` folds a real result back to complex
eigenpairs on the host.

Construct complex-specified operators and X0 on the host device
(`jax.default_device(jax.devices("cpu")[0])`) when the solve device
should only ever see the real arrays; the realified outputs migrate to
the accelerator at solve time as usual.

Caveat: for complex eigenvalues of multiplicity >= 2 the folded complex
eigenvectors within the cluster may need re-orthonormalization (any real
basis of the 2d-dimensional embedded eigenspace maps onto the complex
eigenspace, but not necessarily onto an orthonormal complex basis).

Reference context: the reference instantiates c32/c64 through the same
`_Generic` machinery as the real types (`include/lobpcg/types.h:16-20`);
this module is the equivalent capability in real arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from lobpcg_tpu.config import SolverConfig, real_dtype
from lobpcg_tpu.operators.linop import (
    BlockAntiDiagOperator,
    BlockDiagOperator,
    DenseOperator,
    DiagonalOperator,
    JacobiPreconditioner,
    Laplacian1D,
    LinearOperator,
    operator,
)


@operator(data_fields=("Ar", "Ai"))
class RealEmbeddedDenseOperator(LinearOperator):
    """M = [[Ar, -Ai], [Ai, Ar]] applied to stacked [x; y] blocks."""

    Ar: jax.Array  # [n, n] real part (symmetric for Hermitian A)
    Ai: jax.Array  # [n, n] imag part (antisymmetric)

    def matmat(self, X):
        n = self.Ar.shape[0]
        x, y = X[:n], X[n:]
        mm = lambda M, V: jnp.matmul(  # noqa: E731
            M, V, precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=V.dtype)
        return jnp.concatenate(
            [mm(self.Ar, x) - mm(self.Ai, y), mm(self.Ai, x) + mm(self.Ar, y)],
            axis=0,
        )

    @property
    def shape(self):
        n = 2 * self.Ar.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.Ar.dtype


@operator(data_fields=("dr", "di"))
class RealEmbeddedDiagonalOperator(LinearOperator):
    """diag(d) with complex d, realified (di = 0 for Hermitian)."""

    dr: jax.Array
    di: jax.Array

    def matmat(self, X):
        n = self.dr.shape[0]
        x, y = X[:n], X[n:]
        return jnp.concatenate(
            [self.dr[:, None] * x - self.di[:, None] * y,
             self.di[:, None] * x + self.dr[:, None] * y],
            axis=0,
        )

    @property
    def shape(self):
        n = 2 * self.dr.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.dr.dtype


def _is_complex(dt) -> bool:
    return jnp.issubdtype(jnp.dtype(dt), jnp.complexfloating)


def _require_real_values(x, what: str) -> None:
    """Reject genuinely complex data where the embedding rule would
    silently discard the imaginary part.  Realification happens on host
    arrays, so a value check is
    available."""
    if not _is_complex(jnp.asarray(x).dtype):
        return
    im = np.asarray(jax.device_get(jnp.imag(jnp.asarray(x))))
    if np.any(im != 0):
        raise NotImplementedError(
            f"realify_operator: {what} has nonzero imaginary part; this "
            "embedding rule only supports real-valued data — supply the "
            "2x2 real block embedding explicitly (DenseOperator or a "
            "CallableOperator on [2n, k])"
        )


def realify_operator(op: LinearOperator, rdt=None) -> LinearOperator:
    """Real embedding of an operator acting on stacked [re; im] blocks.

    Real-data operators embed as diag(Op, Op); complex dense/diagonal
    data gets the full 2x2 block embedding.  `rdt` overrides the real
    dtype (e.g. jnp.float32 for a complex128-specified host operator
    solved in float32).
    """
    rdt = jnp.dtype(rdt) if rdt is not None else real_dtype(op.dtype)

    if isinstance(op, DenseOperator):
        A = op.A
        if _is_complex(A.dtype):
            return RealEmbeddedDenseOperator(
                Ar=jnp.real(A).astype(rdt), Ai=jnp.imag(A).astype(rdt)
            )
        return BlockDiagOperator(inner=DenseOperator(A.astype(rdt)), copies=2)

    if isinstance(op, DiagonalOperator):
        d = op.d
        if _is_complex(d.dtype):
            return RealEmbeddedDiagonalOperator(
                dr=jnp.real(d).astype(rdt), di=jnp.imag(d).astype(rdt)
            )
        return BlockDiagOperator(
            inner=DiagonalOperator(d.astype(rdt)), copies=2
        )

    if isinstance(op, JacobiPreconditioner):
        # T = diag(d)^-1 with Hermitian-positive d: real by definition.
        _require_real_values(op.d, "JacobiPreconditioner.d")
        d = jnp.real(op.d).astype(rdt)
        return BlockDiagOperator(inner=JacobiPreconditioner(d), copies=2)

    if isinstance(op, Laplacian1D):
        # Real-coefficient stencil: diag(K, K) == one stencil with
        # doubled segments over the stacked layout.
        _require_real_values(op.scale, "Laplacian1D.scale")
        return Laplacian1D(
            scale=jnp.real(op.scale).astype(rdt),
            n=2 * op.n,
            segments=2 * op.segments,
        )

    if isinstance(op, BlockAntiDiagOperator):
        # B = antidiag(D, D) applies the same D both ways, which is
        # Hermitian only for real-valued D — so the embedding is
        # diag(B, B) over the stacked [re; im] layout.  A complex dtype
        # may only carry real values here (the BdG fixture pattern).
        _require_real_values(op.d, "BlockAntiDiagOperator.d")
        return BlockDiagOperator(
            inner=BlockAntiDiagOperator(d=jnp.real(op.d).astype(rdt)),
            copies=2,
        )

    # Structural wrappers: rewrite children.  Block-STACKING wrappers
    # (BlockDiagOperator and friends) change which rows a child sees;
    # under the global [re; im] stacking a recursed complex-data child
    # embedding would be applied to [re u1; re u2] instead of its own
    # [re; im] block — layout-unsound.  Homogeneous REAL-data children
    # are safe (the same real operator acts identically on any block),
    # so stacking wrappers are allowed only when every array leaf in the
    # subtree is real-valued.
    if type(op).__name__ in ("BlockDiagOperator", "BlockDiag2Operator"):
        for leaf in jax.tree_util.tree_leaves(op):
            _require_real_values(leaf, f"{type(op).__name__} child data")

    if dataclasses.is_dataclass(op):
        changes = {}
        for f in dataclasses.fields(op):
            v = getattr(op, f.name)
            if isinstance(v, LinearOperator):
                changes[f.name] = realify_operator(v, rdt)
        if changes:
            # Scaled/Shifted carry scalar fields that must turn real too.
            for f in dataclasses.fields(op):
                v = getattr(op, f.name)
                if f.name in ("alpha", "sigma") and _is_complex(
                    jnp.asarray(v).dtype
                ):
                    _require_real_values(v, f"{type(op).__name__}.{f.name}")
                    changes[f.name] = jnp.real(jnp.asarray(v)).astype(rdt)
            return dataclasses.replace(op, **changes)

    raise NotImplementedError(
        f"realify_operator: no embedding rule for {type(op).__name__}; "
        "wrap the real form yourself (CallableOperator on [2n, k])"
    )


def realify_x0(X0: jax.Array, rdt=None) -> jax.Array:
    """Complex [n, k] start block -> real [2n, 2k]: columns [x; y] and
    [-y; x] per complex column, spanning both copies of each eigenspace."""
    rdt = jnp.dtype(rdt) if rdt is not None else real_dtype(X0.dtype)
    x = jnp.real(X0).astype(rdt)
    y = jnp.imag(X0).astype(rdt)
    w1 = jnp.concatenate([x, y], axis=0)
    w2 = jnp.concatenate([-y, x], axis=0)
    k = X0.shape[1]
    cols = [w1, w2]
    W = jnp.stack(cols, axis=2).reshape(2 * X0.shape[0], 2 * k)
    return W


def realify_config(config: SolverConfig) -> SolverConfig:
    """Double nev / size_sub for the duplicated spectrum."""
    return dataclasses.replace(
        config, nev=2 * config.nev, size_sub=2 * config.size_sub
    )


def realify_problem(A, X0=None, B=None, T=None, *, config: SolverConfig,
                    rdt=None):
    """Convert a complex problem to its real embedding.

    Returns (A_r, X0_r, B_r, T_r, config_r)."""
    return (
        realify_operator(A, rdt),
        realify_x0(X0, rdt) if X0 is not None else None,
        realify_operator(B, rdt) if B is not None else None,
        realify_operator(T, rdt) if T is not None else None,
        realify_config(config),
    )


def derealify(result, nev: int, *, tol_pair: float = 1e-3):
    """Fold a real-embedded result back to nev complex eigenpairs (host).

    Eigenvalues arrive in (approximately) duplicated pairs; each pair's
    2-dim real eigenspace corresponds to one complex eigenvector
    z = w[:n] + i w[n:].  Returns (eigenvalues [nev], eigenvectors
    [n, nev] complex, residual_norms [nev]).
    """
    lam = np.asarray(result.eigenvalues)
    V = np.asarray(result.eigenvectors)
    res = np.asarray(result.residual_norms)
    n2 = V.shape[0]
    n = n2 // 2

    out_lam = np.empty(nev, lam.dtype)
    cdt = np.complex64 if V.dtype == np.float32 else np.complex128
    out_vec = np.empty((n, nev), cdt)
    out_res = np.empty(nev, res.dtype)

    i = 0
    broken = 0
    for j in range(nev):
        paired = i + 1 < lam.shape[0] and abs(lam[i + 1] - lam[i]) <= (
            tol_pair * (1.0 + abs(lam[i]))
        )
        if paired:
            pair_res = (
                max(res[i], res[i + 1]) if i + 1 < res.shape[0] else res[i]
            )
        else:
            # Unpaired value (unconverged solve or spurious interleaved
            # eigenvalue): emit it but advance by ONE so subsequent
            # genuine pairs stay in sync.
            broken += 1
            pair_res = res[i] if i < res.shape[0] else np.nan
        out_lam[j] = lam[i]
        w = V[:, i]
        z = w[:n] + 1j * w[n:]
        nz = np.linalg.norm(z)
        if nz > 0:
            z = z / nz
        out_vec[:, j] = z
        out_res[j] = pair_res
        i += 2 if paired else 1
    if broken:
        import warnings

        warnings.warn(
            f"derealify: {broken} eigenvalue(s) arrived without their "
            "duplicated partner (unconverged or spurious); check "
            "result.converged before trusting the folded spectrum",
            stacklevel=2,
        )
    return out_lam, out_vec, out_res
