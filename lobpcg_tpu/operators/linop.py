"""Matrix-free linear operators, block-native from day one.

The reference exposes a per-column ``matvec`` callback
(`/root/reference/include/lobpcg/linop.h:13-53`) and applies it in a
column-at-a-time loop (`src/gram/gram_impl.inc:29-33`).  On an
accelerator that loop is an anti-pattern: one [n, k] block apply streams
the operator once for all k columns, so the operator contract here is
``matmat(X: [n, k]) -> [n, k]``.  Every concrete
operator is a JAX pytree, so operators flow through ``jit`` /
``lax.while_loop`` / ``shard_map`` as ordinary traced state.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp


class LinearOperator(abc.ABC):
    """Protocol: a Hermitian (or general) linear operator on [n, k] blocks."""

    @abc.abstractmethod
    def matmat(self, X: jax.Array) -> jax.Array:
        """Apply the operator to a block of column vectors: Y = Op @ X."""

    @property
    @abc.abstractmethod
    def shape(self) -> tuple[int, int]:
        ...

    @property
    @abc.abstractmethod
    def dtype(self) -> Any:
        ...

    def __call__(self, X: jax.Array) -> jax.Array:
        return self.matmat(X)

    # --- composition sugar -------------------------------------------------
    def __add__(self, other: "LinearOperator") -> "LinearOperator":
        return SumOperator(self, other)

    def __mul__(self, scalar) -> "LinearOperator":
        return ScaledOperator(self, jnp.asarray(scalar, self.dtype))

    __rmul__ = __mul__

    def __matmul__(self, other: "LinearOperator") -> "LinearOperator":
        return ComposedOperator(self, other)


def _register(cls, data_fields, meta_fields):
    """Register a dataclass-based operator as a JAX pytree."""

    def flatten(obj):
        return (
            tuple(getattr(obj, f) for f in data_fields),
            tuple(getattr(obj, f) for f in meta_fields),
        )

    def unflatten(meta, data):
        kwargs = dict(zip(data_fields, data))
        kwargs.update(dict(zip(meta_fields, meta)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


def operator(data_fields=(), meta_fields=()):
    """Decorator: dataclass + pytree registration for operators."""

    def wrap(cls):
        cls = dataclasses.dataclass(cls)
        return _register(cls, tuple(data_fields), tuple(meta_fields))

    return wrap


@operator(data_fields=("A",))
class DenseOperator(LinearOperator):
    """Dense matrix operator (reference fixture: `tests/test_lobpcg.c:29-42`)."""

    A: jax.Array  # [n, n]

    def matmat(self, X):
        return jnp.matmul(self.A, X, precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=X.dtype)

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype


@operator(data_fields=("d",))
class DiagonalOperator(LinearOperator):
    """Diagonal operator (reference fixture: `tests/test_lobpcg.c:440-447`)."""

    d: jax.Array  # [n]

    def matmat(self, X):
        return self.d[:, None] * X

    @property
    def shape(self):
        n = self.d.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.d.dtype


@operator(data_fields=("d",))
class JacobiPreconditioner(LinearOperator):
    """T = diag(d)^{-1}; the standard preconditioner shape for LOBPCG."""

    d: jax.Array  # [n] diagonal of A (or an approximation)

    def matmat(self, X):
        return X / self.d[:, None]

    @property
    def shape(self):
        n = self.d.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.d.dtype


@operator(data_fields=("args",), meta_fields=("fn", "n", "_dtype"))
class CallableOperator(LinearOperator):
    """Matrix-free operator from a user-supplied jittable block function.

    ``fn(X, *args) -> Y`` with X, Y of shape [n, k].  ``args`` is a pytree
    of traced operator data (the analog of the reference's opaque
    ``linop_ctx_t``, `include/lobpcg/linop.h:7-11`).
    """

    args: Any
    fn: Callable = None
    n: int = 0
    _dtype: Any = jnp.float32

    def matmat(self, X):
        return self.fn(X, *self.args)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self._dtype


@operator(data_fields=("scale",), meta_fields=("n", "segments"))
class Laplacian1D(LinearOperator):
    """Segmented 1-D Dirichlet Laplacian: block-diag of `segments`
    independent tridiag[-1, 2, -1] * scale stencils (scale = 1/h^2).

    Reference fixtures: `tests/test_lobpcg.c:48-62` (segments=1, analytic
    eigenvalues (k*pi)^2) and the BdG block-Laplacian A = diag(K, K)
    (`tests/test_ilobpcg.c:28-52`, segments=2).

    A pad/slice formulation: XLA fuses the pad, the shifted slices and
    the axpy into one loop that reads X once and writes Y once, together
    with any elementwise term summed onto it (the flagship's
    ``Laplacian1D + DiagonalOperator``).  Under row sharding the
    partitioner turns the slices into local stencils plus halo
    collective-permutes.
    """

    scale: jax.Array  # scalar 1/h^2
    n: int = 0
    segments: int = 1

    def matmat(self, X):
        k = X.shape[1]
        Xs = X.reshape(self.segments, self.n // self.segments, k)
        Xp = jnp.pad(Xs, ((0, 0), (1, 1), (0, 0)))
        Y = self.scale * (2.0 * Xs - Xp[:, 2:] - Xp[:, :-2])
        return Y.reshape(self.n, k)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.scale.dtype


@operator(data_fields=("inner",), meta_fields=("copies",))
class BlockDiagOperator(LinearOperator):
    """A = diag(K, K, ..., K): `copies` stacked copies of `inner`.

    Reference BdG fixture: A = {{K,0},{0,K}}
    (`tests/test_ilobpcg.c:28-52`).
    """

    inner: LinearOperator
    copies: int = 2

    def matmat(self, X):
        m = self.inner.shape[0]
        parts = [
            self.inner.matmat(X[i * m : (i + 1) * m]) for i in range(self.copies)
        ]
        return jnp.concatenate(parts, axis=0)

    @property
    def shape(self):
        n = self.inner.shape[0] * self.copies
        return (n, n)

    @property
    def dtype(self):
        return self.inner.dtype


@operator(data_fields=("d",))
class BlockAntiDiagOperator(LinearOperator):
    """B = {{0, D}, {D, 0}} with D = diag(d): swaps halves and scales.

    Reference BdG fixtures: block permutation B = {{0,I},{I,0}}
    (`tests/test_ilobpcg.c:57-67`) and the ill-conditioned
    B = {{0,D},{D,0}}, D = diag(r^i) that forces the quality=5 path
    (`tests/test_ilobpcg.c:75-90`).
    """

    d: jax.Array  # [m], n = 2m

    def matmat(self, X):
        m = self.d.shape[0]
        top = self.d[:, None] * X[m:]
        bot = self.d[:, None] * X[:m]
        return jnp.concatenate([top, bot], axis=0)

    @property
    def shape(self):
        n = 2 * self.d.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.d.dtype


@operator(data_fields=("op", "sigma"))
class ShiftedOperator(LinearOperator):
    """op + sigma * I."""

    op: LinearOperator
    sigma: jax.Array

    def matmat(self, X):
        return self.op.matmat(X) + self.sigma * X

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return self.op.dtype


@operator(data_fields=("op", "alpha"))
class ScaledOperator(LinearOperator):
    op: LinearOperator
    alpha: jax.Array

    def matmat(self, X):
        return self.alpha * self.op.matmat(X)

    @property
    def shape(self):
        return self.op.shape

    @property
    def dtype(self):
        return self.op.dtype


@operator(data_fields=("left", "right"))
class SumOperator(LinearOperator):
    left: LinearOperator
    right: LinearOperator

    def matmat(self, X):
        return self.left.matmat(X) + self.right.matmat(X)

    @property
    def shape(self):
        return self.left.shape

    @property
    def dtype(self):
        return self.left.dtype


@operator(data_fields=("outer", "inner"))
class ComposedOperator(LinearOperator):
    outer: LinearOperator
    inner: LinearOperator

    def matmat(self, X):
        return self.outer.matmat(self.inner.matmat(X))

    @property
    def shape(self):
        return (self.outer.shape[0], self.inner.shape[1])

    @property
    def dtype(self):
        return self.outer.dtype
