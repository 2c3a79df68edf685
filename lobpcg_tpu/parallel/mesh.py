"""Device mesh helpers for row-partitioned LOBPCG.

The reference is single-process (OpenMP + threaded MKL only,
`/root/reference/Makefile:3,12`); distribution is designed fresh here per
SURVEY.md §2.6: a 1-D mesh over the problem's row dimension.  The tall
blocks S=[X|P|W], AX, and the operator data are sharded over `rows`;
Gram contractions then lower to local partial products + psum,
and the tiny k x k projected eigensolves stay replicated.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROWS = "rows"


def row_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
    axis: str = ROWS,
) -> Mesh:
    """1-D mesh over the row axis.  Defaults to all devices of the default
    backend; asking for more devices than it has is an error (never a
    silent mesh of some other backend's devices)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)} "
                f"({devices[0].platform if devices else 'none'})"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def row_sharding(mesh: Mesh, ndim: int, axis: str = ROWS) -> NamedSharding:
    """NamedSharding partitioning dim 0 over the mesh."""
    spec = P(axis, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
