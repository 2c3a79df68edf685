"""lobpcg_tpu — a block LOBPCG eigensolver framework in JAX.

A from-scratch JAX/XLA re-design of the capability set of
pstuermer/LOBPCG (standard, generalized, and indefinite LOBPCG with
Duersch-Ye robust basis selection and Kressner-Pandur-Shao indefinite
Rayleigh-Ritz) for accelerators and device meshes: block-native
matrix-free operators, fixed-shape masked soft locking, on-device
projected eigensolves, and row-sharded operators with psum'd Gram
reductions.
"""

from lobpcg_tpu.config import SolverConfig
from lobpcg_tpu.operators.linop import (
    BlockAntiDiagOperator,
    BlockDiagOperator,
    CallableOperator,
    ComposedOperator,
    DenseOperator,
    DiagonalOperator,
    JacobiPreconditioner,
    Laplacian1D,
    LinearOperator,
    ScaledOperator,
    ShiftedOperator,
    SumOperator,
)
from lobpcg_tpu.operators.chebyshev import ChebyshevFilter
from lobpcg_tpu.operators.stencil_nd import LaplacianND
from lobpcg_tpu.operators.realify import (
    derealify,
    realify_operator,
    realify_problem,
    realify_x0,
)
from lobpcg_tpu.solvers.ilobpcg import ilobpcg
from lobpcg_tpu.solvers.lobpcg import lobpcg
from lobpcg_tpu.solvers.state import (
    ILOBPCGResult,
    LOBPCGResult,
    SolveHistory,
)
from lobpcg_tpu.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    solve_checkpointed,
)
from lobpcg_tpu.utils.plan import (
    estimate_peak_gb,
    plan_config,
)

# The reference exposes `klobpcg` as a pure alias of the standard solver
# (`/root/reference/lobpcg.h:561-580`; a separate klobpcg main loop was
# planned but never built, `TODO.md:258-263`).  Same here.
klobpcg = lobpcg

__all__ = [
    "SolverConfig",
    "LinearOperator",
    "DenseOperator",
    "DiagonalOperator",
    "JacobiPreconditioner",
    "ChebyshevFilter",
    "CallableOperator",
    "Laplacian1D",
    "LaplacianND",
    "BlockDiagOperator",
    "BlockAntiDiagOperator",
    "ShiftedOperator",
    "ScaledOperator",
    "SumOperator",
    "ComposedOperator",
    "lobpcg",
    "ilobpcg",
    "klobpcg",
    "LOBPCGResult",
    "ILOBPCGResult",
    "SolveHistory",
    "realify_operator",
    "realify_problem",
    "realify_x0",
    "derealify",
    "save_checkpoint",
    "load_checkpoint",
    "solve_checkpointed",
    "estimate_peak_gb",
    "plan_config",
]

__version__ = "0.1.0"
