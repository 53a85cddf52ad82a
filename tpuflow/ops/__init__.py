"""Pure-JAX ops (the production compute path).

Every op is a pure function on float32 jax arrays with static shapes, and has
a NumPy twin in tpuflow.oracle used as the test ground truth.
"""

from tpuflow.ops.gaussian import gaussian_kernel_taps, gaussian_smooth  # noqa: F401
from tpuflow.ops.resample import resample, resample_weights  # noqa: F401
from tpuflow.ops.warp import warp  # noqa: F401
from tpuflow.ops.median import median  # noqa: F401
from tpuflow.ops.solver_ops import (  # noqa: F401
    compute_phi_ksi,
    solve_sweep,
)
