"""Model-family presets for the variational flow solver.

The reference exposes one solver with three data-constancy variants selected
at init (reference: src/data_types/data_structs.h:27,
src/cuda_operations/2d/cuda_operation_solve_2d.cpp:65-82). These presets
name the classic model families those variants implement:

  * Horn-Schunck: brightness constancy, single level;
  * Brox warping: coarse-to-fine + robust penalizers, grey or gradient
    constancy;
  * Full model: higher-order data term + flow-driven smoothness + median
    filtering;
  * X-ray / log: log-derivative constancy for multiplicative illumination
    robustness (synchrotron radiography, reference README.md:30-38).
"""

from __future__ import annotations

from tpuflow.config import DataConstancy, FlowConfig


def horn_schunck(
    alpha: float = 35.0,
    outer_iterations: int = 40,
    inner_iterations: int = 5,
) -> FlowConfig:
    """Single-level brightness-constancy relaxation (no pyramid, no warping,
    no presmoothing/median)."""
    return FlowConfig(
        warp_levels_count=1,
        outer_iterations_count=outer_iterations,
        inner_iterations_count=inner_iterations,
        equation_alpha=alpha,
        median_radius=1,
        gaussian_sigma=0.0,
        data_constancy=DataConstancy.GREY,
    )


def brox(
    constancy: DataConstancy = DataConstancy.GRADIENT,
    alpha: float = 35.0,
    sigma: float = 1.5,
) -> FlowConfig:
    """Coarse-to-fine warping with robust (sub-quadratic) penalizers and
    gradient constancy."""
    return FlowConfig(
        equation_alpha=alpha,
        gaussian_sigma=sigma,
        median_radius=1,
        data_constancy=constancy,
    )


def full_model(
    constancy: DataConstancy = DataConstancy.GRADIENT,
    alpha: float = 35.0,
    sigma: float = 1.5,
    median_radius: int = 5,
) -> FlowConfig:
    """Higher-order data term + flow-driven smoothness + median filtering —
    the reference's default operating point."""
    return FlowConfig(
        equation_alpha=alpha,
        gaussian_sigma=sigma,
        median_radius=median_radius,
        data_constancy=constancy,
    )


def xray_log(alpha: float = 35.0, sigma: float = 1.5) -> FlowConfig:
    """Log-derivative constancy for X-ray / multiplicative illumination."""
    return FlowConfig(
        equation_alpha=alpha,
        gaussian_sigma=sigma,
        data_constancy=DataConstancy.LOG_DERIVATIVES,
    )


def reference_default() -> FlowConfig:
    """The reference CLI's exact defaults (reference: src/main.cpp:65-84)."""
    return FlowConfig()
