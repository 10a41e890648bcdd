"""Host-side specs and cost model (pure Python; no torch)."""

from .chunking import prompt_slices
from .costs import CostModel, analytic_coefficients
from .plan import ClusterSpec, Coefficients, ModelSpec

__all__ = ["ClusterSpec", "Coefficients", "CostModel", "ModelSpec",
           "analytic_coefficients", "prompt_slices"]
