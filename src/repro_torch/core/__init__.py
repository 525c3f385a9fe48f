"""SwiftFusion core in PyTorch.

Public API:
  sp_attention / SPConfig     — attention entry point (degree 1 so far)
  reference_attention         — single-device oracle
  plan / SPPlan               — the paper's §4.2 topology planner (copy)
  plan_hybrid / HybridPlan    — (cfg, pp, P_u, P_r) hybrid planner (copy)
  PipelineConfig / KVState    — displaced patch pipelining types
  comm_model, calibration     — analytical latency model and its fitter (copies)
"""
from .pipefusion import KVState, PipelineConfig
from .planner import (
    HybridPlan,
    SPPlan,
    candidate_hybrid_plans,
    plan,
    plan_for_shape,
    plan_hybrid,
    usp_plan,
)
from .softmax import (
    MaskSpec,
    Partial,
    attend_partial,
    empty_partial,
    finalize,
    merge,
    reference_attention,
)
from .strategy import STRATEGIES, SPConfig, sp_attention

__all__ = [
    "HybridPlan",
    "KVState",
    "MaskSpec",
    "Partial",
    "PipelineConfig",
    "SPConfig",
    "SPPlan",
    "STRATEGIES",
    "attend_partial",
    "candidate_hybrid_plans",
    "empty_partial",
    "finalize",
    "merge",
    "plan",
    "plan_for_shape",
    "plan_hybrid",
    "reference_attention",
    "sp_attention",
    "usp_plan",
]
