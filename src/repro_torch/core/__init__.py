"""SwiftFusion core in PyTorch.

Public API:
  sp_attention / SPConfig     — attention entry point: the six SP
                                strategies over a mesh of virtual ranks
  resolve_layout              — the (P_u x P_r) plan of a mesh
  reference_attention         — single-device oracle
  decode_attention            — flash-decoding over a KV cache sharded on L
                                over the SP ranks (core/decode.py)
  plan / SPPlan               — the paper's §4.2 topology planner (copy)
  plan_hybrid / HybridPlan    — (cfg, pp, P_u, P_r) hybrid planner (copy)
  PipelineConfig / KVState    — displaced patch pipelining (core/pipefusion.py:
                                the schedule helpers, displaced_attention
                                through K1, kv_drift)
  comm_model, calibration     — analytical latency model and its fitter (copies)
"""
from .decode import decode_attention
from .pipefusion import (
    KVState,
    PipelineConfig,
    displaced_attention,
    init_kv_state,
    kv_drift,
)
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
from .strategy import STRATEGIES, SPConfig, resolve_layout, sp_attention

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
    "decode_attention",
    "displaced_attention",
    "empty_partial",
    "finalize",
    "init_kv_state",
    "kv_drift",
    "merge",
    "plan",
    "plan_for_shape",
    "plan_hybrid",
    "reference_attention",
    "resolve_layout",
    "sp_attention",
    "usp_plan",
]
