"""SLA-aware request scheduling for DiT serving (DESIGN.md §9/§10).

Resolution-bucketed continuous batching: a bucketer groups requests by
latent length, an admission policy scores (bucket, batch-size) candidates
with the analytical comm model against per-request SLAs, a plan cache
selects and memoizes one ``plan_hybrid`` execution plan (and compiled
step) per bucket shape, and a drift policy turns the displaced pipeline's
``kv_drift`` signal into threshold-triggered resyncs.

The adaptive control loop (DESIGN.md §10) closes three feedback paths on
top: an ``ArrivalForecaster`` bounds padded-batch deferral with an
explicit per-bucket horizon, a ``PreemptionPolicy`` can park a running
batch between sampler steps for an SLA-critical bucket, and an
``OnlineCalibrator`` refits the comm model from measured step times,
invalidating plan-cache scores when the fit drifts.
"""
from .admission import AdmissionPolicy, Candidate, SchedConfig
from .bucketer import (
    Bucket,
    Bucketer,
    BucketStats,
    aged_priority,
    deadline_of,
    padded_rows,
)
from .control import (
    CalibrationConfig,
    ControlConfig,
    OnlineCalibrator,
    PreemptionPolicy,
    StepObservation,
    steady_t_step,
)
from .drift import DriftPolicy
from .forecast import ArrivalForecaster, BucketRate
from .plan_cache import PlanCache, PlanChoice
from .scheduler import Admission, RequestScheduler
from ..metrics import (
    SCHEMA_VERSION,
    JsonlTracker,
    NullTracker,
    Record,
    RecordingTracker,
    Tracker,
)

__all__ = [
    "Admission",
    "AdmissionPolicy",
    "ArrivalForecaster",
    "Bucket",
    "Bucketer",
    "BucketRate",
    "BucketStats",
    "CalibrationConfig",
    "Candidate",
    "ControlConfig",
    "DriftPolicy",
    "JsonlTracker",
    "NullTracker",
    "OnlineCalibrator",
    "PlanCache",
    "PlanChoice",
    "PreemptionPolicy",
    "Record",
    "RecordingTracker",
    "RequestScheduler",
    "SCHEMA_VERSION",
    "SchedConfig",
    "StepObservation",
    "Tracker",
    "aged_priority",
    "deadline_of",
    "padded_rows",
    "steady_t_step",
]
