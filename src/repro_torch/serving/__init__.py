"""Serving in PyTorch: the DiT and AR engines, sampler, metrics and request
scheduler."""
from .engine import ARRequest, ARServer, DiTRequest, DiTResult, DiTServer, Slot
from .metrics import JsonlTracker, NullTracker, RecordingTracker, Tracker
from .sampler import SamplerConfig, sample, sample_step

__all__ = [
    "ARRequest",
    "ARServer",
    "DiTRequest",
    "DiTResult",
    "DiTServer",
    "JsonlTracker",
    "NullTracker",
    "RecordingTracker",
    "SamplerConfig",
    "Slot",
    "Tracker",
    "sample",
    "sample_step",
]
