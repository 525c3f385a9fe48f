"""DiT serving in PyTorch: engine, sampler, metrics and request scheduler."""
from .engine import DiTRequest, DiTResult, DiTServer
from .metrics import JsonlTracker, NullTracker, RecordingTracker, Tracker
from .sampler import SamplerConfig, sample, sample_step

__all__ = [
    "DiTRequest",
    "DiTResult",
    "DiTServer",
    "JsonlTracker",
    "NullTracker",
    "RecordingTracker",
    "SamplerConfig",
    "Tracker",
    "sample",
    "sample_step",
]
