"""Drift-triggered displaced-pipeline resync (DESIGN.md §9; ROADMAP item).

``PipelineConfig.resync_every`` re-syncs on a fixed period regardless of
how stale the displaced KV actually is.  ``DriftPolicy`` instead consumes
the per-request ``kv_drift`` trajectory the sampler surfaces
(``DiTResult.kv_drift``) and schedules a fully-synchronous step exactly
when a request's staleness crosses ITS threshold — a quality-SLA knob
carried per request (``DiTRequest.drift_threshold``), falling back to the
policy-wide default.

The decision uses the PREVIOUS step's drift (the current step's drift is
only known after running it), so a threshold crossing at step i triggers
the resync at step i+1; warm steps reset drift to zero.  Reading the
drift on the host costs one device sync per step — the price of closing
the loop; engines keep the sync-free static schedule when no threshold is
configured.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from ...core.pipefusion import PipelineConfig
from ..metrics import Tracker


@dataclasses.dataclass(frozen=True)
class DriftPolicy:
    """Threshold rule for when a displaced step must be replaced by a
    warm (fully-synchronous) one."""

    threshold: float | None = None  # default kv-drift bound per request

    def engaged(self, thresholds: Sequence[float | None]) -> bool:
        """Whether any request carries a bound (policy-wide or its own) —
        if not, the engine keeps the static, sync-free schedule."""
        return self.threshold is not None or any(
            t is not None for t in thresholds)

    def warm(self, pipe: PipelineConfig, step: int,
             last_drift: Sequence[float] | None,
             thresholds: Sequence[float | None],
             tracker: Tracker | None = None) -> bool:
        """Decide step ``step`` given the previous step's per-request
        drift (None = previous step was warm or this is the first).

        With a ``tracker`` (DESIGN.md §11) the threshold crossing that
        forces a resync is published as a ``drift.trigger`` gauge (the
        offending request's drift value, tagged with its batch row and
        the bound it crossed) — the trace shows WHY a warm step was
        scheduled, not just that one happened."""
        if step < pipe.warmup_steps:
            return True
        if last_drift is None:
            return False
        for j, (d, t) in enumerate(zip(last_drift, thresholds)):
            bound = t if t is not None else self.threshold
            if bound is not None and d > bound:
                if tracker is not None:
                    tracker.log("drift.trigger", d, step=step,
                                tags={"row": j, "bound": bound})
                return True
        return False
