"""Adaptive serving control loop (DESIGN.md §10): step-level preemption
and online comm-model recalibration.

Two feedback paths close the loop between the engine's measured behavior
and the planning stack built in PRs 1-4:

  * **PreemptionPolicy** — DiT sampler steps are natural preemption
    points (PipeFusion: the KV state is per-batch and disposable).
    Between steps the engine compares the running batch's predicted
    remaining time (``remaining_steps × t_step``, with ``t_step`` taken
    from the batch's own measured steps) against the tightest waiting
    candidate's deadline slack.  When a waiting bucket would miss its SLA
    if the running batch ran to completion — but can still make it if
    served now — the running batch is *parked*: its requests return to
    the head of their bucket with accrued age intact and its KV state is
    dropped (the batch restarts from scratch on re-admission).

  * **OnlineCalibrator** — the engine's measured per-step wall clocks are
    fed back through the shared damped Gauss-Newton fitter
    (core/calibration.py, the same solver ``scripts/calibrate_comm.py``
    runs offline) over a sliding window, so the ``NetworkModel`` the
    admission policy and plan cache score with tracks the deployed
    hardware.  When the refit drifts past a threshold ratio on any fitted
    parameter, the plan cache's SCORES are invalidated
    (``PlanCache.recalibrate``) — compiled steps are never retraced.

Both are pure host-side decision logic: no jax imports, every method
takes ``now`` from the caller, so the deterministic replay harness
(benchmarks/sched_sweep.py ``--replay``) exercises the exact code the
engine runs.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Sequence

from ...core import calibration
from ...core.comm_model import (
    LayerWorkload,
    NetworkModel,
    fit_param_ratios,
    plan_step_latency,
)
from ..metrics import Tracker
from .admission import Candidate
from .plan_cache import PlanCache, PlanChoice


def steady_t_step(step_times_s: Sequence[float]) -> float | None:
    """Trace-robust per-step estimate from one batch's measured wall
    clocks: the median of the steps AFTER the first (a fresh bucket
    shape's first step pays its jit trace, which later steps never
    re-pay), the lone sample when only one exists, None when empty.
    Shared by the preemption check and the online calibrator so both
    consume the same estimate."""
    if not step_times_s:
        return None
    if len(step_times_s) > 1:
        return statistics.median(step_times_s[1:])
    return step_times_s[0]


# ---------------------------------------------------------------------------
# step-level preemption
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PreemptionPolicy:
    """Decision rule for parking a running batch between sampler steps.

    A waiting candidate triggers preemption iff it is *salvageable but
    doomed by waiting*:

        0 ≤ min_slack  and  min_slack < remaining_steps·t_step − margin

    i.e. served right now it still meets its deadline, but after the
    running batch finishes it will not.  Two guards bound the disruption:

      * ``min_remaining_steps`` — a batch about to finish is never parked
        (a restart costs the full step count; saving one step's latency
        cannot justify it).
      * a running batch that is itself overdue (its admission age crossed
        ``starvation_age``) is immune — so a parked batch that has aged
        past the bound runs to completion, which is what carries the PR-3
        hard starvation bound through preemption (invariant (b),
        tests/test_sched_control.py).
    """

    min_remaining_steps: int = 2
    margin: float = 0.0  # extra slack (s) the waiting side must lack

    def should_preempt(self, candidates: Sequence[Candidate], *,
                       remaining_steps: int, t_step: float,
                       running_age: float, starvation_age: float,
                       running_seq: int | None = None,
                       running_k: int = 0,
                       max_batch: int | None = None) -> Candidate | None:
        """The candidate worth parking the running batch for (the
        tightest-slack one), or None.

        A candidate from the running batch's OWN bucket (``running_seq``)
        is considered only when the parked requests and the candidate's
        fit into one batch (``running_k + k ≤ max_batch``): the parked
        batch re-enters at the bucket head, so otherwise the re-admission
        just re-serves the parked requests and the trigger re-fires —
        futile park/restart thrash with zero SLA benefit."""
        if remaining_steps < self.min_remaining_steps:
            return None
        if running_age >= starvation_age:
            return None  # overdue batches are immune (starvation bound)
        t_rem = remaining_steps * t_step

        def useful(c: Candidate) -> bool:
            if not 0.0 <= c.min_slack < t_rem - self.margin:
                return False
            if (running_seq is not None and c.bucket is not None
                    and c.bucket.seq_len == running_seq):
                return max_batch is not None and running_k + c.k <= max_batch
            return True

        crit = [c for c in candidates if useful(c)]
        if not crit:
            return None
        return min(crit, key=lambda c: c.min_slack)


# ---------------------------------------------------------------------------
# online comm-model recalibration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    min_samples: int = 8  # observations before the first refit
    window: int = 64  # sliding window of recent observations fitted
    refit_every: int = 8  # new observations between refit attempts
    # any fitted parameter moving past this ratio (either direction) vs
    # the model the plan cache currently scores with invalidates scores
    drift_ratio: float = 1.15
    iters: int = 25  # Gauss-Newton iterations per refit (online budget)
    damping: float = 1e-3


@dataclasses.dataclass(frozen=True)
class StepObservation:
    """One served batch's measured step latency plus everything needed to
    re-predict it under a trial NetworkModel."""

    choice: PlanChoice
    wl: LayerWorkload
    measured_step_us: float


class OnlineCalibrator:
    """Sliding-window refit of the plan cache's NetworkModel from the
    engine's own measured per-step wall clocks (DESIGN.md §10)."""

    def __init__(self, plan_cache: PlanCache,
                 cfg: CalibrationConfig = CalibrationConfig(),
                 tracker: Tracker | None = None):
        self.cfg = cfg
        self.plans = plan_cache
        self.net = plan_cache.net  # latest fit (pushed to plans on drift)
        self.obs: list[StepObservation] = []
        self._since_refit = 0
        self.last_ratios: dict[str, float] = {}
        # metrics sink (DESIGN.md §11): refit/recalibration counters plus
        # the per-parameter drift-ratio trajectory; shares the plan
        # cache's sink unless given its own
        self.tracker = tracker if tracker is not None else plan_cache.tracker

    # -- tracker-backed counters (legacy attribute surface) ---------------
    @property
    def refits(self) -> int:
        return int(self.tracker.counter("calibration.refits"))

    @property
    def recalibrations(self) -> int:
        """Refits that crossed the drift threshold."""
        return int(self.tracker.counter("calibration.recalibrations"))

    def _predict_us(self, o: StepObservation, net: NetworkModel) -> float:
        pc = self.plans
        pred = plan_step_latency(
            o.choice.hplan, o.wl, net, n_layers=pc.n_layers,
            guided=pc.guided, guidance_branches=pc.guidance_branches,
            num_patches=o.choice.num_patches or None,
            num_steps=pc.num_steps, comm_backend=pc.comm_backend)
        return pred["t_step"] * 1e6

    def observe(self, choice: PlanChoice, batch_rows: int, seq: int,
                step_times_s: Sequence[float]) -> bool:
        """Feed one batch's measured per-step wall clocks (seconds).

        The fit target is the median of the steps AFTER the first: a
        fresh bucket shape's first step pays its jit trace, and with few
        sampler steps the plain median would still be polluted by it
        (for already-compiled batches, dropping one typical sample is
        harmless).  Returns True when this observation triggered a refit
        that crossed the drift threshold (plan-cache scores were
        invalidated)."""
        t = steady_t_step(step_times_s)
        if t is None:
            return False
        wl = LayerWorkload(batch=max(batch_rows // self.plans.dp, 1),
                           seq=seq, heads=self.plans.heads,
                           head_dim=self.plans.head_dim)
        self.obs.append(StepObservation(choice, wl, t * 1e6))
        if len(self.obs) > self.cfg.window:
            del self.obs[:len(self.obs) - self.cfg.window]
        self._since_refit += 1
        self.tracker.log("calibration.measured_step_us", t * 1e6,
                         tags={"rows": batch_rows, "seq": seq})
        return self._maybe_refit()

    def _maybe_refit(self) -> bool:
        c = self.cfg
        if len(self.obs) < c.min_samples or self._since_refit < c.refit_every:
            return False
        self._since_refit = 0
        # the refit is a host-timeline span: Gauss-Newton iterations are
        # real milliseconds between steps, and the profiler report should
        # attribute them to the control loop, not the sampler (§12)
        with self.tracker.span("calibration.refit",
                               tags={"samples": len(self.obs)}):
            self.net, _report = calibration.fit(
                self.obs, self._predict_us, start=self.net, iters=c.iters,
                damping=c.damping)
        refit_no = int(self.tracker.count("calibration.refits"))
        self.last_ratios = fit_param_ratios(self.net, self.plans.net)
        for param, r in self.last_ratios.items():
            self.tracker.log("calibration.drift_ratio", r, step=refit_no,
                             tags={"param": param})
        drifted = any(r > c.drift_ratio or r < 1.0 / c.drift_ratio
                      for r in self.last_ratios.values())
        if drifted:
            self.plans.recalibrate(self.net)
            self.tracker.count("calibration.recalibrations")
        return drifted


# ---------------------------------------------------------------------------
# engine-facing bundle
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """What the adaptive control loop of a ``DiTServer`` runs with.

    The default (all None/False) is the PR-3 open-loop scheduler; each
    member can be enabled independently.  ``forecast`` also changes the
    admission policy's padded-batch deferral from wait-until-flush to the
    forecaster's explicit horizon (sched/forecast.py)."""

    preemption: PreemptionPolicy | None = None
    calibration: CalibrationConfig | None = None
    forecast: bool = False
    forecast_alpha: float = 0.25  # EWMA weight of the newest gap

    @property
    def engaged(self) -> bool:
        """Whether the engine must measure per-step wall clocks (either
        feedback path consumes them)."""
        return self.preemption is not None or self.calibration is not None
