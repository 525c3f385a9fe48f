"""NetworkModel least-squares calibration (DESIGN.md §10).

The damped Gauss-Newton fitter that used to live inside
``scripts/calibrate_comm.py`` (PR 3), refactored into an importable
module so the offline CLI and the serving engine's ``OnlineCalibrator``
(serving/sched/control.py) share one implementation: the script fits
recorded ``BENCH_*.json`` records in one shot, the engine refits a
sliding window of its own measured step times in-flight.

Method: Gauss-Newton with Levenberg damping on **log-parameters** with
log-ratio residuals ``log(pred/measured)`` (numpy only — no scipy in the
container).  Log space keeps every parameter positive and makes the fit
scale-free across the many orders of magnitude between bandwidths and
hop latencies; the damping keeps parameters the observations cannot
identify (e.g. intra_bw when every record models intra traffic as
overlapped, or hop latencies in bandwidth-bound configs) pinned near
their starting value instead of wandering.

The fitter is generic over the observation type: ``fit`` takes any
sequence of observations plus a ``predict(obs, net) -> µs`` callable, so
the script's dict records and the engine's (plan, workload, measurement)
tuples go through the same solver.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

from .comm_model import FIT_PARAMS, NetworkModel, fit_param_ratios

__all__ = ["FIT_PARAMS", "FitReport", "fit", "net_from_log_params"]


def net_from_log_params(theta: np.ndarray,
                        base: NetworkModel | None = None) -> NetworkModel:
    """NetworkModel with FIT_PARAMS set from log-space ``theta`` (other
    fields keep ``base``'s values)."""
    return dataclasses.replace(
        base if base is not None else NetworkModel(),
        **{k: float(math.exp(v)) for k, v in zip(FIT_PARAMS, theta)})


@dataclasses.dataclass(frozen=True)
class FitReport:
    n_obs: int
    rms_rel_error: float
    ratio_vs_nominal: dict[str, float]

    def as_dict(self) -> dict:
        # legacy key names kept for calibration JSON / test compatibility
        return {"n_records": self.n_obs,
                "rms_rel_error": self.rms_rel_error,
                "ratio_vs_nominal": dict(self.ratio_vs_nominal)}


def fit(obs: Sequence, predict_us: Callable[[object, NetworkModel], float],
        *, start: NetworkModel | None = None, iters: int = 40,
        damping: float = 1e-3, fd_eps: float = 1e-5
        ) -> tuple[NetworkModel, FitReport]:
    """Least-squares fit of FIT_PARAMS to measured observations.

    Every observation must expose its measurement via
    ``obs.measured_step_us`` or ``obs["measured_step_us"]``; the model's
    prediction for it comes from ``predict_us(obs, net)``.  ``start`` is
    the damping anchor and initial iterate (nominal by default) — the
    online calibrator passes its current fitted model so successive
    refits walk from the last estimate rather than re-fitting from
    nominal every time.
    """
    assert obs, "no observations with a fit target — nothing to fit"

    def measured(o) -> float:
        if isinstance(o, dict):
            return o["measured_step_us"]
        return o.measured_step_us

    base = start if start is not None else NetworkModel()
    theta = np.array([math.log(getattr(base, k)) for k in FIT_PARAMS])

    def residuals(th: np.ndarray) -> np.ndarray:
        net = net_from_log_params(th, base)
        return np.array([
            math.log(predict_us(o, net) / measured(o)) for o in obs])

    r = residuals(theta)
    for _ in range(iters):
        jac = np.empty((len(obs), len(theta)))
        for j in range(len(theta)):
            t2 = theta.copy()
            t2[j] += fd_eps
            jac[:, j] = (residuals(t2) - r) / fd_eps
        a = np.vstack([jac, math.sqrt(damping) * np.eye(len(theta))])
        b = np.concatenate([-r, np.zeros(len(theta))])
        step, *_ = np.linalg.lstsq(a, b, rcond=None)
        if not np.all(np.isfinite(step)):
            break
        theta = theta + step
        r = residuals(theta)
        if np.linalg.norm(step) < 1e-10:
            break
    net = net_from_log_params(theta, base)
    report = FitReport(
        n_obs=len(obs),
        rms_rel_error=float(math.sqrt(float(np.mean(r ** 2)))),
        ratio_vs_nominal=fit_param_ratios(net))
    return net, report
