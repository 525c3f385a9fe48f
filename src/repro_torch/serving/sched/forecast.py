"""Per-bucket arrival forecasting (DESIGN.md §10; ROADMAP "Scheduler
preemption / arrival forecasting").

The PR-3 admission policy defers a padded batch while its deadline slack
exceeds ``defer_slack`` — an *open-ended* wait justified only by the hope
that more same-bucket arrivals show up before ``flush``.  The
``ArrivalForecaster`` turns that hope into an estimate: it tracks an EWMA
of each bucket's interarrival gap and the gap's variance, and answers
"how long until this bucket's next ``k`` arrivals?".  The admission
policy then defers a padded candidate **only** while the forecast fill
time (plus a variance safety term) fits inside the candidate's slack —
an explicit, slack-aware deferral horizon instead of wait-until-flush.

All state is host-side floats keyed by latent length; ``observe`` is
called once per ``RequestScheduler.submit``.  No wall-clock reads happen
here — every method takes ``now`` from the caller, so the deterministic
replay harness (benchmarks/sched_sweep.py) drives it on simulated time.
"""
from __future__ import annotations

import dataclasses
import math

from ..metrics import Tracker


@dataclasses.dataclass
class BucketRate:
    """EWMA interarrival statistics of one bucket."""

    last_arrival: float
    mean_gap: float = 0.0
    var_gap: float = 0.0
    n: int = 1  # arrivals observed (gaps observed = n - 1)

    @property
    def rate(self) -> float:
        """Smoothed arrivals per second (0 until two arrivals seen)."""
        if self.n < 2 or self.mean_gap <= 0.0:
            return 0.0
        return 1.0 / self.mean_gap

    @property
    def std_gap(self) -> float:
        return math.sqrt(max(self.var_gap, 0.0))


class ArrivalForecaster:
    """EWMA per-bucket arrival-rate estimator.

    ``alpha`` is the EWMA weight of the newest gap; the variance uses the
    standard EW recursion ``var ← (1-α)·(var + α·(gap-mean)²)`` so bursty
    buckets carry a wide predictive interval and steady ones a tight one.
    """

    def __init__(self, alpha: float = 0.25,
                 tracker: Tracker | None = None,
                 idle_age: float | None = None):
        assert 0.0 < alpha <= 1.0, alpha
        assert idle_age is None or idle_age > 0.0, idle_age
        self.alpha = alpha
        # None = keep every bucket forever (the PR-5 behavior, fine for
        # bounded benchmark runs); a long-running server sets an idle age
        # so the per-latent-length map cannot grow without bound — one
        # ``BucketRate`` per distinct seq_len is a leak under adversarial
        # or long-tailed resolution mixes (ISSUE 9).  Eviction uses the
        # caller-supplied ``now`` only — no wall-clock reads here.
        self.idle_age = idle_age
        self.buckets: dict[int, BucketRate] = {}
        # metrics sink (DESIGN.md §11): the per-bucket rate estimate is
        # published on every update so a trace shows the forecast the
        # deferral horizon actually consulted
        self.tracker = tracker if tracker is not None else Tracker()

    def observe(self, seq_len: int, now: float) -> None:
        """Record one arrival (called on every submit)."""
        self.evict_idle(now)
        b = self.buckets.get(seq_len)
        if b is None:
            self.buckets[seq_len] = BucketRate(last_arrival=now)
            return
        gap = max(now - b.last_arrival, 0.0)
        if b.n == 1:
            b.mean_gap = gap
        else:
            delta = gap - b.mean_gap
            b.mean_gap += self.alpha * delta
            b.var_gap = (1.0 - self.alpha) * (
                b.var_gap + self.alpha * delta * delta)
        b.last_arrival = now
        b.n += 1
        self.tracker.log("forecast.mean_gap_s", b.mean_gap,
                         tags={"seq": seq_len})

    def evict_idle(self, now: float) -> int:
        """Drop every bucket whose last arrival is more than ``idle_age``
        old; returns how many were evicted.  Called from every
        ``observe``, and directly by long-idle owners (the fleet tier's
        per-replica forecasters).  A dried-up bucket re-seeds from
        scratch on its next arrival — correct, since its old rate
        estimate carried no predictive value anyway (see
        ``expected_fill_time``'s dried-up-bucket note)."""
        if self.idle_age is None:
            return 0
        dead = [s for s, b in self.buckets.items()
                if now - b.last_arrival > self.idle_age]
        for s in dead:
            del self.buckets[s]
            self.tracker.count("forecast.evictions", tags={"seq": s})
        return len(dead)

    def rate(self, seq_len: int) -> float:
        b = self.buckets.get(seq_len)
        return b.rate if b is not None else 0.0

    def expected_fill_time(self, seq_len: int, k: int, now: float,
                           safety: float = 1.0) -> float | None:
        """Predicted seconds until ``k`` more requests of this bucket
        arrive, with a ``safety``-weighted standard-deviation margin.

        None = no estimate (fewer than two arrivals seen) — the caller
        falls back to the PR-3 wait-until-flush rule.  The first of the
        ``k`` arrivals is credited with the time already elapsed since
        the bucket's last arrival (a gap is partially "used up" while
        the candidate waits) — but once the current gap has OUTLIVED the
        estimate, the excess is evidence the rate has collapsed, and the
        projected wait grows with it: ``|mean_gap - elapsed|`` rises
        without bound for a dried-up bucket, so its padded candidates
        stop deferring as soon as the projection leaves the slack
        (admission.py ``_worth_deferring``) instead of stalling on an
        ever-"imminent" arrival.
        """
        if k <= 0:
            return 0.0
        b = self.buckets.get(seq_len)
        if b is None or b.n < 2 or b.mean_gap <= 0.0:
            return None
        elapsed = max(now - b.last_arrival, 0.0)
        first = abs(b.mean_gap - elapsed)
        t = first + (k - 1) * b.mean_gap
        return t + safety * b.std_gap * math.sqrt(k)
