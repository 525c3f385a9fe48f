"""Resolution bucketing for the DiT request scheduler (DESIGN.md §9).

Requests are grouped by latent sequence length into per-bucket FIFO
queues.  SP requires a uniform sequence per batch, so a batch NEVER mixes
buckets — bucketing removes cross-resolution padding entirely; the only
padding left is the data-parallel divisibility pad (whole rows), which the
bucketer accounts per admission so the admission policy can trade it off
against deadline slack.

The aging helpers here are shared with ``ARServer`` slot admission: an
aged priority grows linearly with queue age, so any waiting request's
effective priority eventually exceeds every fixed base priority — that is
the starvation bound both engines rely on.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable


def aged_priority(base: float, age: float, rate: float) -> float:
    """Effective priority of a request that has waited ``age`` units.

    Monotone in age: with ``rate`` > 0 a request of base priority ``p``
    overtakes base priority ``q`` after ``(q - p) / rate`` units — the
    anti-starvation guarantee.
    """
    return base + age * rate


def padded_rows(k: int, dp: int) -> int:
    """Rows of data-parallel padding a batch of ``k`` real requests needs
    (SPMD batch sharding requires divisibility by the dp degree)."""
    if dp <= 1:
        return 0
    return -(-k // dp) * dp - k


def deadline_of(req) -> float | None:
    """Absolute deadline of a request carrying a relative ``sla`` (seconds
    from submission); None = best-effort."""
    sla = getattr(req, "sla", None)
    if sla is None:
        return None
    return req.submitted + sla


@dataclasses.dataclass
class BucketStats:
    batches: int = 0
    admitted: int = 0
    padded_rows: int = 0
    padded_token_work: int = 0  # padded rows x latent tokens each
    real_token_work: int = 0
    max_wait: float = 0.0  # worst queue age observed at admission


class Bucket:
    """FIFO queue of same-latent-length requests plus its accounting."""

    def __init__(self, seq_len: int):
        self.seq_len = seq_len
        self.q: deque = deque()
        self.stats = BucketStats()

    def __len__(self) -> int:
        return len(self.q)

    def oldest_age(self, now: float) -> float:
        if not self.q:
            return 0.0
        return max(0.0, now - self.q[0].submitted)

    def min_slack(self, now: float, batch_latency: float, k: int,
                  default: float) -> float:
        """Tightest (deadline - now - predicted latency) among the ``k``
        oldest requests; requests without an SLA contribute ``default``."""
        slack = default
        for i, r in enumerate(self.q):
            if i >= k:
                break
            d = deadline_of(r)
            if d is not None:
                slack = min(slack, d - now - batch_latency)
        return slack

    def push_front(self, reqs: list, pad_rows: int = 0) -> None:
        """Return preempted requests to the head of the queue in their
        original order, WITHOUT touching ``submitted`` — a parked request
        keeps its accrued starvation age (preemption invariant (a),
        tests/test_sched_control.py).

        The admission accounting ``pop`` recorded is reversed (the batch
        did not complete; its eventual re-admission re-accounts it), so
        ``BucketStats`` never double-counts a parked batch.  ``max_wait``
        is deliberately NOT reversed: the wait observed at the first
        admission really happened."""
        for r in reversed(reqs):
            self.q.appendleft(r)
        st = self.stats
        st.batches -= 1
        st.admitted -= len(reqs)
        st.padded_rows -= pad_rows
        st.padded_token_work -= pad_rows * self.seq_len
        st.real_token_work -= len(reqs) * self.seq_len

    def pop(self, k: int, now: float, dp: int) -> list:
        """Admit the ``k`` oldest requests and account the padding the
        admission implies."""
        assert 0 < k <= len(self.q), (k, len(self.q))
        out = [self.q.popleft() for _ in range(k)]
        pad = padded_rows(k, dp)
        st = self.stats
        st.batches += 1
        st.admitted += k
        st.padded_rows += pad
        st.padded_token_work += pad * self.seq_len
        st.real_token_work += k * self.seq_len
        st.max_wait = max(st.max_wait,
                          max(now - r.submitted for r in out))
        return out


class Bucketer:
    """Per-latent-length bucket queues with padding/starvation accounting."""

    def __init__(self):
        self.buckets: dict[int, Bucket] = {}

    def add(self, req) -> None:
        b = self.buckets.get(req.seq_len)
        if b is None:
            b = self.buckets[req.seq_len] = Bucket(req.seq_len)
        b.q.append(req)

    def requeue(self, reqs: list, pad_rows: int = 0) -> None:
        """Re-enqueue a preempted batch at the front of its bucket,
        oldest first, with accrued ages intact and its admission
        accounting reversed.

        Batches NEVER mix buckets (SP needs one latent length per batch),
        so a preempted batch's requests all share one seq_len — that
        invariant is asserted here rather than papered over: the old code
        silently zeroed ``pad_rows`` for a multi-bucket list, which would
        mis-account padding with no signal if the invariant ever broke."""
        if not reqs:
            assert pad_rows == 0, (
                f"requeue of an empty batch cannot carry {pad_rows} pad rows")
            return
        by_seq: dict[int, list] = {}
        for r in reqs:
            by_seq.setdefault(r.seq_len, []).append(r)
        assert len(by_seq) == 1, (
            f"requeued batch mixes buckets {sorted(by_seq)}: batches never "
            f"mix buckets, so a preempted batch must be single-bucket")
        ((seq, rs),) = by_seq.items()
        b = self.buckets.get(seq)
        if b is None:
            b = self.buckets[seq] = Bucket(seq)
        b.push_front(rs, pad_rows)

    def drain(self) -> list:
        """Evacuate every queued (not-yet-admitted) request — what a
        failed fleet replica hands back to the router for re-dispatch
        (serving/fleet.py).  Global FIFO by submission time, ``submitted``
        untouched (accrued age survives the failover, same invariant as
        ``requeue``).  Admission accounting is NOT reversed: queued
        requests were never admitted, so there is nothing to reverse."""
        out: list = []
        for b in self.buckets.values():
            out.extend(b.q)
            b.q.clear()
        out.sort(key=lambda r: r.submitted)
        return out

    @property
    def pending(self) -> int:
        return sum(len(b) for b in self.buckets.values())

    def nonempty(self) -> Iterable[Bucket]:
        # deterministic order: insertion order of first appearance
        return [b for b in self.buckets.values() if len(b)]

    # -- aggregated accounting -------------------------------------------
    def totals(self) -> BucketStats:
        t = BucketStats()
        for b in self.buckets.values():
            s = b.stats
            t.batches += s.batches
            t.admitted += s.admitted
            t.padded_rows += s.padded_rows
            t.padded_token_work += s.padded_token_work
            t.real_token_work += s.real_token_work
            t.max_wait = max(t.max_wait, s.max_wait)
        return t
