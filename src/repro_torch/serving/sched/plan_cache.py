"""Per-bucket-shape plan selection and compiled-step memoization
(DESIGN.md §9).

Two caches, both keyed by the bucket shape (padded batch rows, latent
length):

  * **plan cache** — ``plan_hybrid`` candidates scored with the analytical
    comm model (``core.comm_model.plan_step_latency``) for THAT shape's
    workload; the TAS/Torus placement inside each candidate's SP sub-mesh
    is the planner's own (§4.2 rules are untouched).  For pipelined plans
    the patch count is co-selected: more patches shrink the fill bubble
    but must divide the latent length.
  * **step cache** — whatever the engine compiles for a shape (a jitted
    step function or a warm/displaced pair) is memoized with hit/miss
    counters, so bucket switches never re-trace: one trace per bucket
    shape, observable via ``traces``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from ...core.comm_model import LayerWorkload, NetworkModel, plan_step_latency
from ...core.planner import HybridPlan, candidate_hybrid_plans
from ..metrics import Tracker


class PlanChoice(NamedTuple):
    """The selected execution plan for one bucket shape."""

    hplan: HybridPlan
    num_patches: int  # 0 = not pipelined
    pred: dict  # comm-model breakdown for the chosen (plan, patches)
    t_step: float  # predicted seconds per sampler step
    t_batch: float  # t_step * num_steps — the admission policy's latency


class PlanCache:
    def __init__(self, *, n_machines: int = 1, m_per_machine: int = 1,
                 heads: int, head_dim: int, n_layers: int,
                 kv_heads: int | None = None, num_steps: int = 20,
                 guided: bool = True, guidance_branches: int = 2,
                 dp: int = 1, net: NetworkModel | None = None,
                 candidates: list[HybridPlan] | None = None,
                 base_patches: int = 0,
                 patch_multipliers: tuple[int, ...] = (1, 2, 4),
                 comm_backend: str = "xla",
                 a2a_wire_dtype: str | None = None,
                 tracker: Tracker | None = None):
        """``candidates`` fixes the plan set (the engine passes the single
        plan its mesh can execute; the benchmark passes None to enumerate
        every feasible (cfg, pp) split).  ``base_patches`` > 0 enables
        patch-count co-selection even for pp = 1 plans (single-stage
        displaced pipelining).  ``comm_backend`` is the channel lowering
        the engine will execute with ("pallas" = kernel-fused, DESIGN.md
        §8.1); candidate plans are scored under it, so the fused path's
        lower per-step issue cost is what the selection sees.  When the
        enumeration runs here (``candidates is None``) it includes the
        hierarchical-a2a variants of every qualifying multi-machine
        factorisation (DESIGN.md §8.2), scored per leg, so the cache
        chooses flat vs hierarchical per bucket shape;
        ``a2a_wire_dtype`` additionally opts the enumeration into the
        fp8-wire variants.
        ``tracker`` is the metrics sink hit/miss/invalidation counters are
        published to (DESIGN.md §11); None = a private aggregate-only
        ``Tracker`` so the counter attributes keep working standalone."""
        self.net = net or NetworkModel()
        self.heads = heads
        self.head_dim = head_dim
        self.kv_heads = kv_heads
        self.n_layers = n_layers
        self.num_steps = num_steps
        self.guided = guided
        self.guidance_branches = guidance_branches
        self.dp = max(dp, 1)
        self.base_patches = base_patches
        self.patch_multipliers = patch_multipliers
        self.comm_backend = comm_backend
        if candidates is None:
            candidates = candidate_hybrid_plans(
                n_machines, m_per_machine, heads, kv_heads, n_layers=n_layers,
                cfg_degree=max(guidance_branches, 2),
                comm_backend=comm_backend,
                a2a_wire_dtype=a2a_wire_dtype)
        self.candidates = list(candidates)
        assert self.candidates, "plan cache needs at least one candidate"
        self.plans: dict[tuple[int, int], PlanChoice] = {}
        self._steps: dict[tuple[int, int], Any] = {}
        # all counters live in the tracker (DESIGN.md §11); the legacy
        # names (hits/misses/plan_hits/plan_misses/invalidations) remain
        # as thin reads below.  Plan-score counters are separate from the
        # compiled-step ones: a recalibration invalidates SCORES
        # (plan_misses grow again) but never compiled steps.
        self.tracker = tracker if tracker is not None else Tracker()

    # -- tracker-backed counters (legacy attribute surface) ---------------
    # emissions are tagged per bucket shape; the legacy attributes are the
    # totals over every shape (counter_total), so no public API moved
    @property
    def hits(self) -> int:
        return int(self.tracker.counter_total("plan_cache.step_hit"))

    @property
    def misses(self) -> int:
        return int(self.tracker.counter_total("plan_cache.step_miss"))

    @property
    def plan_hits(self) -> int:
        return int(self.tracker.counter_total("plan_cache.plan_hit"))

    @property
    def plan_misses(self) -> int:
        return int(self.tracker.counter_total("plan_cache.plan_miss"))

    @property
    def invalidations(self) -> int:
        return int(self.tracker.counter("plan_cache.invalidation"))

    # -- plan selection ---------------------------------------------------
    def _patch_options(self, hplan: HybridPlan, seq: int) -> list[int]:
        base = hplan.pp if hplan.pp > 1 else self.base_patches
        if base <= 0:
            return [0]
        opts = sorted({base * m for m in self.patch_multipliers
                       if base * m <= seq and seq % (base * m) == 0})
        return opts or [base]

    def select(self, batch_rows: int, seq: int) -> PlanChoice:
        """Best (plan, patch count) for a bucket shape, memoized.

        ``batch_rows`` is the padded global batch; the scored workload is
        the per-replica slice (batch_rows / dp) each plan actually runs.
        """
        key = (batch_rows, seq)
        cached = self.plans.get(key)
        if cached is not None:
            self.tracker.count("plan_cache.plan_hit",
                               tags={"rows": batch_rows, "seq": seq})
            return cached
        self.tracker.count("plan_cache.plan_miss",
                           tags={"rows": batch_rows, "seq": seq})
        wl = LayerWorkload(batch=max(batch_rows // self.dp, 1), seq=seq,
                           heads=self.heads, head_dim=self.head_dim)
        best: PlanChoice | None = None
        for h in self.candidates:
            for np_ in self._patch_options(h, seq):
                pred = plan_step_latency(
                    h, wl, self.net, n_layers=self.n_layers,
                    guided=self.guided,
                    guidance_branches=self.guidance_branches,
                    num_patches=np_ or None, num_steps=self.num_steps,
                    comm_backend=self.comm_backend)
                t = pred["t_step"]
                if best is None or t < best.t_step:
                    best = PlanChoice(h, np_, pred, t, t * self.num_steps)
        assert best is not None
        self.plans[key] = best
        # the selection itself is telemetry: after a recalibration the
        # re-scored per-shape prediction shows up as a new gauge sample
        self.tracker.log("plan_cache.t_step_pred_s", best.t_step,
                         tags={"rows": batch_rows, "seq": seq,
                               "patches": best.num_patches})
        return best

    def recalibrate(self, net: NetworkModel) -> None:
        """Swap in a refitted NetworkModel and invalidate every cached
        plan SCORE (DESIGN.md §10): the next ``select`` per bucket shape
        re-scores candidates under the new model.  Compiled steps are NOT
        touched — a latency re-estimate never costs a retrace; only the
        patch-count/plan choice and the admission policy's predicted
        latencies move."""
        self.net = net
        self.plans.clear()
        self.tracker.count("plan_cache.invalidation")

    # -- compiled-step memoization ---------------------------------------
    def step_fn(self, batch_rows: int, seq: int, build: Callable[[], Any],
                variant: Any = None):
        """Return the compiled step artifact for a shape, building (and
        counting a trace) only on first use.  ``variant`` distinguishes
        compile-relevant plan attributes beyond the shape (the engine
        passes the selected patch count): after a ``recalibrate`` changes
        a bucket's plan choice, the new variant compiles lazily while the
        old one stays cached."""
        key = (batch_rows, seq) if variant is None else (batch_rows, seq,
                                                         variant)
        tags = {"rows": batch_rows, "seq": seq}
        if key in self._steps:
            self.tracker.count("plan_cache.step_hit", tags=tags)
        else:
            self.tracker.count("plan_cache.step_miss", tags=tags)
            # the build (trace + compile) is a span: bucket switches show
            # up on the host timeline as plan_cache.trace blocks, making
            # compile stalls distinguishable from slow steps (§12)
            with self.tracker.span("plan_cache.trace", tags=tags):
                self._steps[key] = build()
        return self._steps[key]

    @property
    def traces(self) -> int:
        """Distinct compilations so far — the 'one trace per bucket shape'
        acceptance metric."""
        return self.misses
