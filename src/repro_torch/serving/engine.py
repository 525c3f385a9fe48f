"""DiT serving engine.

DiTServer — the paper's scenario: requests ask for an image at a given
latent sequence length; the SLA-aware request scheduler (serving/sched)
buckets them by latent length, admits across buckets against per-request
deadlines, and memoizes one step function per bucket shape; the
flow-matching sampler runs every attention through the flash_mqkv kernel
and results stream back.

Not ported yet: the pipelined (displaced patch) sampler and the span
profiler (ROADMAP Queue 1 items 5 and 9), and ARServer (item 11).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..core import SPConfig, plan_hybrid
from ..core.comm_model import NetworkModel
from ..models import ParallelContext, resolve_device, torch_dtype
from ..models.dit import COND_TOKENS, LATENT_CHANNELS
from .metrics import Tracker
from .sampler import SamplerConfig, sample_step, sync
from .sched import (
    ArrivalForecaster,
    ControlConfig,
    OnlineCalibrator,
    PlanCache,
    PlanChoice,
    RequestScheduler,
    SchedConfig,
    steady_t_step,
)


@dataclasses.dataclass
class DiTRequest:
    rid: int
    seq_len: int  # latent tokens (resolution / duration proxy)
    cond: torch.Tensor | None = None  # [COND_TOKENS, d] text embedding (stub)
    submitted: float = 0.0
    # SLA: seconds from submission to deadline; None = best-effort
    sla: float | None = None
    # times this request's batch was parked by the preemption policy
    preemptions: int = 0


@dataclasses.dataclass
class DiTResult:
    rid: int
    latents: torch.Tensor
    latency: float
    sampling_steps: int
    # whether the request's deadline (submitted + sla) was met
    sla_met: bool = True
    # per-step wall clocks of the final run of this request's batch (empty
    # unless the step loop is measured)
    step_times: list[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0


class DiTServer:
    """Batched DiT sampling on one device.

    ``submit`` feeds the bucketer, ``run_once`` asks the admission policy
    for the next (bucket, batch) under SLA/starvation rules, and step
    functions come from the plan cache (one build per bucket shape, with
    hit/miss counters).  ``device`` defaults to CUDA and raises without
    it; ``params`` must already live on that device.
    """

    # noise is drawn per REQUEST from a generator seeded by
    # (_NOISE_SEED, rid), so a request's trajectory is independent of batch
    # composition and admission order: a parked batch's restart and an
    # unpreempted rerun give bitwise-identical latents
    _NOISE_SEED = 0
    # salt for dp padding rows' noise seeds (disjoint from request ids)
    _PAD_NOISE_SALT = 1 << 30

    def __init__(self, params, cfg: ModelConfig, sp: SPConfig,
                 sampler: SamplerConfig = SamplerConfig(),
                 max_batch: int = 4,
                 sched: SchedConfig | None = None,
                 net: NetworkModel | None = None,
                 control: ControlConfig | None = None,
                 tracker: Tracker | None = None,
                 profile: bool = False,
                 device: str | torch.device | None = None):
        if sampler.pipelined:
            raise NotImplementedError(
                "pipelined serving (displaced patch pipeline) is not ported "
                "yet: ROADMAP Queue 1 item 5")
        if profile:
            raise NotImplementedError(
                "span profiling is not ported yet: ROADMAP Queue 1 item 9")
        self.device = resolve_device(device)
        w = params["proj_in"]["w"]
        if w.device.type != self.device.type:
            raise ValueError(f"params are on {w.device}, server on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.ctx = ParallelContext(sp, "prefill", self.device)
        self.sampler = sampler
        self.tracker = tracker if tracker is not None else Tracker()
        self.control = control if control is not None else ControlConfig()
        # instrumentation hook: on_step(server, step_index) after every
        # completed sampler step, before the preemption check
        self.on_step: Callable[[DiTServer, int], None] | None = None

        dp = 1
        sched = sched if sched is not None else SchedConfig(max_batch=max_batch)
        self.sched_cfg = dataclasses.replace(sched, dp=dp)
        cfg_deg = (sampler.cfg_degree
                   if (sampler.guided and sampler.cfg_parallel) else 1)
        sp_deg = self.ctx.sp_degree
        # the one plan this device can execute, as in the reference
        fixed = plan_hybrid(1, cfg_deg * sp_deg, cfg.n_heads,
                            cfg.n_kv_heads, cfg_parallel=cfg_deg > 1,
                            cfg_degree=max(cfg_deg, 2), pp=1,
                            n_layers=cfg.n_layers)
        self.plan_cache = PlanCache(
            heads=cfg.n_heads, head_dim=cfg.resolved_head_dim,
            kv_heads=cfg.n_kv_heads, n_layers=cfg.n_layers,
            num_steps=sampler.num_steps, guided=sampler.guided,
            guidance_branches=sampler.cfg_degree, dp=dp, net=net,
            candidates=[fixed], base_patches=0, tracker=self.tracker)
        forecaster = (ArrivalForecaster(self.control.forecast_alpha,
                                        tracker=self.tracker)
                      if self.control.forecast else None)
        self.scheduler = RequestScheduler(self.plan_cache, self.sched_cfg,
                                          forecaster=forecaster,
                                          tracker=self.tracker)
        self.preempt = self.control.preemption
        self.calibrator = (OnlineCalibrator(self.plan_cache,
                                            self.control.calibration,
                                            tracker=self.tracker)
                           if self.control.calibration is not None else None)

    @property
    def preemptions(self) -> int:
        """Batches parked (not requests)."""
        return int(self.tracker.counter("engine.preemptions"))

    def submit(self, req: DiTRequest) -> None:
        self.scheduler.submit(req, time.time())

    @property
    def pending(self) -> int:
        return self.scheduler.pending

    def _step_fn(self, batch: int, seq: int, choice: PlanChoice) -> Callable:
        """The bucket's step function, memoized by the plan cache (one
        build per bucket shape; eager PyTorch compiles nothing)."""
        sc = self.sampler

        def build():
            dt = 1.0 / sc.num_steps

            def f(params, x, cond, t):
                return sample_step(params, self.cfg, self.ctx, x, cond, t,
                                   dt, sc)

            return f

        return self.plan_cache.step_fn(batch, seq, build,
                                       variant=choice.num_patches)

    def _noise(self, batch: list[DiTRequest], b: int, t: int) -> torch.Tensor:
        """Initial latent noise, drawn per ROW from a generator seeded by
        (_NOISE_SEED, rid) (pad rows: (_NOISE_SEED, salt + row index))."""
        rows = []
        for i in range(b):
            key = batch[i].rid if i < len(batch) else self._PAD_NOISE_SALT + i
            g = torch.Generator(device=self.device)
            g.manual_seed((self._NOISE_SEED << 32) | key)
            rows.append(torch.randn((t, LATENT_CHANNELS), generator=g,
                                    dtype=self.dtype, device=self.device))
        return torch.stack(rows)

    def _park(self, adm, adm_id: int, step: int) -> None:
        """Preempt the running batch: requests return to the head of their
        bucket with accrued age intact; partial latents are dropped."""
        for r in adm.requests:
            r.preemptions += 1
        self.scheduler.requeue(adm.requests, adm.pad_rows)
        self.tracker.count("engine.preemptions")
        self.tracker.log("engine.park", float(step), step=step,
                         tags={"adm": adm_id, "seq": adm.seq_len,
                               "rids": ",".join(str(r.rid)
                                                for r in adm.requests)})

    def _should_park(self, adm, step: int, num_steps: int,
                     step_times: list[float]) -> bool:
        """The between-steps preemption check: the running batch's
        remaining time is estimated from its own measured steps."""
        if self.preempt is None or step >= num_steps - 1:
            return False
        now = time.time()
        measured = steady_t_step(step_times)
        t_est = measured if measured is not None else adm.plan.t_step
        oldest = min(r.submitted for r in adm.requests)
        victim = self.preempt.should_preempt(
            self.scheduler.waiting_candidates(now),
            remaining_steps=num_steps - 1 - step, t_step=t_est,
            running_age=now - oldest,
            starvation_age=self.sched_cfg.starvation_age,
            running_seq=adm.seq_len, running_k=len(adm.requests),
            max_batch=self.sched_cfg.max_batch)
        return victim is not None

    @torch.inference_mode()
    def run_once(self, flush: bool = True) -> list[DiTResult]:
        """Serve one scheduler admission.  With the control loop engaged
        or a persistent tracker, each sampler step is waited on and
        wall-clocked individually and the preemption policy runs between
        steps (a parked batch returns [] and its requests re-enter the
        queue)."""
        adm = self.scheduler.next_batch(time.time(), flush=flush)
        if adm is None:
            return []
        adm_id = self.scheduler.admissions
        batch = adm.requests
        n_real = len(batch)
        b = adm.batch_rows
        t = adm.seq_len
        d = self.cfg.d_model
        sc = self.sampler
        cond = torch.stack([
            (batch[i].cond.to(device=self.device, dtype=self.dtype)
             if i < n_real and batch[i].cond is not None
             else torch.zeros((COND_TOKENS, d), dtype=self.dtype,
                              device=self.device))
            for i in range(b)
        ])
        x = self._noise(batch, b, t)
        fn = self._step_fn(b, t, adm.plan)
        dt = 1.0 / sc.num_steps
        measure = self.control.engaged or self.tracker.persistent
        step_tags = {"adm": adm_id, "seq": t, "rows": b}
        step_times: list[float] = []

        parked = False
        for i in range(sc.num_steps):
            t0 = time.perf_counter()
            x = fn(self.params, x, cond, 1.0 - i * dt)
            if measure:
                sync(self.device)
                t_step = time.perf_counter() - t0
                step_times.append(t_step)
                self.tracker.log("engine.t_step_s", t_step, step=i,
                                 tags=step_tags)
            if self.on_step is not None:
                self.on_step(self, i)
            if self._should_park(adm, i, sc.num_steps, step_times):
                self._park(adm, adm_id, i)
                parked = True
                break
        if parked:
            return []
        sync(self.device)
        now = time.time()
        if self.calibrator is not None and step_times:
            self.calibrator.observe(adm.plan, b, t, step_times)
        results = [
            DiTResult(r.rid, x[i], now - r.submitted, sc.num_steps,
                      sla_met=(r.sla is None or now <= r.submitted + r.sla),
                      step_times=list(step_times),
                      preemptions=r.preemptions)
            for i, r in enumerate(batch)
        ]
        tr = self.tracker
        tr.log("engine.batch_done", float(n_real),
               tags={"adm": adm_id, "seq": t, "rows": b})
        for r, req in zip(results, batch):
            tr.count("engine.completed", tags={"seq": t})
            if r.preemptions:
                tr.count("engine.restarted_requests")
            tr.log("engine.request_done", r.latency,
                   tags={"adm": adm_id, "rid": r.rid, "seq": t,
                         "preemptions": r.preemptions,
                         "sla_met": r.sla_met})
            if req.sla is not None:
                tr.count("engine.sla_met" if r.sla_met
                         else "engine.sla_miss", tags={"seq": t})
        return results

    def serve(self) -> list[DiTResult]:
        """Drain the queue.  With the arrival forecaster engaged, each round
        first offers the admission policy a non-flush pick; a round that
        admits nothing and parks nothing falls back to a flush pick, so the
        drain always terminates."""
        out = []
        while self.scheduler.pending:
            if self.scheduler.forecaster is not None:
                pre = self.preemptions
                got = self.run_once(flush=False)
                if got or self.preemptions != pre:
                    out.extend(got)
                    continue
            out.extend(self.run_once(flush=True))
        return out
