"""Serving engines: DiT sampling and autoregressive LM decoding.

DiTServer — the paper's scenario: requests ask for an image at a given
latent sequence length; the SLA-aware request scheduler (serving/sched)
buckets them by latent length, admits across buckets against per-request
deadlines, and memoizes one step function per bucket shape; the
flow-matching sampler runs every attention through the configured SP
strategy over a mesh of virtual ranks on one device (launch/mesh.py) —
the hand-written kernels K1/K2 and the put kernels under
``comm_backend="pallas"`` — and results stream back.  On a hybrid mesh
(cfg, pipe, data, model) the server also drives CFG parallelism, data
parallelism with padding rows, and the displaced patch pipeline with its
drift-triggered resync.

ARServer — fixed-slot batched greedy decoding for the language models
(rwkv6-1.6b and the dense and vlm attention LMs, whose KV caches are
sharded on the sequence over the mesh's SP ranks), with aged-priority slot
admission.

Where the reference compiles one step per bucket shape (and its AR tick
once), the port captures each as a CUDA graph and replays it
(serving/graphs.py): on CUDA by default, eagerly with ``capture=False``
and always on the CPU.  A captured step's first call runs eagerly (the
warm-up), its second captures it.

On a process mesh (launch/procs.py) DiTServer stays single-controller, as
the reference is: process 0's server runs the scheduler and sends each
step's plan (request ids as noise seeds, bucket, step index, the
conditioning at step 0, and for the pipelined sampler the patch count and
the warm or displaced form it chose) to the other processes, whose
``follow`` runs the same step on their part of the latents (their data
slice's requests; their sequence shard, or every row when pipelined);
process 0 gathers one replica per data slice once the batch is done, and
each pipelined step's drift of every slice.  Followers run no scheduler:
the SLA scheduler reads the clock, and its choices would part between
processes.  Such a server is eager.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import deque
from typing import Callable, Iterator

import torch

from ..comm import CommProfiler, emit_leg_spans
from ..comm import profile as comm_profile
from ..configs.base import ModelConfig
from ..core import SPConfig, plan_hybrid
from ..core.comm_model import NetworkModel
from ..core.pipefusion import stage_layers
from ..models import ParallelContext, get_model, resolve_device, torch_dtype
from ..models.dit import COND_TOKENS, LATENT_CHANNELS
from ..models.lm import check_process_mesh
from .graphs import CapturedStep, resolve_capture
from .metrics import Tracker
from .sampler import (
    SamplerConfig,
    assemble_latents,
    batch_drift,
    held_cond,
    held_latents,
    hybrid_sample_step,
    hybrid_state_shape,
    sample_step,
    spare_state,
    sync,
)
from .sched import (
    ArrivalForecaster,
    ControlConfig,
    DriftPolicy,
    OnlineCalibrator,
    PlanCache,
    PlanChoice,
    RequestScheduler,
    SchedConfig,
    aged_priority,
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
    # per-request KV-staleness bound for the displaced pipeline; crossing
    # it triggers a resync step (None = the server DriftPolicy's default)
    drift_threshold: float | None = None
    # times this request's batch was parked by the preemption policy
    preemptions: int = 0


@dataclasses.dataclass
class DiTResult:
    rid: int
    latents: torch.Tensor
    latency: float
    sampling_steps: int
    # per-step KV staleness trajectory of the displaced pipeline (empty for
    # non-pipelined sampling); see core/pipefusion.kv_drift
    kv_drift: list[float] = dataclasses.field(default_factory=list)
    # warm steps the drift policy injected after warmup
    resyncs: int = 0
    # whether the request's deadline (submitted + sla) was met
    sla_met: bool = True
    # per-step wall clocks of the final run of this request's batch (empty
    # unless the step loop is measured)
    step_times: list[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0


class DiTServer:
    """Batched DiT sampling on one device, over ``mesh`` (the reference's
    ``DiTServer(params, cfg, mesh, sp, ...)``; without a mesh, a 1-rank
    mesh on ``device``).  [cond ; latents] must split evenly over the SP
    degree, as the reference's shard_map requires.

    ``submit`` feeds the bucketer, ``run_once`` asks the admission policy
    for the next (bucket, batch) under SLA/starvation rules, and step
    functions come from the plan cache (one build per bucket shape, with
    hit/miss counters).  ``device`` defaults to CUDA and raises without
    it; ``params`` must already live on that device.

    Beyond plain SP:

      * ``sampler.cfg_parallel`` — the CFG branches ride one batch, split
        over the ``sp.cfg_axis`` slices of the mesh.
      * data parallelism — batches are padded to a multiple of the mesh's
        ``sp.batch_axes`` size; pad rows draw their own noise and are
        dropped before results.
      * ``sampler.pipeline`` — displaced patch pipelining: warm and
        displaced step variants per bucket (keyed by the plan's patch
        count), the per-layer KV state threaded across the loop in two
        buffers that swap roles, and ``drift`` (a DriftPolicy) resyncing
        a request whose ``kv_drift`` crosses its ``drift_threshold``.
        ``stages`` holds each pipeline stage's contiguous slice of
        ``params["layers"]`` (the same tensors, not copies).

    ``profile=True`` runs every step under the comm span profiler
    (comm/profiler.py): each put and marked compute block is observed
    with timing events (in a captured step, event nodes of its graph),
    the step loop emits an ``engine.step`` span per step (with the plan's
    predictions), and each admission's observations are drained into the
    tracker as ``comm.*`` spans.

    ``capture`` (None: on CUDA) captures each bucket's step as a CUDA
    graph and replays it (serving/graphs.py); the graphs of one server
    share one memory pool and stay cached with their bucket, across a
    park and its restart.  ``capture=False`` runs the steps eagerly.
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
                 drift: DriftPolicy | None = None,
                 net: NetworkModel | None = None,
                 control: ControlConfig | None = None,
                 tracker: Tracker | None = None,
                 profile: bool = False,
                 device: str | torch.device | None = None,
                 mesh=None, capture: bool | None = None):
        self.device = resolve_device(device) if mesh is None else mesh.device
        if mesh is not None and device is not None and (
                resolve_device(device).type != mesh.device.type):
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        w = params["proj_in"]["w"]
        if w.device.type != self.device.type:
            raise ValueError(f"params are on {w.device}, server on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.ctx = ParallelContext(sp, "prefill", self.device, mesh)
        self.sampler = sampler
        self.profiler = CommProfiler() if profile else None
        self.capture = resolve_capture(capture, self.device)
        self.group = None  # a process mesh's workers (launch/procs.py)
        if mesh is not None and mesh.is_process_mesh:
            if self.capture:
                raise NotImplementedError(
                    "captured steps over a process mesh are a later slice "
                    "(ROADMAP Queue 1 item 13); serve it with capture=False "
                    "(--eager)")
            from ..launch import procs as _procs

            self.group = _procs.group()
            self._follow_steps: dict = {}
        self._pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.tracker = tracker if tracker is not None else Tracker()
        self.drift = drift if drift is not None else DriftPolicy()
        self.control = control if control is not None else ControlConfig()
        # instrumentation hook: on_step(server, step_index) after every
        # completed sampler step, before the preemption check
        self.on_step: Callable[[DiTServer, int], None] | None = None

        pipe = sampler.pipeline if sampler.pipelined else None
        pp = pipe.pp if pipe else 1
        # stage partitioning: each pipeline stage's contiguous layer slice
        self.stages = [params["layers"][l0:l0 + n]
                       for l0, n in stage_layers(cfg.n_layers, pp)]

        dp = self._dp_degree()
        sched = sched if sched is not None else SchedConfig(max_batch=max_batch)
        self.sched_cfg = dataclasses.replace(sched, dp=dp)
        cfg_deg = (sampler.cfg_degree
                   if (sampler.guided and sampler.cfg_parallel) else 1)
        sp_deg = self.ctx.sp_degree
        # the one plan this mesh and sampler can execute, planned as one
        # machine of cfg x pp x sp devices, as in the reference; the plan
        # cache chooses the patch count per bucket
        fixed = plan_hybrid(1, cfg_deg * pp * sp_deg, cfg.n_heads,
                            cfg.n_kv_heads, cfg_parallel=cfg_deg > 1,
                            cfg_degree=max(cfg_deg, 2), pp=pp,
                            n_layers=cfg.n_layers)
        self.plan_cache = PlanCache(
            heads=cfg.n_heads, head_dim=cfg.resolved_head_dim,
            kv_heads=cfg.n_kv_heads, n_layers=cfg.n_layers,
            num_steps=sampler.num_steps, guided=sampler.guided,
            guidance_branches=sampler.cfg_degree, dp=dp, net=net,
            candidates=[fixed], base_patches=pipe.patches if pipe else 0,
            tracker=self.tracker)
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

    def _bucket_sampler(self, choice: PlanChoice) -> SamplerConfig:
        """The sampler config for one bucket: the server's, with the plan
        cache's per-bucket patch count applied."""
        return self._patched(choice.num_patches)

    def _patched(self, num_patches: int) -> SamplerConfig:
        """The server's sampler config with ``num_patches`` (0: as it
        is)."""
        if not (self.sampler.pipelined and num_patches):
            return self.sampler
        return dataclasses.replace(
            self.sampler, pipeline=dataclasses.replace(
                self.sampler.pipeline, num_patches=num_patches))

    def _captured(self, fn: Callable, rows: int, seq: int,
                  name: str) -> CapturedStep:
        """``fn`` as a step of this server: captured into its pool unless
        capture is off; each capture is a plan-cache span."""
        return CapturedStep(
            fn, self.device, capture=self.capture, pool=self._pool,
            on_capture=lambda: self._capturing(rows, seq),
            name=f"{name} rows={rows} seq={seq}")

    @contextlib.contextmanager
    def _capturing(self, rows: int, seq: int) -> Iterator[None]:
        """Bracket the capture of one of a bucket's steps: a
        ``plan_cache.capture`` span and count in the tracker, beside the
        plan cache's ``plan_cache.trace`` builds (a step is captured on its
        second call, after its build)."""
        tags = {"rows": rows, "seq": seq}
        self.tracker.count("plan_cache.capture", tags=tags)
        with self.tracker.span("plan_cache.capture", tags=tags):
            yield

    @property
    def captures(self) -> int:
        """CUDA graphs captured so far (0 while the steps run eagerly)."""
        return int(self.tracker.counter_total("plan_cache.capture"))

    def _step_fn(self, batch: int, seq: int, choice: PlanChoice):
        """The bucket's step — for a pipelined sampler a ``_HybridSteps``
        of warm and displaced variants — memoized by the plan cache (one
        build per bucket shape and patch count)."""
        sc = self._bucket_sampler(choice)

        def build():
            if sc.pipelined:
                return _HybridSteps(self, batch, seq, sc)
            return self._captured(self._plain_step(seq, sc), batch, seq,
                                  "dit.step")

        return self.plan_cache.step_fn(batch, seq, build,
                                       variant=choice.num_patches)

    def captured_steps(self) -> list[CapturedStep]:
        """Every step built so far (captured or not), in build order."""
        out = []
        for step in self.plan_cache._steps.values():
            out.extend(step.steps.values() if isinstance(step, _HybridSteps)
                       else [step])
        return out

    def _dp_degree(self) -> int:
        """Size of the mesh's data (batch) axes: batches are padded to a
        multiple of it."""
        mesh = self.ctx.mesh
        if mesh is None:
            return 1
        return math.prod(mesh.shape[a] for a in self.ctx.sp.batch_axes or ()
                         if a in mesh.axis_names)

    def _plain_step(self, seq: int, sc: SamplerConfig):
        """One Euler step of the bucket (on a process mesh, of this
        process's shard of ``seq`` latents)."""
        dt = 1.0 / sc.num_steps
        kw = dict(seq_len=seq) if self.group is not None else {}

        def f(x, cond, t):
            return sample_step(self.params, self.cfg, self.ctx, x, cond, t,
                               dt, sc, **kw)

        return f

    def _noise_keys(self, batch: list[DiTRequest], b: int) -> list[int]:
        """Each row's noise seed: its request id (pad rows: salt + row
        index)."""
        return [batch[i].rid if i < len(batch) else self._PAD_NOISE_SALT + i
                for i in range(b)]

    def _noise(self, batch: list[DiTRequest], b: int, t: int) -> torch.Tensor:
        """Initial latent noise, drawn per ROW from a generator seeded by
        (_NOISE_SEED, rid) (pad rows: (_NOISE_SEED, salt + row index))."""
        return self._noise_rows(self._noise_keys(batch, b), t)

    def _noise_rows(self, keys: list[int], t: int) -> torch.Tensor:
        """The noise of rows seeded by ``keys``; on a process mesh, this
        process's part of it (``sampler.held_latents``)."""
        rows = []
        for key in keys:
            g = torch.Generator(device=self.device)
            g.manual_seed((self._NOISE_SEED << 32) | key)
            rows.append(torch.randn((t, LATENT_CHANNELS), generator=g,
                                    dtype=self.dtype, device=self.device))
        x = torch.stack(rows)
        if self.group is not None:
            x = held_latents(x, self.ctx, self.sampler, t)
        return x

    # -- a process mesh: process 0 leads, the others follow -------------------
    def _tell(self, msg: dict) -> None:
        """Send one plan message to every follower (process 0 only)."""
        for q in range(1, self.group.size):
            self.group.send(q, msg)

    def _gather(self, x: torch.Tensor, sc: SamplerConfig, b: int,
                t: int) -> torch.Tensor:
        """The batch's latents from process 0's part and every
        follower's: one replica per data slice and shard, in request
        order."""
        self._tell({"kind": "gather"})
        parts = [x] + [self.group.recv(q).to(x.device)
                       for q in range(1, self.group.size)]
        return assemble_latents(parts, self.ctx, sc, b, t)

    @staticmethod
    def _step_msg(keys, t: int, i: int, dt: float, cond,
                  **pipelined) -> dict:
        """The plan of step ``i`` that process 0 sends its followers: the
        rows' noise seeds, the bucket, the time, the conditioning at step
        0, and for the pipelined sampler its patch count and the warm or
        displaced form process 0 chose."""
        return {"kind": "step", "keys": keys, "seq": t, "step": i,
                "t": 1.0 - i * dt, "cond": cond if i == 0 else None,
                **pipelined}

    def stop_followers(self) -> None:
        """End every follower's ``follow`` loop (process 0 only)."""
        self._tell({"kind": "stop"})

    @torch.inference_mode()
    def follow(self) -> None:
        """A follower's loop: run each step process 0 plans on this
        process's shard, hand the shard over at the batch's end, until
        process 0 says stop."""
        x = cond = None
        while True:
            msg = self.group.recv(0)
            kind = msg["kind"]
            if kind == "stop":
                return
            if kind == "park":
                x = None
                continue
            if kind == "gather":
                self.group.send(0, x)
                x = None
                continue
            t, b = msg["seq"], len(msg["keys"])
            sc = self._patched(msg.get("patches", 0))
            if msg["step"] == 0:
                cond = held_cond(msg["cond"].to(device=self.device),
                                 self.ctx, b)
                x = self._noise_rows(msg["keys"], t)
            key = (t, b, msg.get("patches"))
            if key not in self._follow_steps:
                self._follow_steps[key] = (
                    _HybridSteps(self, b, t, sc) if sc.pipelined
                    else self._plain_step(t, sc))
            step = self._follow_steps[key]
            if not sc.pipelined:
                x = step(x, cond, msg["t"])
                continue
            if msg["step"] == 0:
                step.start()
            x, per = step(msg["warm"], msg["step"], x, cond, msg["t"])
            batch_drift(per, self.ctx, sc, b)

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
        sc = self._bucket_sampler(adm.plan)
        cond = torch.stack([
            (batch[i].cond.to(device=self.device, dtype=self.dtype)
             if i < n_real and batch[i].cond is not None
             else torch.zeros((COND_TOKENS, d), dtype=self.dtype,
                              device=self.device))
            for i in range(b)
        ])
        keys = self._noise_keys(batch, b)
        x = self._noise(batch, b, t)
        held = cond if self.group is None else held_cond(cond, self.ctx, b)
        fn = self._step_fn(b, t, adm.plan)
        dt = 1.0 / sc.num_steps
        # profiling implies measurement: the step spans need the clocks
        measure = (self.control.engaged or self.tracker.persistent
                   or self.profiler is not None)
        step_tags = {"adm": adm_id, "seq": t, "rows": b}
        step_times: list[float] = []
        drift_vals = []
        resyncs = 0

        def tick(i: int, t0: float, warm: bool | None = None) -> bool:
            """Post-step control point: stamp the step's wall clock (the
            clock stops when the outputs are ready, before any span is
            emitted), run the hook, then the preemption check.  True = the
            batch was parked."""
            if measure:
                sync(self.device)
                t_step = time.perf_counter() - t0
                step_times.append(t_step)
                self.tracker.log("engine.t_step_s", t_step, step=i,
                                 tags=step_tags)
                if self.profiler is not None:
                    tags = dict(step_tags)
                    tags["pred_t_step_s"] = adm.plan.t_step
                    if "t_compute_step" in adm.plan.pred:
                        tags["pred_compute_s"] = adm.plan.pred[
                            "t_compute_step"]
                    if warm is not None:
                        tags["warm"] = bool(warm)
                    self.tracker.span_event(
                        "engine.step", t0 - self.tracker.epoch, t_step,
                        step=i, tags=tags)
            if self.on_step is not None:
                self.on_step(self, i)
            if self._should_park(adm, i, sc.num_steps, step_times):
                self._park(adm, adm_id, i)
                return True
            return False

        parked = False
        prof_ctx = (comm_profile(self.profiler) if self.profiler is not None
                    else contextlib.nullcontext())
        with prof_ctx:
            if sc.pipelined:
                pipe = sc.pipeline
                thresholds = [r.drift_threshold for r in batch]
                use_drift = self.drift.engaged(thresholds)
                fn.start()
                last_drift: list[float] | None = None
                for i in range(sc.num_steps):
                    if use_drift:
                        warm = self.drift.warm(pipe, i, last_drift,
                                               thresholds,
                                               tracker=self.tracker)
                        if warm and i >= pipe.warmup_steps:
                            resyncs += 1
                            self.tracker.count("engine.resyncs",
                                               tags={"seq": t})
                    else:
                        warm = pipe.warm_step(i)
                    t0 = time.perf_counter()
                    if self.group is not None:
                        self._tell(self._step_msg(keys, t, i, dt, cond,
                                                  patches=pipe.patches,
                                                  warm=warm))
                    x, per = fn(warm, i, x, held, 1.0 - i * dt)
                    if self.group is not None:
                        # every slice's drift, folded on process 0
                        per = batch_drift(per, self.ctx, sc, b)
                    # a captured step's output holds until the next replay
                    per = per.clone()
                    drift_vals.append(per)
                    if use_drift:
                        # threshold-triggered resync reads the drift on the
                        # host: one device sync per step, only with a bound
                        last_drift = [float(per[j]) for j in range(n_real)]
                    if tick(i, t0, warm=warm):
                        parked = True
                        break
            else:
                for i in range(sc.num_steps):
                    t0 = time.perf_counter()
                    if self.group is not None:
                        self._tell(self._step_msg(keys, t, i, dt, cond))
                    x = fn(x, held, 1.0 - i * dt)
                    if tick(i, t0):
                        parked = True
                        break
        if self.profiler is not None:
            # pair and publish this admission's observations
            # (comm.leg / comm.compute / comm.exposed_wait spans)
            emit_leg_spans(self.profiler, self.tracker)
        if parked:
            if self.group is not None:
                self._tell({"kind": "park"})
            return []
        if self.group is not None:
            x = self._gather(x, sc, b, t)
        # the latents outlive the next replay of this server's graphs
        x = x.clone()
        sync(self.device)
        now = time.time()
        if self.calibrator is not None and step_times:
            self.calibrator.observe(adm.plan, b, t, step_times)
        # read after the timed region; row i is request i's own trajectory
        # (pad rows are never handed to a request)
        drifts = [[float(v[i]) for v in drift_vals] for i in range(n_real)]
        results = [
            DiTResult(r.rid, x[i], now - r.submitted, sc.num_steps,
                      kv_drift=drifts[i], resyncs=resyncs,
                      sla_met=(r.sla is None or now <= r.submitted + r.sla),
                      step_times=list(step_times),
                      preemptions=r.preemptions)
            for i, r in enumerate(batch)
        ]
        tr = self.tracker
        tr.log("engine.batch_done", float(n_real),
               tags={"adm": adm_id, "seq": t, "rows": b})
        if drift_vals and n_real:
            for step in range(len(drift_vals)):
                mean = sum(drifts[i][step] for i in range(n_real)) / n_real
                tr.log("engine.kv_drift", mean, step=step,
                       tags={"adm": adm_id, "seq": t})
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


class _HybridSteps:
    """The pipelined steps of one bucket: warm and displaced, each for both
    buffer parities, against two fixed KV-state buffers.  Step i reads the
    state from buffer i % 2 and writes the new one into the other, so the
    two swap roles with no copy (the counterpart of the reference's
    donated state): four captured graphs per bucket, bound to the same
    two buffers, which live as long as the bucket's steps do."""

    def __init__(self, server: DiTServer, batch: int, seq: int,
                 sc: SamplerConfig):
        dt = 1.0 / sc.num_steps
        state = hybrid_state_shape(server.cfg, batch, seq, sc, server.device,
                                   server.ctx)
        self.bufs = (state, spare_state(state))
        self.steps: dict[tuple[bool, int], CapturedStep] = {}
        for warm in (True, False):
            for parity in (0, 1):
                def f(x, cond, t, warm=warm, parity=parity):
                    x, _, m = hybrid_sample_step(
                        server.params, server.cfg, server.ctx, x, cond, t,
                        dt, sc, self.bufs[parity], warm=warm,
                        out=self.bufs[1 - parity])
                    return x, m["kv_drift_per_request"]

                name = f"dit.{'warm' if warm else 'displaced'}{parity}"
                self.steps[(warm, parity)] = server._captured(f, batch, seq,
                                                              name)

    def start(self) -> None:
        """A fresh trajectory: step 0 reads a zero state."""
        self.bufs[0].k.zero_()
        self.bufs[0].v.zero_()

    def __call__(self, warm: bool, i: int, x, cond, t):
        """Step ``i``: (x, per-request kv drift)."""
        return self.steps[(bool(warm), i % 2)](x, cond, t)


# ---------------------------------------------------------------------------
# AR decode serving (language models)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ARRequest:
    rid: int
    prompt: torch.Tensor  # [L_prompt] int
    max_new_tokens: int = 16
    priority: float = 0.0  # higher admits sooner; aging bounds starvation
    submitted: int = 0  # engine tick at submission (stamped by submit())


@dataclasses.dataclass
class Slot:
    req: ARRequest | None = None
    pos: int = 0  # next cache index to write
    generated: list[int] = dataclasses.field(default_factory=list)


class ARServer:
    """Fixed-slot continuous batching over per-slot decode caches, on one
    device (CUDA unless the caller asks for another; ``params`` must
    already live there).  With a ``mesh`` of virtual ranks, an attention
    model's KV caches are sharded on the sequence over ``sp.sp_axes``
    (``core.decode_attention``; ``max_len`` must split evenly over them)
    and the mesh's device is the server's.

    Prefill is teacher-forced decode of the prompt (one engine, one cache
    layout), as in the reference.  Freed slots are filled by effective
    priority ``priority + age * aging_rate`` (serving/sched
    ``aged_priority``) rather than raw FIFO: a request of base priority p
    is admitted within ``(p_max - p) / aging_rate`` ticks of any fresher
    competitor.  Ties reduce to FIFO.

    As in the reference, a slot's caches are not reset when a new request
    takes it, and all slots share one ``cur_index`` per tick (ROADMAP
    Queue 3, F4): the recurrent model reads no position, so only the
    carried state matters to it; an attention model admitted late writes
    its keys at the position of the slot that ticks first and attends the
    previous occupant's keys below it.  An attention model's caches must
    have the model's dtype (``cache_dtype``), as the reference's cache
    update requires.  Where the reference jits the step, the tick is
    captured as a CUDA graph on CUDA (``capture``, as in ``DiTServer``):
    the slot tokens and ``cur_index`` go through static device buffers,
    the caches through fixed ones (attention caches are written in place,
    so they stay the graph's own buffers), and ``nxt.tolist()`` reads the
    tokens after the replay.

    On a process mesh (launch/procs.py) an attention model runs eagerly
    (``capture=True`` is refused: captured steps over processes are a
    later slice).  Process 0 leads: it admits, sends each tick's slot
    tokens and ``cur_index`` to the others (``follow`` on them), and each
    process runs the tick on its batch slice's slots with its part of the
    caches (its slice's slots, its SP ranks' positions; the decode merge
    gathers every rank's partials, so every process of a slice gets the
    same tokens).  Each slice's next tokens reach process 0.  A MoE
    model's ``params`` must hold the process's experts
    (``models.moe.held_experts``): the decode sums gather the held EP
    ranks' contributions by puts.  The rwkv6 tick runs on one rank.
    """

    def __init__(self, params, cfg: ModelConfig, sp: SPConfig,
                 batch_slots: int = 4, max_len: int = 256,
                 cache_dtype: torch.dtype = torch.float32,
                 aging_rate: float = 0.1, tracker: Tracker | None = None,
                 device: str | torch.device | None = None,
                 capture: bool | None = None, mesh=None):
        if mesh is not None:
            given = torch.device(device) if device is not None else None
            if given is not None and (
                    given.type != mesh.device.type or given.index not in (
                        None, mesh.device.index)):
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        w = params["embed"]
        if w.device.type != self.device.type:
            raise ValueError(f"params are on {w.device}, server on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.ctx = ParallelContext(sp, "decode", self.device, mesh=mesh)
        self.bundle = get_model(cfg)
        self.slots = [Slot() for _ in range(batch_slots)]
        self.max_len = max_len
        self.aging_rate = aging_rate
        self.group = None  # a process mesh's workers (launch/procs.py)
        extra = {}
        if mesh is not None and mesh.is_process_mesh:
            if capture or (capture is None and self.device.type == "cuda"):
                raise NotImplementedError(
                    "captured steps over a process mesh are a later slice "
                    "(ROADMAP Queue 1 item 13); serve it with capture=False "
                    "(--eager)")
            if cfg.family == "ssm":
                raise ValueError("the rwkv6 decode tick runs on one rank: "
                                 "serve it without a mesh")
            with torch.inference_mode():  # as every tick runs
                check_process_mesh(cfg, self.ctx, params)
            from ..launch import procs as _procs

            self.group = _procs.group()
            # this process's slots: its batch slice of them
            self.rows = mesh.held_batch(sp.effective_batch_axes(mesh) or (),
                                        batch_slots)
            extra = dict(mesh=mesh, sp=sp)
        self.caches = self.bundle.init_caches(cfg, batch_slots, max_len,
                                              cache_dtype, self.device,
                                              **extra)
        self.queue: deque[ARRequest] = deque()
        self.results: dict[int, list[int]] = {}
        self._ticks = 0
        # metrics sink (DESIGN.md §11): slot admission / completion
        # counters plus the queue-wait series, same schema as DiTServer
        self.tracker = tracker if tracker is not None else Tracker()
        self.capture = resolve_capture(capture, self.device)
        self._step = CapturedStep(
            self._eager_step, self.device, capture=self.capture,
            pool=torch.cuda.graph_pool_handle() if self.capture else None,
            name="ar.tick")

    def _eager_step(self, caches, tokens, cur_index):
        with torch.inference_mode():
            logits, caches = self.bundle.step(self.params,
                                              {"tokens": tokens}, caches,
                                              cur_index, self.cfg, self.ctx)
            return torch.argmax(logits, dim=-1).to(torch.int32), caches

    def submit(self, req: ARRequest) -> None:
        req.submitted = self._ticks
        self.queue.append(req)
        self.tracker.count("ar.submitted")

    def _take_next(self) -> ARRequest:
        """Pop the waiting request with the highest aged priority (stable:
        FIFO among equals — max() keeps the first of tied keys)."""
        best = max(self.queue,
                   key=lambda r: aged_priority(r.priority,
                                               self._ticks - r.submitted,
                                               self.aging_rate))
        self.queue.remove(best)
        return best

    def _admit(self) -> None:
        for s in self.slots:
            if s.req is None and self.queue:
                s.req = self._take_next()
                s.pos = 0
                s.generated = []
                self.tracker.count("ar.admitted")
                self.tracker.log("ar.queue_wait_ticks",
                                 float(self._ticks - s.req.submitted),
                                 tags={"rid": s.req.rid})

    def tick(self) -> None:
        """Advance every active slot one position (slots run in lockstep:
        the static-batching baseline of the reference)."""
        self._admit()
        self._ticks += 1
        active = [s for s in self.slots if s.req is not None]
        if not active:
            return
        self.tracker.count("ar.ticks")
        pos = active[0].pos
        tokens = []
        for s in self.slots:
            if s.req is None:
                tokens.append(0)
            elif s.pos < len(s.req.prompt):
                tokens.append(int(s.req.prompt[s.pos]))
            else:
                tokens.append(s.generated[-1] if s.generated else 0)
        if self.group is None:
            nxt = self._run(tokens, pos)
        else:
            for q in range(1, self.group.size):
                self.group.send(q, {"kind": "tick", "tokens": tokens,
                                    "cur": pos})
            nxt = self._collect(self._run(tokens[self.rows], pos))
        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            s.pos += 1
            if s.pos >= len(s.req.prompt):
                s.generated.append(nxt[i])
            if (len(s.generated) >= s.req.max_new_tokens
                    or s.pos >= self.max_len - 1):
                self.results[s.req.rid] = list(s.generated)
                self.tracker.count("ar.completed")
                self.tracker.log("ar.request_done", float(len(s.generated)),
                                 tags={"rid": s.req.rid})
                s.req = None

    def serve(self, max_ticks: int = 10_000) -> dict[int, list[int]]:
        t = 0
        while (self.queue or any(s.req for s in self.slots)) and t < max_ticks:
            self.tick()
            t += 1
        return self.results

    def _run(self, tokens: list[int], pos: int) -> list[int]:
        """One tick of the step on ``tokens`` (one per slot this process
        runs) at position ``pos``: the next tokens."""
        tok = torch.tensor(tokens, dtype=torch.int32,
                           device=self.device)[:, None]
        cur = torch.full((), pos, dtype=torch.int32, device=self.device)
        nxt, self.caches = self._step(self.caches, tok, cur)
        return nxt.tolist()

    # -- a process mesh: process 0 leads, the others follow -------------------
    def _collect(self, mine: list[int]) -> list[int]:
        """Every slot's next token (process 0): its own slice's and each
        follower's; the processes of one slice must agree."""
        nxt: list[int | None] = [None] * len(self.slots)
        nxt[self.rows] = mine
        for q in range(1, self.group.size):
            start, toks = self.group.recv(q)
            have = nxt[start:start + len(toks)]
            if any(t is not None for t in have) and have != toks:
                raise RuntimeError(f"process {q}'s tokens {toks} for slots "
                                   f"{start}.. differ from {have}")
            nxt[start:start + len(toks)] = toks
        return nxt

    def follow(self) -> None:
        """A follower's loop: run each tick process 0 sends on this
        process's slots and send back their next tokens, until process 0
        says stop."""
        while True:
            msg = self.group.recv(0)
            if msg["kind"] == "stop":
                return
            self.group.send(0, (self.rows.start,
                                self._run(msg["tokens"][self.rows],
                                          msg["cur"])))

    def stop_followers(self) -> None:
        """End every follower's ``follow`` loop (process 0 only)."""
        for q in range(1, self.group.size):
            self.group.send(q, {"kind": "stop"})
