"""Flow-matching Euler sampler for DiT serving (paper Figure 1 pipeline).

One sampling step = one full DiT forward (velocity prediction) — the unit
the paper benchmarks ("latency of one sampling step").  The sampler
integrates x_t from t=1 (noise) to t=0 (data) with uniform Euler steps.

Beyond the paper, the sampler composes two extra parallel axes with SP:

  * **CFG parallelism** (``SamplerConfig.cfg_parallel``): the k guidance
    branches are stacked on the batch dim of one forward and, when the
    mesh carries ``SPConfig.cfg_axis``, split over it (each slice of the
    mesh runs one branch); they recombine as one weighted sum
    ``v = Σ_i w_i·v_i``.  Without it: classic two-branch guidance, or
    degree-k ``cfg_weights`` with one forward per branch.
  * **Displaced patch pipelining** (``SamplerConfig.pipeline``): after
    ``warmup_steps`` synchronous steps, each step runs the PipeFusion
    forward (models/dit.py ``dit_forward_displaced``) against one-step-
    stale per-layer KV; the sampler threads the KVState across steps.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..configs.base import ModelConfig
from ..core.pipefusion import KVState, PipelineConfig, init_kv_state, kv_drift
from ..models import ParallelContext, torch_dtype
from ..models.blocks import device_constant
from ..models.dit import (
    COND_TOKENS,
    LATENT_CHANNELS,
    dit_forward,
    dit_forward_displaced,
)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_steps: int = 20
    guidance_scale: float = 1.0  # >1 enables classifier-free guidance
    # Per-branch guidance weights for degree-k CFG.  None = classic 2-way
    # (guidance_scale, 1 - guidance_scale).  With k > 2 (or a negative
    # prompt at k = 2) every branch's conditioning must be supplied
    # explicitly as a stacked [k, B, COND_TOKENS, d] ``cond``.
    cfg_weights: tuple[float, ...] | None = None
    cfg_parallel: bool = False  # stack the CFG branches on the batch dim
    pipeline: PipelineConfig | None = None  # patch-level pipelining

    @property
    def guided(self) -> bool:
        return self.guidance_scale != 1.0 or self.cfg_weights is not None

    @property
    def branch_weights(self) -> tuple[float, ...]:
        if self.cfg_weights is not None:
            return tuple(self.cfg_weights)
        return (self.guidance_scale, 1.0 - self.guidance_scale)

    @property
    def cfg_degree(self) -> int:
        return len(self.branch_weights)

    @property
    def pipelined(self) -> bool:
        return self.pipeline is not None and self.pipeline.enabled


def _cfg_recombine(v_all: torch.Tensor, batch: int,
                   weights: tuple[float, ...]) -> torch.Tensor:
    """The single cross-branch exchange: v = Σ_i w_i·v_i, as one weighted
    sum over the stacked branch dim, in float32.  The guidance weights
    cancel (4 and -3 at scale 4), so in bfloat16 the recombination's own
    rounding is several ulps of the branches' magnitude: enough to set the
    latents of the two equal forms of CFG (sequential and stacked) ~2e-2
    apart, relative to what the model moved them, on a reduced model.
    Every recombination below runs in float32 for that reason."""
    k = len(weights)
    v_br = v_all.float().reshape(k, batch, *v_all.shape[1:])
    w = device_constant(("cfg_weights", tuple(weights)), v_all.device,
                        lambda: torch.tensor(weights, dtype=torch.float32))
    return (w.reshape(k, *([1] * v_all.ndim)) * v_br).sum(dim=0)


def _branch_conds(cond: torch.Tensor, k: int) -> torch.Tensor:
    """Per-branch conditioning [k, B, C, d] from the user-facing ``cond``:
    stacked explicit branches, or the classic (cond, zeros) pair."""
    if cond.ndim == 4:
        assert cond.shape[0] == k, (
            f"stacked cond has {cond.shape[0]} branches, guidance degree {k}")
        return cond
    assert k == 2, (
        f"guidance degree {k} needs explicit stacked [k, B, C, d] cond")
    return torch.stack([cond, torch.zeros_like(cond)], dim=0)


def _stack_cfg_branches(x_t, cond, k: int):
    """[B,...] -> [kB,...]: branch i occupies rows [i·B, (i+1)·B)."""
    conds = _branch_conds(cond, k)
    return torch.cat([x_t] * k, dim=0), torch.cat(list(conds), dim=0)


def _ctx_for(ctx: ParallelContext, sc: SamplerConfig) -> ParallelContext:
    """Drop the cfg mesh axis from the batch axes unless this sampler config
    stacks the CFG branches: the un-doubled batch cannot be split over a
    k-way cfg axis."""
    if ctx.sp.cfg_axis and not (sc.guided and sc.cfg_parallel):
        return dataclasses.replace(
            ctx, sp=dataclasses.replace(ctx.sp, cfg_axis=None))
    return ctx


def _timesteps(t: float | torch.Tensor, b: int,
               device: torch.device) -> torch.Tensor:
    """[b] float32 timesteps from a Python ``t`` or a 0-d device tensor (a
    captured step's static input: a float would be baked into the graph,
    where the reference's jitted step traces ``t``).  Both give the same
    bits."""
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=torch.float32).reshape(1).expand(
            b).contiguous()
    return torch.full((b,), t, dtype=torch.float32, device=device)


def sample_step(params, cfg: ModelConfig, ctx: ParallelContext,
                x_t: torch.Tensor, cond: torch.Tensor,
                t: float | torch.Tensor, dt: float,
                sc: SamplerConfig) -> torch.Tensor:
    """One Euler step x_{t-dt} = x_t - dt * v(x_t, t); ``t`` is a float or
    a 0-d tensor."""
    ctx = _ctx_for(ctx, sc)
    b = x_t.shape[0]
    tt = _timesteps(t, b, x_t.device)
    if sc.guided and sc.cfg_parallel:
        k = sc.cfg_degree
        lat_k, cond_k = _stack_cfg_branches(x_t, cond, k)
        v_all = dit_forward(params, cfg, ctx, latents=lat_k, cond=cond_k,
                            timesteps=torch.cat([tt] * k))
        v = _cfg_recombine(v_all, b, sc.branch_weights)
        return x_t - dt * v.to(x_t.dtype)
    if sc.guided and sc.cfg_weights is not None:
        # sequential general-degree guidance: one forward per branch,
        # recombined with the same weighted sum as the parallel path
        conds = _branch_conds(cond, sc.cfg_degree)
        v = None
        for w, c in zip(sc.branch_weights, conds):
            vb = dit_forward(params, cfg, ctx, latents=x_t, cond=c,
                             timesteps=tt).float()
            v = w * vb if v is None else v + w * vb
        return x_t - dt * v.to(x_t.dtype)
    v = dit_forward(params, cfg, ctx, latents=x_t, cond=cond, timesteps=tt)
    if sc.guided:
        v_un = dit_forward(params, cfg, ctx, latents=x_t,
                           cond=torch.zeros_like(cond), timesteps=tt)
        v, v_un = v.float(), v_un.float()
        v = v_un + sc.guidance_scale * (v - v_un)
    return x_t - dt * v.to(x_t.dtype)


# ---------------------------------------------------------------------------
# hybrid (cfg-parallel x patch-pipelined) stepping with threaded KV state
# ---------------------------------------------------------------------------

def hybrid_state_shape(cfg: ModelConfig, batch: int, seq_len: int,
                       sc: SamplerConfig,
                       device: torch.device | str) -> KVState:
    """Zero KVState matching what the hybrid steps thread (all k guidance
    branches included when cfg-parallel)."""
    b = sc.cfg_degree * batch if (sc.guided and sc.cfg_parallel) else batch
    return init_kv_state(cfg.n_layers, b, COND_TOKENS + seq_len,
                         cfg.n_kv_heads, cfg.resolved_head_dim,
                         torch_dtype(cfg.dtype), device)


def hybrid_sample_step(params, cfg: ModelConfig, ctx: ParallelContext,
                       x_t: torch.Tensor, cond: torch.Tensor,
                       t: float | torch.Tensor,
                       dt: float, sc: SamplerConfig, state: KVState,
                       *, warm: bool, out: KVState | None = None
                       ) -> tuple[torch.Tensor, KVState, dict]:
    """One Euler step that also threads the displaced-pipeline KV state.

    ``warm`` True runs the fully-synchronous forward — the x-path of
    ``sample_step`` — while capturing per-layer KV; False runs the
    PipeFusion displaced forward against ``state``.  The new state is
    written into ``out`` when given (a buffer the caller no longer needs:
    the counterpart of the reference's donated state) and ``state`` is
    left as it was, since the drift compares the two.

    The third return is the per-step metrics dict of device tensors:
    ``kv_drift`` (batch mean) and ``kv_drift_per_request`` ([B], the
    guidance branches of one request folded together); both are 0 for
    warm steps.
    """
    assert sc.pipelined
    ctx = _ctx_for(ctx, sc)
    pipe = sc.pipeline
    b = x_t.shape[0]
    tt = _timesteps(t, b, x_t.device)
    if sc.guided and sc.cfg_parallel:
        lat_in, cond_in = _stack_cfg_branches(x_t, cond, sc.cfg_degree)
        tt_in = torch.cat([tt] * sc.cfg_degree)
    elif sc.guided:
        raise NotImplementedError(
            "pipelined sampling with sequential CFG would need one KV "
            "state per branch; enable cfg_parallel (works on any mesh) "
            "instead")
    else:
        lat_in, cond_in, tt_in = x_t, cond, tt

    if warm:
        v_out, new = dit_forward(params, cfg, ctx, latents=lat_in,
                                 cond=cond_in, timesteps=tt_in,
                                 return_layer_kv=True, kv_out=out)
        per_req = torch.zeros((b,), dtype=torch.float32, device=x_t.device)
    else:
        v_out, new = dit_forward_displaced(
            params, cfg, ctx, latents=lat_in, cond=cond_in, timesteps=tt_in,
            kv_state=state, num_patches=pipe.patches, pp=pipe.pp, out=out)
        per_req = kv_drift(state, new, per_item=True)
        if sc.guided and sc.cfg_parallel:
            # branch rows of one request fold into that request's drift
            per_req = per_req.reshape(sc.cfg_degree, b).mean(dim=0)
    if sc.guided and sc.cfg_parallel:
        v = _cfg_recombine(v_out, b, sc.branch_weights)
    else:
        v = v_out
    metrics = {"kv_drift": per_req.mean(), "kv_drift_per_request": per_req}
    return x_t - dt * v.to(x_t.dtype), new, metrics


def spare_state(state: KVState) -> KVState:
    """A second buffer of ``state``'s shape: the hybrid steps write the new
    state into it, then the two swap roles."""
    return KVState(torch.empty_like(state.k), torch.empty_like(state.v))


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def sample(params, cfg: ModelConfig, ctx: ParallelContext, *,
           generator: torch.Generator | None = None, batch: int,
           seq_len: int,
           cond: torch.Tensor, sc: SamplerConfig = SamplerConfig(),
           step_fn=None, metrics: list[dict] | None = None,
           drift_policy=None,
           drift_thresholds: list[float | None] | None = None,
           interrupt=None, tracker=None,
           noise: torch.Tensor | None = None) -> torch.Tensor:
    """Full sampling loop; returns final latents [B, T, LATENT_CHANNELS].

    The initial noise is ``noise`` when given, else drawn from
    ``generator`` (on ``ctx.device``).
    With ``sc.pipeline`` set, the loop threads the displaced-pipeline KV
    state: the first ``warmup_steps`` steps run synchronously, then
    displaced, with a synchronous re-sync every ``resync_every`` steps.  A
    ``drift_policy`` (sched.DriftPolicy) replaces that static period with
    threshold-triggered resync: a step runs warm when the previous step's
    per-request ``kv_drift`` crossed the request's bound
    (``drift_thresholds``, one per batch row; None falls back to the
    policy's default), which costs one host read of the drift per step.
    A custom ``step_fn(x, cond, t)`` replaces all of that.

    The loop is step-granular: a ``metrics`` list collects one dict per
    step (``step``, ``t_step_s``, and for pipelined steps ``warm``,
    ``kv_drift``, ``kv_drift_per_request``).  ``t_step_s`` is the step's
    own wall clock: the clock stops when the step's outputs are ready, and
    only then are the drift floats read and the metrics emitted.
    ``interrupt(step_index)`` returning True stops the loop with the
    current latents; ``tracker`` publishes ``sampler.t_step_s`` and
    ``sampler.kv_drift`` (a persistent sink turns timing on by itself).
    """
    if noise is None:
        noise = torch.randn((batch, seq_len, LATENT_CHANNELS),
                            generator=generator,
                            dtype=torch_dtype(cfg.dtype), device=ctx.device)
    x = noise
    dt = 1.0 / sc.num_steps
    timed = metrics is not None or (tracker is not None
                                    and tracker.persistent)

    def stamp(i: int, t0: float, extra_fn=None) -> None:
        """Stop the step clock, THEN read the extras and emit."""
        if not timed:
            return
        sync(ctx.device)
        t_step = time.perf_counter() - t0
        extra = extra_fn() if extra_fn is not None else {}
        tags = {"warm": extra["warm"]} if "warm" in extra else None
        if metrics is not None:
            metrics.append({"step": i, "t_step_s": t_step, **extra})
        if tracker is not None:
            tracker.log("sampler.t_step_s", t_step, step=i, tags=tags)
            if "kv_drift" in extra:
                tracker.log("sampler.kv_drift", extra["kv_drift"], step=i)
            if tracker.persistent:
                tracker.span_event("sampler.step", t0 - tracker.epoch,
                                   t_step, step=i, tags=tags)

    if step_fn is None and not sc.pipelined:
        step_fn = lambda x, c, t: sample_step(params, cfg, ctx, x, c, t, dt,
                                              sc)
    if step_fn is not None:
        for i in range(sc.num_steps):
            t0 = time.perf_counter()
            x = step_fn(x, cond, 1.0 - i * dt)
            stamp(i, t0)
            if interrupt is not None and interrupt(i):
                return x
        return x
    thresholds = drift_thresholds or [None] * batch
    use_drift = drift_policy is not None and drift_policy.engaged(thresholds)
    last_drift: list[float] | None = None
    state = hybrid_state_shape(cfg, batch, seq_len, sc, ctx.device)
    spare = spare_state(state)
    for i in range(sc.num_steps):
        if use_drift:
            warm = drift_policy.warm(sc.pipeline, i, last_drift, thresholds)
        else:
            warm = sc.pipeline.warm_step(i)
        t0 = time.perf_counter()
        x, new, m = hybrid_sample_step(params, cfg, ctx, x, cond,
                                       1.0 - i * dt, dt, sc, state,
                                       warm=warm, out=spare)
        state, spare = new, state
        stamp(i, t0, lambda: {
            "warm": warm, "kv_drift": float(m["kv_drift"]),
            "kv_drift_per_request": [float(d) for d in
                                     m["kv_drift_per_request"]]})
        if use_drift:
            per = m["kv_drift_per_request"]
            last_drift = [float(per[j]) for j in range(batch)]
        if interrupt is not None and interrupt(i):
            return x
    return x



def toy_vae_decode(latents: torch.Tensor, out_channels: int = 3,
                   patch: int = 2,
                   weight: torch.Tensor | None = None) -> torch.Tensor:
    """Stub VAE decoder: fixed linear map latent tokens -> pixel patches.
    [B, T, C] -> [B, T * patch**2, out_channels], scaled by 1/√C.  The
    fixed ``weight`` [C, patch² · out_channels] is drawn from a
    ``torch.Generator`` seeded 42 on the latents' device unless given (the
    reference draws it from ``jax.random.PRNGKey(42)``, which torch cannot
    reproduce: a test hands that weight across)."""
    b, t, c = latents.shape
    if weight is None:
        gen = torch.Generator(device=latents.device).manual_seed(42)
        weight = torch.randn((c, patch * patch * out_channels), generator=gen,
                             dtype=latents.dtype, device=latents.device)
    px = torch.einsum("btc,cp->btp", latents, weight) / (c ** 0.5)
    return px.reshape(b, t * patch * patch, out_channels)
