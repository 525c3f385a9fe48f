"""Flow-matching Euler sampler for DiT serving (paper Figure 1 pipeline).

One sampling step = one full DiT forward (velocity prediction) — the unit
the paper benchmarks ("latency of one sampling step").  The sampler
integrates x_t from t=1 (noise) to t=0 (data) with uniform Euler steps.

Classifier-free guidance: classic two-branch guidance, degree-k
``cfg_weights`` (one forward per branch, recombined as v = Σ_i w_i·v_i),
or, with ``cfg_parallel``, the k branches stacked on the batch dim of one
forward.  Displaced patch pipelining (``SamplerConfig.pipeline``) is not
ported yet (ROADMAP Queue 1 item 5) and raises.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..configs.base import ModelConfig
from ..core.pipefusion import PipelineConfig
from ..models import ParallelContext, torch_dtype
from ..models.dit import LATENT_CHANNELS, dit_forward


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
    sum over the stacked branch dim."""
    k = len(weights)
    v_br = v_all.reshape(k, batch, *v_all.shape[1:])
    w = torch.tensor(weights, dtype=v_all.dtype, device=v_all.device)
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


def sample_step(params, cfg: ModelConfig, ctx: ParallelContext,
                x_t: torch.Tensor, cond: torch.Tensor, t: float,
                dt: float, sc: SamplerConfig) -> torch.Tensor:
    """One Euler step x_{t-dt} = x_t - dt * v(x_t, t)."""
    if sc.pipelined:
        raise NotImplementedError(
            "pipelined sampling (displaced patch pipeline) is not ported "
            "yet: ROADMAP Queue 1 item 5")
    b = x_t.shape[0]
    tt = torch.full((b,), t, dtype=torch.float32, device=x_t.device)
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
                             timesteps=tt)
            v = w * vb if v is None else v + w * vb
        return x_t - dt * v.to(x_t.dtype)
    v = dit_forward(params, cfg, ctx, latents=x_t, cond=cond, timesteps=tt)
    if sc.guided:
        v_un = dit_forward(params, cfg, ctx, latents=x_t,
                           cond=torch.zeros_like(cond), timesteps=tt)
        v = v_un + sc.guidance_scale * (v - v_un)
    return x_t - dt * v.to(x_t.dtype)


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def sample(params, cfg: ModelConfig, ctx: ParallelContext, *,
           generator: torch.Generator, batch: int, seq_len: int,
           cond: torch.Tensor, sc: SamplerConfig = SamplerConfig(),
           step_fn=None, metrics: list[dict] | None = None,
           interrupt=None, tracker=None) -> torch.Tensor:
    """Full sampling loop; returns final latents [B, T, LATENT_CHANNELS].

    The initial noise is drawn from ``generator`` (on ``ctx.device``).
    The loop is step-granular: a ``metrics`` list collects one dict per
    step with its own wall clock ``t_step_s`` (the loop waits for the
    step's outputs before stamping it), ``interrupt(step_index)`` returning
    True stops the loop with the current latents, and ``tracker``
    publishes ``sampler.t_step_s`` (a persistent sink turns timing on by
    itself).  A custom ``step_fn(x, cond, t)`` replaces ``sample_step``.
    """
    if sc.pipelined:
        raise NotImplementedError(
            "pipelined sampling (displaced patch pipeline) is not ported "
            "yet: ROADMAP Queue 1 item 5")
    x = torch.randn((batch, seq_len, LATENT_CHANNELS), generator=generator,
                    dtype=torch_dtype(cfg.dtype), device=ctx.device)
    dt = 1.0 / sc.num_steps
    timed = metrics is not None or (tracker is not None
                                    and tracker.persistent)
    if step_fn is None:
        step_fn = lambda x, c, t: sample_step(params, cfg, ctx, x, c, t, dt,
                                              sc)
    for i in range(sc.num_steps):
        t0 = time.perf_counter()
        x = step_fn(x, cond, 1.0 - i * dt)
        if timed:
            # stop the clock at output-ready, then emit
            sync(ctx.device)
            t_step = time.perf_counter() - t0
            if metrics is not None:
                metrics.append({"step": i, "t_step_s": t_step})
            if tracker is not None:
                tracker.log("sampler.t_step_s", t_step, step=i)
                if tracker.persistent:
                    tracker.span_event("sampler.step", t0 - tracker.epoch,
                                       t_step, step=i)
        if interrupt is not None and interrupt(i):
            return x
    return x
