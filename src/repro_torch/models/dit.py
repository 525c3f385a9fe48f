"""Diffusion Transformer (the paper's own workload family).

Latent patches arrive pre-patchified (VAE + patchifier stubbed, as in the
reference) together with a text-conditioning token sequence; the model
concatenates [cond ; latents], runs adaLN-zero DiT blocks with the
configured SP attention strategy (bidirectional — DiTs are non-causal),
and projects the latent positions back to the latent channel dim,
predicting the flow-matching velocity.

This is the model the serving engine (serving/engine.py) samples with.
Weights come from ``init_dit`` (on the device, from a ``torch.Generator``)
or from the reference's parameter tree through ``load_jax_params``.
``dit_forward_displaced`` is the displaced patch pipeline's forward
(PipeFusion, core/pipefusion.py).
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F

from ..comm import Stream, pipe_handoff
from ..comm.profiler import mark_compute
from ..configs.base import ModelConfig
from ..core.pipefusion import (
    KVState,
    drop_rows,
    patch_slices,
    stage_layers,
    update_state_rows,
)
from .blocks import (
    ParallelContext,
    ParamBuilder,
    Params,
    attention,
    init_attention,
    init_linear,
    init_mlp,
    init_norm,
    linear,
    mlp,
    norm,
    params_from_numpy,
    resolve_device,
    sinusoidal_embedding,
    torch_dtype,
)

LATENT_CHANNELS = 64
COND_TOKENS = 256
TIME_EMB = 256


def _init_block(b: ParamBuilder, cfg: ModelConfig) -> Params:
    b.params = {}
    init_norm(b, "ln_attn", cfg.d_model, cfg.norm)
    init_attention(b, cfg)
    init_norm(b, "ln_mlp", cfg.d_model, cfg.norm)
    init_mlp(b, cfg)
    # adaLN-zero: 6 modulation vectors from the time embedding; zero-init so
    # blocks start as identity (DiT paper).
    init_linear(b, "ada", cfg.d_model, 6 * cfg.d_model, init="zeros")
    return b.params


def init_dit(cfg: ModelConfig, generator: torch.Generator | None = None,
             device: str | torch.device | None = None) -> Params:
    """Fresh DiT parameters on ``device`` (CUDA by default), drawn from
    ``generator`` (one on that device; seeded with 0 when None)."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":  # meta draws nothing
        generator = torch.Generator(device=device).manual_seed(0)
    b = ParamBuilder(generator, torch_dtype(cfg.dtype), device)
    init_linear(b, "proj_in", LATENT_CHANNELS, cfg.d_model)
    init_linear(b, "cond_proj", cfg.d_model, cfg.d_model)
    init_linear(b, "time_mlp1", TIME_EMB, cfg.d_model)
    init_linear(b, "time_mlp2", cfg.d_model, cfg.d_model)
    init_norm(b, "ln_f", cfg.d_model, cfg.norm)
    init_linear(b, "ada_f", cfg.d_model, 2 * cfg.d_model, init="zeros")
    init_linear(b, "proj_out", cfg.d_model, LATENT_CHANNELS, init="zeros")
    params = b.params
    params["layers"] = [_init_block(b, cfg) for _ in range(cfg.n_layers)]
    return params


def load_jax_params(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: str | torch.device | None = None) -> Params:
    """The weight bridge: the reference's ``init_dit`` parameter tree,
    converted to numpy by the caller, as this package's params
    (blocks.params_from_numpy: stacked layers split, nothing transposed,
    leaves cast to ``cfg.dtype`` on ``device``)."""
    return params_from_numpy(tree, cfg, device)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None]) + shift[:, None]


def _time_embedding(params: Params, timesteps: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    # Mirrors the reference exactly, including its fault: row 0 of the
    # sinusoidal table is sin(0)/cos(0), so the sin half of the
    # "frequencies" is zero and t_feat is the same for every timestep.
    # Kept for parity with the reference; the DiT parity tests use two
    # distinct timesteps so that a silent change here fails them.
    temb = sinusoidal_embedding(TIME_EMB, TIME_EMB, device=timesteps.device)
    freqs = temb[0, : TIME_EMB // 2]
    t_feat = torch.cat(
        [torch.sin(timesteps[:, None] * 1000.0 * freqs),
         torch.cos(timesteps[:, None] * 1000.0 * freqs)],
        dim=-1,
    ).to(dtype)
    return linear(F.silu(linear(t_feat, params["time_mlp1"])),
                  params["time_mlp2"])  # [B, d]


def _final_projection(params: Params, cfg: ModelConfig, x: torch.Tensor,
                      t_emb: torch.Tensor) -> torch.Tensor:
    sh, sc = linear(t_emb, params["ada_f"]).chunk(2, dim=-1)
    x = _modulate(norm(x, params["ln_f"], cfg.norm), sh, sc)
    return linear(x, params["proj_out"])


def dit_block(lp: Params, cfg: ModelConfig, ctx: ParallelContext,
              x: torch.Tensor, t_emb: torch.Tensor, positions: torch.Tensor,
              *, extra_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
              return_kv: bool = False):
    """One adaLN-zero DiT block: x [B, L, d] -> [B, L, d]; with
    ``return_kv`` also the attention's post-RoPE (K, V).  ``extra_kv`` is
    the stale KV of the displaced pipeline (blocks.attention)."""
    mod = linear(t_emb, lp["ada"])  # [B, 6d]
    sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
    h = _modulate(norm(x, lp["ln_attn"], cfg.norm), sh1, sc1)
    o = attention(h, lp["attn"], cfg, ctx, positions, causal=False,
                  extra_kv=extra_kv, return_kv=return_kv)
    if return_kv:
        o, kv = o
    x = x + g1[:, None] * o
    h = _modulate(norm(x, lp["ln_mlp"], cfg.norm), sh2, sc2)
    x = x + g2[:, None] * mlp(h, lp["mlp"], cfg)
    return (x, kv) if return_kv else x


def _embed(params: Params, latents: torch.Tensor, cond: torch.Tensor,
           timesteps: torch.Tensor):
    """[cond ; latents] projected to d_model, and the time embedding."""
    x_lat = linear(latents, params["proj_in"])
    x_cond = linear(cond, params["cond_proj"])
    x = torch.cat([x_cond, x_lat], dim=1)
    return x, _time_embedding(params, timesteps, x.dtype)


def dit_forward(
    params: Params,
    cfg: ModelConfig,
    ctx: ParallelContext,
    *,
    latents: torch.Tensor,  # [B, T, LATENT_CHANNELS]
    cond: torch.Tensor,  # [B, COND_TOKENS, d] (stub text encoder output)
    timesteps: torch.Tensor,  # [B] in [0, 1], float32
    return_layer_kv: bool = False,
    kv_out: KVState | None = None,
):
    """Returns predicted velocity [B, T, LATENT_CHANNELS].

    With ``return_layer_kv`` also returns a KVState of every layer's
    full-sequence post-RoPE (K, V) — the warm pass of the displaced patch
    pipeline seeds the stale-KV state with it — written into ``kv_out``
    when given (else into a new buffer).  The x-path computation is
    identical either way.
    """
    b_, _, _ = latents.shape
    x, t_emb = _embed(params, latents, cond, timesteps)
    l_ = x.shape[1]
    # 1-D positions over [cond ; latents], as in the reference (not Flux's
    # 2-D rope)
    positions = torch.arange(l_, device=x.device)[None].expand(b_, l_)
    state = None
    if return_layer_kv:
        shape = (cfg.n_layers, b_, l_, cfg.n_kv_heads, cfg.resolved_head_dim)
        state = kv_out if kv_out is not None else KVState(
            *(torch.empty(shape, dtype=x.dtype, device=x.device)
              for _ in range(2)))
    block = ctx.remat_wrap(dit_block)  # train mode: per-layer checkpoints
    for i, lp in enumerate(params["layers"]):
        if state is None:
            x = block(lp, cfg, ctx, x, t_emb, positions)
            continue
        x, (k, v) = dit_block(lp, cfg, ctx, x, t_emb, positions,
                              return_kv=True)
        update_state_rows(state, k[None], v[None], 0, first_layer=i)
    vel = _final_projection(params, cfg, x, t_emb)[:, COND_TOKENS:]
    return (vel, state) if return_layer_kv else vel


def dit_forward_displaced(
    params: Params,
    cfg: ModelConfig,
    ctx: ParallelContext,
    *,
    latents: torch.Tensor,  # [B, T, LATENT_CHANNELS]
    cond: torch.Tensor,  # [B, COND_TOKENS, d]
    timesteps: torch.Tensor,  # [B]
    kv_state: KVState,  # per-layer stale KV from the previous sampler step
    num_patches: int,
    pp: int = 1,
    out: KVState | None = None,
) -> tuple[torch.Tensor, KVState]:
    """One displaced-pipeline DiT forward (PipeFusion async).

    The latent sequence is split into ``num_patches`` patches (patch 0 also
    owns the conditioning tokens); each patch runs the full block stack
    with fresh Q/KV for its own rows and one-step-stale KV (``kv_state``)
    for every other row.  Fresh per-layer KV is written into ``out`` (a
    second buffer: every patch reads the untouched ``kv_state``), which
    becomes the next step's stale state.  Returns (velocity, new KVState).

    The patch loop realises the dataflow of the pp-stage pipeline: stage s
    is the contiguous layer slice ``stage_layers(L, pp)[s]`` of
    ``params["layers"]`` (a view: the same tensors), and when the mesh
    carries a ``pp``-sized ``ctx.sp.pp_axis`` every stage boundary is an
    explicit put over the pipe axis (``comm.pipe_handoff``), one per
    (patch, boundary), lowered by the context's comm backend.  Without the
    axis the hand-off is skipped and the maths is unchanged.  Patches run
    in the pipeline's order (at tick τ, stage s runs patch τ - s), so
    that patch p's hand-off into stage s + 1 is in flight while stage s
    runs patch p + 1.  Each patch reads only the untouched ``kv_state``
    and writes only its own rows, so the order changes no value.
    """
    b_, t_, _ = latents.shape
    stages = stage_layers(cfg.n_layers, pp)
    slices = patch_slices(COND_TOKENS, t_, num_patches)
    mesh, pp_axis = ctx.mesh, ctx.sp.pp_axis
    explicit_handoff = (pp > 1 and mesh is not None and pp_axis is not None
                        and pp_axis in mesh.axis_names
                        and mesh.shape[pp_axis] == pp)
    stream = Stream("pipe", backend=ctx.sp.comm_backend,
                    interpret=ctx.sp.kernel_interpret)
    batch_axes = ctx.sp.effective_batch_axes(mesh)
    stage_axes = (pp_axis,) if explicit_handoff else ()

    x_full, t_emb = _embed(params, latents, cond, timesteps)
    new_state = out if out is not None else KVState(
        torch.empty_like(kv_state.k), torch.empty_like(kv_state.v))
    xs = [x_full[:, start:start + length] for start, length in slices]
    in_flight = [None] * len(slices)  # patch i's hand-off into its next stage
    vel_chunks = [None] * len(slices)
    for tick in range(len(slices) + len(stages) - 1):
        for s, (l0, cnt) in enumerate(stages):
            i = tick - s
            if not 0 <= i < len(slices):
                continue
            start, length = slices[i]
            if in_flight[i] is not None:
                xs[i], in_flight[i] = in_flight[i].wait(), None
            pos = torch.arange(start, start + length,
                               device=latents.device)[None].expand(b_, length)
            with mark_compute("stage compute", stage_axes, latents.device,
                              stream="pipe"):
                for l, lp in enumerate(params["layers"][l0:l0 + cnt],
                                       start=l0):
                    # stale KV of every NON-resident row of this layer
                    stale = (drop_rows(kv_state.k[l], start, length, axis=1),
                             drop_rows(kv_state.v[l], start, length, axis=1))
                    xs[i], (kp, vp) = dit_block(lp, cfg, ctx, xs[i], t_emb,
                                                pos, extra_kv=stale,
                                                return_kv=True)
                    update_state_rows(new_state, kp[None], vp[None], start,
                                      first_layer=l)
            if explicit_handoff and s < pp - 1:
                in_flight[i] = pipe_handoff(xs[i], mesh, pp_axis,
                                            batch_axes=batch_axes,
                                            stream=stream)
            elif s == len(stages) - 1:
                vp_out = _final_projection(params, cfg, xs[i], t_emb)
                if start == 0:  # patch 0 carries the conditioning tokens
                    vp_out = vp_out[:, COND_TOKENS:]
                vel_chunks[i] = vp_out
    return torch.cat(vel_chunks, dim=1), new_state
