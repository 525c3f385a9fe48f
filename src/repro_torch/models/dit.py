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
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
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
    if generator is None:
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
    converted to numpy by the caller, as this package's params.

    The reference stacks the per-layer leaves on a leading [n_layers]
    axis; they are split into one dict per layer.  The [d_in, d_out]
    layout is kept, so nothing is transposed.  Leaves are cast to
    ``cfg.dtype`` on ``device``.
    """
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def leaf(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
            device=device, dtype=dtype)

    def convert(node, index=None):
        if isinstance(node, Mapping):
            return {k: convert(v, index) for k, v in node.items()}
        return leaf(node if index is None else np.asarray(node)[index])

    params = {k: convert(v) for k, v in tree.items() if k != "layers"}
    params["layers"] = [convert(tree["layers"], i)
                        for i in range(cfg.n_layers)]
    return params


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
              x: torch.Tensor, t_emb: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """One adaLN-zero DiT block: x [B, L, d] -> [B, L, d]."""
    mod = linear(t_emb, lp["ada"])  # [B, 6d]
    sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
    h = _modulate(norm(x, lp["ln_attn"], cfg.norm), sh1, sc1)
    o = attention(h, lp["attn"], cfg, ctx, positions, causal=False)
    x = x + g1[:, None] * o
    h = _modulate(norm(x, lp["ln_mlp"], cfg.norm), sh2, sc2)
    return x + g2[:, None] * mlp(h, lp["mlp"], cfg)


def dit_forward(
    params: Params,
    cfg: ModelConfig,
    ctx: ParallelContext,
    *,
    latents: torch.Tensor,  # [B, T, LATENT_CHANNELS]
    cond: torch.Tensor,  # [B, COND_TOKENS, d] (stub text encoder output)
    timesteps: torch.Tensor,  # [B] in [0, 1], float32
) -> torch.Tensor:
    """Returns predicted velocity [B, T, LATENT_CHANNELS]."""
    b_, _, _ = latents.shape
    x_lat = linear(latents, params["proj_in"])
    x_cond = linear(cond, params["cond_proj"])
    x = torch.cat([x_cond, x_lat], dim=1)
    l_ = x.shape[1]
    # 1-D positions over [cond ; latents], as in the reference (not Flux's
    # 2-D rope)
    positions = torch.arange(l_, device=x.device)[None].expand(b_, l_)
    t_emb = _time_embedding(params, timesteps, x.dtype)
    for lp in params["layers"]:
        x = dit_block(lp, cfg, ctx, x, t_emb, positions)
    return _final_projection(params, cfg, x, t_emb)[:, COND_TOKENS:]
