"""Whisper-style encoder-decoder (the audio family), the counterpart of the
reference's ``models/whisper.py``.

The mel-spectrogram + conv feature extractor is the stubbed modality
frontend, as in the reference: the model consumes precomputed frame
embeddings [B, encoder_seq, d_model].  Everything else is real:
sinusoidal positions, a bidirectional encoder, a causal decoder with
cross-attention to the encoder's output (``blocks.attention`` with
``xkv``: K and V from the memory, no rotation, Lq != Lk).  Every
attention runs through K1 (and K1b in training) at SP degree 1; over a
mesh every one is the SP schedule (core/sp_grad.py in training), the
cross-attention's K/V shards at the memory's own length.

Decode: the self-attention KV caches [n_layers, B, max_len, Hkv, D] are
written in place at ``cur_index`` through ``core.decode_attention``, as
the attention LMs' are; the encoder memory is passed in and each step's
cross-attention recomputes its K/V from it (the memory is 1.5k frames),
unsharded.  The decoder's position row at ``cur_index`` is computed
alone (``blocks.sinusoidal_rows``): the reference indexes a table of
4 x 65536 rows built every step, whose row is the same f32 product.

The layers are Python lists of per-layer dicts (the reference stacks
them for ``lax.scan``); in train mode each runs under
``ctx.remat_wrap``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from ..configs.base import ModelConfig
from ..core.decode import device_index
from .blocks import (
    ParallelContext,
    ParamBuilder,
    Params,
    attention,
    held_shard,
    inference_on_processes,
    init_attention,
    init_mlp,
    init_norm,
    mlp,
    norm,
    params_from_numpy,
    resolve_device,
    sinusoidal_rows,
    torch_dtype,
)


def _check_audio(cfg: ModelConfig) -> None:
    if cfg.family != "audio":
        raise ValueError(f"{cfg.arch_id} is of the {cfg.family} family, not "
                         f"audio")


def _init_enc_layer(b: ParamBuilder, cfg: ModelConfig) -> Params:
    b.params = {}
    init_norm(b, "ln_attn", cfg.d_model, cfg.norm)
    init_attention(b, cfg)
    init_norm(b, "ln_mlp", cfg.d_model, cfg.norm)
    init_mlp(b, cfg)
    return b.params


def _init_dec_layer(b: ParamBuilder, cfg: ModelConfig) -> Params:
    b.params = {}
    init_norm(b, "ln_self", cfg.d_model, cfg.norm)
    init_attention(b, cfg, prefix="self_attn")
    init_norm(b, "ln_cross", cfg.d_model, cfg.norm)
    init_attention(b, cfg, prefix="cross_attn")
    init_norm(b, "ln_mlp", cfg.d_model, cfg.norm)
    init_mlp(b, cfg)
    return b.params


def init_whisper(cfg: ModelConfig, generator: torch.Generator | None = None,
                 device: str | torch.device | None = None,
                 ep_degree: int = 1) -> Params:
    """Fresh whisper parameters on ``device`` (CUDA by default), drawn from
    ``generator`` (one on that device; seeded with 0 when None), with the
    reference's shapes and distributions: biases and norm shifts start at
    zero, norm scales at one.  ``ep_degree`` is the bundles' common
    signature; whisper has no experts."""
    _check_audio(cfg)
    device = resolve_device(device)
    if generator is None and device.type != "meta":  # meta draws nothing
        generator = torch.Generator(device=device).manual_seed(0)
    b = ParamBuilder(generator, torch_dtype(cfg.dtype), device)
    b.add("embed", (cfg.vocab, cfg.d_model), scale=0.02)
    init_norm(b, "ln_enc_f", cfg.d_model, cfg.norm)
    init_norm(b, "ln_dec_f", cfg.d_model, cfg.norm)
    params = b.params
    params["enc_layers"] = [_init_enc_layer(b, cfg)
                            for _ in range(cfg.encoder_layers)]
    params["dec_layers"] = [_init_dec_layer(b, cfg)
                            for _ in range(cfg.n_layers)]
    return params


def load_jax_whisper_params(tree: Mapping[str, Any], cfg: ModelConfig,
                            device: str | torch.device | None = None
                            ) -> Params:
    """The reference's ``init_whisper`` parameter tree, converted to numpy
    by the caller, as this package's params (the stacked ``enc_layers``
    and ``dec_layers`` split into one dict per layer, leaves cast to
    ``cfg.dtype`` on ``device``; nothing is transposed)."""
    _check_audio(cfg)
    return params_from_numpy(tree, cfg, device)


def _cached_decode_refused() -> NotImplementedError:
    return NotImplementedError(
        "whisper's cached decode over a process mesh is a later slice "
        "(ROADMAP Queue 1 item 10): its encoder memory would be gathered "
        "whole once per request")


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,
           ctx: ParallelContext, seq_len: int | None = None) -> torch.Tensor:
    """frames [B, T_enc, d] (the stub frontend's output) -> memory
    [B, T_enc, d].  A decode context encodes as prefill.  On a process
    mesh ``frames`` are this process's batch slice and sequence shard of
    ``seq_len`` frames, whose positions are the shard's rows of the
    sinusoid, and the memory is that shard's."""
    procs = inference_on_processes(ctx)
    b_, t, _ = frames.shape
    start, stop = held_shard(ctx, t, seq_len) if procs else (0, t)
    rows = torch.arange(start, stop, device=frames.device)
    x = frames + sinusoidal_rows(rows, cfg.d_model).to(frames.dtype)[None]
    positions = rows[None].expand(b_, t)
    enc_ctx = dataclasses.replace(ctx, mode="prefill") if ctx.decode else ctx

    def body(x, lp):
        h = norm(x, lp["ln_attn"], cfg.norm)
        x = x + attention(h, lp["attn"], cfg, enc_ctx, positions,
                          causal=False)
        return x + mlp(norm(x, lp["ln_mlp"], cfg.norm), lp["mlp"], cfg)

    body = enc_ctx.remat_wrap(body)
    for lp in params["enc_layers"]:
        x = body(x, lp)
    return norm(x, params["ln_enc_f"], cfg.norm)


def decode_forward(
    params: Params,
    cfg: ModelConfig,
    ctx: ParallelContext,
    *,
    tokens: torch.Tensor,  # [B, L] int
    memory: torch.Tensor,  # [B, T_enc, d] encoder output
    caches: Params | None = None,
    cur_index: Any = None,
    seq_len: int | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """Returns (logits [B, L, V], caches).  In decode mode ``caches``
    (stacked over layers) are written in place at ``cur_index`` (an int or
    a 0-d device tensor) and returned; otherwise None.  On a process mesh
    (teacher-forced, not cached) ``tokens`` are this process's batch
    slice and sequence shard of ``seq_len`` tokens, ``memory`` its shard
    of the encoder output (the cross-attention's K/V shards, at the
    memory's own length) and the logits cover the shard's rows."""
    _check_audio(cfg)
    procs = inference_on_processes(ctx)
    if procs and ctx.decode:
        raise _cached_decode_refused()
    b_, l_ = tokens.shape
    x = params["embed"].to(torch_dtype(cfg.dtype))[tokens]
    if ctx.decode:
        if caches is None or cur_index is None:
            raise ValueError("decode needs caches and cur_index")
        cur_index = device_index(cur_index, x.device)
        positions = cur_index.expand(b_, 1)
        pos_emb = sinusoidal_rows(cur_index, cfg.d_model)[None, None]
    else:
        rows = torch.arange(*(held_shard(ctx, l_, seq_len) if procs
                              else (0, l_)), device=x.device)
        positions = rows[None].expand(b_, l_)
        pos_emb = sinusoidal_rows(rows, cfg.d_model)[None]
    x = x + pos_emb.to(x.dtype)

    def body(x, lp, kv_cache):
        h = norm(x, lp["ln_self"], cfg.norm)
        if ctx.decode:
            o, _ = attention(h, lp["self_attn"], cfg, ctx, positions,
                             kv_cache=kv_cache, cur_index=cur_index,
                             causal=True)
        else:
            o = attention(h, lp["self_attn"], cfg, ctx, positions,
                          causal=True)
        x = x + o
        h = norm(x, lp["ln_cross"], cfg.norm)
        o = attention(h, lp["cross_attn"], cfg, ctx, positions, xkv=memory,
                      causal=False)
        x = x + (o[0] if ctx.decode else o)
        return x + mlp(norm(x, lp["ln_mlp"], cfg.norm), lp["mlp"], cfg)

    body = ctx.remat_wrap(body)
    for i, lp in enumerate(params["dec_layers"]):
        kv_cache = (caches["k"][i], caches["v"][i]) if ctx.decode else None
        x = body(x, lp, kv_cache)
    x = norm(x, params["ln_dec_f"], cfg.norm)
    logits = torch.matmul(x, params["embed"].to(x.dtype).t())
    return logits, (caches if ctx.decode else None)


def init_whisper_caches(cfg: ModelConfig, batch: int, max_len: int,
                        dtype: torch.dtype = torch.bfloat16,
                        device: str | torch.device | None = None,
                        mesh=None, sp=None) -> Params:
    """The decoder's self-attention K and V caches [n_layers, batch,
    max_len, Hkv, D], zeros; their dtype must be the activations'.  A
    process ``mesh`` is refused: whisper's cached decode does not run
    there."""
    _check_audio(cfg)
    if mesh is not None and mesh.is_process_mesh:
        raise _cached_decode_refused()
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
