"""Model registry: one uniform API over every ported architecture.

    bundle = get_model(cfg)
    params       = bundle.init(cfg, generator, device)
    loss, aux    = bundle.loss(params, batch, cfg, ctx)               # train
    out          = bundle.apply(params, batch, cfg, ctx)              # prefill
    out, caches  = bundle.step(params, batch, caches, idx, cfg, ctx)  # decode
    caches       = bundle.init_caches(cfg, batch, max_len, dtype, device)
    batch        = bundle.input_specs(cfg, shape, abstract=...)

On a process mesh (launch/procs.py) ``apply`` takes this process's batch
slice and sequence shard and the whole length as ``apply(...,
seq_len=)`` (whisper: ``enc_len=`` for the frames); ``step`` decodes one
position, whose caches are already the process's part, and needs none.

Three bundles, as the reference's: ``LM_BUNDLE`` for every LM family of
the port (rwkv6, dense, vlm, hybrid, moe), ``WHISPER_BUNDLE`` for the
audio family and ``DIT_BUNDLE`` for the DiTs (no decode step: sampling
loops over ``apply``).  Batches are plain dicts; modality frontends
(vision patches, audio frames) appear as precomputed embeddings.
``input_specs(abstract=True)`` gives meta tensors of the reference's
shapes and dtypes; with ``abstract=False`` it draws them from a
``torch.Generator`` (jax.random's streams cannot be reproduced, so tests
make batches with numpy and hand them to both packages).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape
from . import dit as dit_mod
from . import lm as lm_mod
from . import whisper as whisper_mod
from .blocks import resolve_device, torch_dtype

Batch = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    init: Callable
    loss: Callable  # (params, batch, cfg, ctx) -> (loss, aux)
    apply: Callable  # prefill: (params, batch, cfg, ctx) -> outputs
    step: Callable | None  # decode: (params, batch, caches, idx, cfg, ctx)
    init_caches: Callable | None
    input_specs: Callable  # (cfg, shape, abstract=True, generator=None) -> Batch


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, in float32."""
    lp = F.log_softmax(logits.float(), dim=-1)
    return -lp.gather(-1, labels[..., None].long())[..., 0].mean()


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _concretize(batch: Batch, cfg: ModelConfig,
                generator: torch.Generator | None, device) -> Batch:
    """Integers uniform in [0, max(vocab, 2)), floats N(0, 0.02²), on
    ``device`` (CUDA unless the caller asks otherwise)."""
    device = resolve_device(device)
    out = {}
    for name, s in batch.items():
        if s.dtype.is_floating_point:
            out[name] = (torch.randn(s.shape, generator=generator,
                                     device=device) * 0.02).to(s.dtype)
        else:
            out[name] = torch.randint(0, max(cfg.vocab, 2), s.shape,
                                      generator=generator, device=device,
                                      dtype=s.dtype)
    return out


# ---------------------------------------------------------------------------
# LM families (ssm / dense / vlm / hybrid / moe)
# ---------------------------------------------------------------------------

def _lm_inputs(cfg: ModelConfig, shape: InputShape, abstract=True,
               generator=None, dtype=None, device=None) -> Batch:
    dtype = torch_dtype(dtype or cfg.dtype)
    b, l = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        batch: Batch = {"tokens": _spec((b, 1), torch.int32)}
        if cfg.family == "vlm":
            batch["positions"] = _spec((3, b, 1), torch.int32)
    else:
        batch = {"tokens": _spec((b, l), torch.int32),
                 "labels": _spec((b, l), torch.int32)}
        if cfg.family == "vlm":
            # stub frontend: patch+text embeddings and 3D M-RoPE positions
            batch["inputs_embeds"] = _spec((b, l, cfg.d_model), dtype)
            batch["positions"] = _spec((3, b, l), torch.int32)
    if abstract:
        return batch
    return _concretize(batch, cfg, generator, device)


def _lm_loss(params, batch, cfg, ctx):
    logits, aux, _ = lm_mod.lm_forward(
        params, cfg, ctx,
        tokens=batch.get("tokens"),
        inputs_embeds=batch.get("inputs_embeds"),
        positions=batch.get("positions"),
    )
    return _xent(logits, batch["labels"]) + aux, aux


def _lm_apply(params, batch, cfg, ctx, last_only=False, seq_len=None):
    logits, _, _ = lm_mod.lm_forward(
        params, cfg, ctx,
        tokens=batch.get("tokens"),
        inputs_embeds=batch.get("inputs_embeds"),
        positions=batch.get("positions"),
        last_only=last_only,
        seq_len=seq_len,
    )
    return logits


def _lm_step(params, batch, caches, cur_index, cfg, ctx):
    logits, _, new_caches = lm_mod.lm_forward(
        params, cfg, ctx,
        tokens=batch.get("tokens"),
        positions=batch.get("positions"),
        caches=caches, cur_index=cur_index,
    )
    return logits[:, -1], new_caches


LM_BUNDLE = ModelBundle(
    init=lm_mod.init_lm,
    loss=_lm_loss,
    apply=_lm_apply,
    step=_lm_step,
    init_caches=lm_mod.init_lm_caches,
    input_specs=_lm_inputs,
)


# ---------------------------------------------------------------------------
# whisper (audio)
# ---------------------------------------------------------------------------

def _whisper_inputs(cfg, shape, abstract=True, generator=None, dtype=None,
                    device=None) -> Batch:
    dtype = torch_dtype(dtype or cfg.dtype)
    b, l = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        batch = {"tokens": _spec((b, 1), torch.int32),
                 "encoder_out": _spec((b, cfg.encoder_seq, cfg.d_model),
                                      dtype)}
    else:
        batch = {"frames": _spec((b, cfg.encoder_seq, cfg.d_model), dtype),
                 "tokens": _spec((b, l), torch.int32),
                 "labels": _spec((b, l), torch.int32)}
    if abstract:
        return batch
    return _concretize(batch, cfg, generator, device)


def _whisper_apply(params, batch, cfg, ctx, seq_len=None, enc_len=None):
    """On a process mesh ``seq_len`` is the whole token sequence and
    ``enc_len`` the whole frame sequence (``cfg.encoder_seq`` when None);
    ``batch`` holds this process's shards of both."""
    if enc_len is None and seq_len is not None:
        enc_len = cfg.encoder_seq
    memory = whisper_mod.encode(params, batch["frames"], cfg, ctx,
                                seq_len=enc_len)
    logits, _ = whisper_mod.decode_forward(
        params, cfg, ctx, tokens=batch["tokens"], memory=memory,
        seq_len=seq_len)
    return logits


def _whisper_loss(params, batch, cfg, ctx):
    logits = _whisper_apply(params, batch, cfg, ctx)
    return _xent(logits, batch["labels"]), torch.zeros(
        (), dtype=torch.float32, device=logits.device)


def _whisper_step(params, batch, caches, cur_index, cfg, ctx):
    logits, new_caches = whisper_mod.decode_forward(
        params, cfg, ctx, tokens=batch["tokens"], memory=batch["encoder_out"],
        caches=caches, cur_index=cur_index)
    return logits[:, -1], new_caches


WHISPER_BUNDLE = ModelBundle(
    init=whisper_mod.init_whisper,
    loss=_whisper_loss,
    apply=_whisper_apply,
    step=_whisper_step,
    init_caches=whisper_mod.init_whisper_caches,
    input_specs=_whisper_inputs,
)


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------

def _dit_inputs(cfg, shape, abstract=True, generator=None, dtype=None,
                device=None) -> Batch:
    dtype = torch_dtype(dtype or cfg.dtype)
    b, t = shape.global_batch, shape.seq_len
    batch = {
        "latents": _spec((b, t, dit_mod.LATENT_CHANNELS), dtype),
        "cond": _spec((b, dit_mod.COND_TOKENS, cfg.d_model), dtype),
        "timesteps": _spec((b,), torch.float32),
        "targets": _spec((b, t, dit_mod.LATENT_CHANNELS), dtype),
    }
    if abstract:
        return batch
    return _concretize(batch, cfg, generator, device)


def _dit_apply(params, batch, cfg, ctx):
    return dit_mod.dit_forward(params, cfg, ctx, latents=batch["latents"],
                               cond=batch["cond"],
                               timesteps=batch["timesteps"])


def _dit_loss(params, batch, cfg, ctx):
    v = _dit_apply(params, batch, cfg, ctx)
    loss = torch.mean((v.float() - batch["targets"].float()) ** 2)
    return loss, torch.zeros((), dtype=torch.float32, device=v.device)


DIT_BUNDLE = ModelBundle(
    init=dit_mod.init_dit,
    loss=_dit_loss,
    apply=_dit_apply,
    step=None,  # diffusion has no AR decode; sampling loops over apply
    init_caches=None,
    input_specs=_dit_inputs,
)


def get_model(cfg: ModelConfig) -> ModelBundle:
    """The bundle of ``cfg``'s family, as the reference picks it."""
    if cfg.family == "audio":
        return WHISPER_BUNDLE
    if cfg.family == "dit":
        return DIT_BUNDLE
    return LM_BUNDLE
