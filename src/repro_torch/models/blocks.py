"""Transformer building blocks of the DiT (plain functions on tensors).

Conventions, kept from the reference so weights cross over unchanged:
  * params are nested dicts of tensors; linear weights are [d_in, d_out]
    and are cast to the activation dtype at use.
  * the layer stack is a Python list of per-layer dicts (the reference
    stacks them on a leading "layers" axis for ``lax.scan``).
  * attention dispatches to ``core.sp_attention``; on one device that is
    the flash_mqkv kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..core import SPConfig, sp_attention

Params = dict[str, Any]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Without CUDA, ``None`` raises instead of running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def torch_dtype(name: str) -> torch.dtype:
    """ModelConfig.dtype ("float32", "bfloat16", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

class ParamBuilder:
    """Builds a params dict on one device from one ``torch.Generator``,
    with the reference's distributions (fan-in normal by default)."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device
        self.params: Params = {}

    def add(self, name: str, shape: tuple[int, ...], init: str = "normal",
            scale: float | None = None) -> None:
        kw = dict(dtype=self.dtype, device=self.device)
        if init == "normal":
            if scale is None:
                scale = shape[0] ** -0.5  # fan-in
            arr = torch.randn(shape, generator=self.generator, **kw) * scale
        elif init == "zeros":
            arr = torch.zeros(shape, **kw)
        elif init == "ones":
            arr = torch.ones(shape, **kw)
        else:
            raise ValueError(init)
        d = self.params
        keys = name.split("/")
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = arr


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """How a model runs: SP strategy, mode, device and SP degree (the
    number of ranks attention is spread over; 1 until the multi-rank
    schedules are ported)."""

    sp: SPConfig
    mode: str = "prefill"  # train | prefill | decode
    device: torch.device = torch.device("cpu")
    sp_degree: int = 1


# ---------------------------------------------------------------------------
# basic ops
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(dt)


def norm(x: torch.Tensor, p: Params, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def init_norm(b: ParamBuilder, name: str, d: int, kind: str) -> None:
    b.add(f"{name}/scale", (d,), init="ones")
    if kind == "layernorm":
        b.add(f"{name}/bias", (d,), init="zeros")


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_linear(b: ParamBuilder, name: str, d_in: int, d_out: int,
                bias: bool = False, init: str = "normal",
                scale: float | None = None) -> None:
    b.add(f"{name}/w", (d_in, d_out), init=init, scale=scale)
    if bias:
        b.add(f"{name}/b", (d_out,), init="zeros")


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, rot_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> (sin, cos) of shape [..., rot_dim // 2], f32."""
    exps = -torch.arange(0, rot_dim, 2, dtype=torch.float32,
                         device=positions.device) / rot_dim
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions[..., None].float() * freqs
    return torch.sin(ang), torch.cos(ang)


def _rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., :r/2], x[..., r/2:]) — GPT-NeoX convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(
    q: torch.Tensor,  # [B, L, H, D]
    k: torch.Tensor,
    positions: torch.Tensor,  # [B, L]
    *,
    variant: str,
    theta: float,
    rope_pct: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    if variant in ("none", "sinusoidal"):
        return q, k
    if variant != "rope":
        raise NotImplementedError(f"rope variant {variant!r} is not ported "
                                  "yet (ROADMAP Queue 1 item 11)")
    rot = int(q.shape[-1] * rope_pct) // 2 * 2
    sin, cos = _rope_angles(positions, rot, theta)
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]

    def rot_fn(x):
        xr, xp = x[..., :rot], x[..., rot:]
        return torch.cat([_rotate(xr, sin, cos).to(x.dtype), xp], dim=-1)

    return rot_fn(q), rot_fn(k)


def sinusoidal_embedding(length: int, d: int,
                         device: torch.device | None = None) -> torch.Tensor:
    """Whisper-style sinusoidal positional table [length, d], f32."""
    half = d // 2
    freqs = torch.exp(-torch.log(torch.tensor(10000.0)) * torch.arange(
        half, dtype=torch.float32) / (half - 1)).to(device)
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] \
        * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def init_attention(b: ParamBuilder, cfg) -> None:
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    init_linear(b, "attn/wq", d, hq * hd, bias=cfg.qkv_bias)
    init_linear(b, "attn/wk", d, hkv * hd, bias=cfg.qkv_bias)
    init_linear(b, "attn/wv", d, hkv * hd, bias=cfg.qkv_bias)
    init_linear(b, "attn/wo", hq * hd, d,
                scale=(hq * hd) ** -0.5 / (2 * cfg.n_layers) ** 0.5)


def attention(
    x: torch.Tensor,  # [B, L, d]
    p: Params,
    cfg,
    ctx: ParallelContext,
    positions: torch.Tensor,  # [B, L]
    *,
    causal: bool | None = None,
) -> torch.Tensor:
    """Self-attention block: projections, RoPE, SP attention, output
    projection.  Returns [B, L, d]."""
    b_, l_, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    causal = cfg.causal if causal is None else causal
    q = linear(x, p["wq"]).reshape(b_, l_, hq, hd)
    k = linear(x, p["wk"]).reshape(b_, l_, hkv, hd)
    v = linear(x, p["wv"]).reshape(b_, l_, hkv, hd)
    q, k = apply_rope(q, k, positions, variant=cfg.rope, theta=cfg.rope_theta,
                      rope_pct=cfg.rope_pct)
    o = sp_attention(q, k, v, cfg=ctx.sp, degree=ctx.sp_degree,
                     causal=causal)
    return linear(o.reshape(b_, l_, hq * hd), p["wo"])


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _check_act(cfg) -> None:
    if cfg.act != "gelu":
        raise NotImplementedError(f"MLP activation {cfg.act!r} is not ported "
                                  "yet (ROADMAP Queue 1 item 11)")


def init_mlp(b: ParamBuilder, cfg) -> None:
    _check_act(cfg)
    d, ff = cfg.d_model, cfg.d_ff
    init_linear(b, "mlp/wi_up", d, ff)
    init_linear(b, "mlp/wo", ff, d,
                scale=ff ** -0.5 / (2 * cfg.n_layers) ** 0.5)


def mlp(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    _check_act(cfg)
    return linear(gelu(linear(x, p["wi_up"])), p["wo"])
