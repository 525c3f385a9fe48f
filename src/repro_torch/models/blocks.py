"""Transformer building blocks of the DiT and the LM (plain functions on
tensors).

Conventions, kept from the reference so weights cross over unchanged:
  * params are nested dicts of tensors; linear weights are [d_in, d_out]
    and are cast to the activation dtype at use.
  * the layer stack is a Python list of per-layer dicts (the reference
    stacks them on a leading "layers" axis for ``lax.scan``).
  * attention dispatches to ``core.sp_attention`` over the context's mesh
    of virtual ranks (train/prefill; at SP degree 1 that is the flash_mqkv
    kernel) or to ``core.decode_attention`` (decode).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..core import (SPConfig, decode_attention, displaced_attention,
                   sp_attention)

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


def params_from_numpy(tree: Mapping[str, Any], cfg,
                      device: str | torch.device | None = None) -> Params:
    """A reference parameter tree, converted to numpy by the caller, as this
    package's params: the per-layer leaves the reference stacks on a
    leading layer axis (``layers``; whisper's ``enc_layers`` and
    ``dec_layers``) are split into one dict per layer; the [d_in, d_out]
    layout is kept, so nothing is transposed.  Leaves are cast to
    ``cfg.dtype`` on ``device``."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def leaf(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
            device=device, dtype=dtype)

    def convert(node, index=None):
        if isinstance(node, Mapping):
            return {k: convert(v, index) for k, v in node.items()}
        return leaf(node if index is None else np.asarray(node)[index])

    stacks = {"layers": cfg.n_layers, "enc_layers": cfg.encoder_layers,
              "dec_layers": cfg.n_layers}
    return {k: ([convert(v, i) for i in range(stacks[k])] if k in stacks
                else convert(v))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """How a model runs: SP strategy, mode, device and the mesh of virtual
    ranks attention is spread over (launch/mesh.py).  Without a mesh the
    model runs as on a 1-rank mesh on ``device``, which defaults to CUDA
    (and raises without it: pass device="cpu" for the plain path); with
    one, ``device`` is the mesh's."""

    sp: SPConfig
    mode: str = "prefill"  # train | prefill | decode
    device: torch.device | str | None = None
    mesh: Any = None  # launch.mesh.Mesh | None
    # decode-mode MoE: gather tokens over 'data' instead of all-gathering
    # FSDP'd expert weights every step (the reference's beyond-paper knob)
    ep_token_gather: bool = False
    # activation checkpointing of each layer in train mode: full —
    # recompute everything (least memory); dots — save the outputs of the
    # matrix products without batch dims (the reference's
    # dots_with_no_batch_dims_saveable); none — save all residuals
    remat: str = "full"

    def __post_init__(self):
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"remat {self.remat!r} is not one of "
                             f"{REMAT_POLICIES}")
        device = (self.mesh.device if self.mesh is not None
                  else resolve_device(self.device))
        object.__setattr__(self, "device", device)

    @property
    def decode(self) -> bool:
        return self.mode == "decode"

    @property
    def sp_degree(self) -> int:
        """Ranks attention is spread over: the mesh's SP axes."""
        if self.mesh is None:
            return 1
        return self.mesh.axes_size(self.sp.sp_axes)

    def remat_wrap(self, body: Callable) -> Callable:
        """``body`` (one layer) under this context's checkpoint policy in
        train mode, else ``body`` itself.  "full" runs it under
        ``torch.utils.checkpoint`` (non-reentrant): only its inputs are
        kept, and the backward runs it again; "dots" keeps the outputs of
        its 2-D matrix products (aten mm/addmm: the projections, not the
        batched products of plain attention) and recomputes the rest."""
        if self.mode != "train" or self.remat == "none":
            return body
        kw = {}
        if self.remat == "dots":
            kw["context_fn"] = functools.partial(
                torch.utils.checkpoint.create_selective_checkpoint_contexts,
                _save_dots)
        return functools.partial(torch.utils.checkpoint.checkpoint, body,
                                 use_reentrant=False, **kw)


REMAT_POLICIES = ("full", "dots", "none")


def inference_on_processes(ctx: ParallelContext) -> bool:
    """Whether ``ctx`` runs on a process mesh (launch/procs.py), where any
    call that could want a gradient (train mode, or grad mode on) is
    refused: the puts of the token shifts, the state passes and SP
    attention are differentiable on a mesh of virtual ranks only."""
    procs = ctx.mesh is not None and ctx.mesh.is_process_mesh
    if procs and (ctx.mode == "train" or torch.is_grad_enabled()):
        raise NotImplementedError(
            "training over a process mesh is a later slice (ROADMAP Queue 1 "
            "item 12); run the forward under torch.inference_mode()")
    return procs


def held_shard(ctx: ParallelContext, length: int,
               seq_len: int | None) -> tuple[int, int]:
    """The rows [start, stop) of a ``seq_len``-long sequence that this
    process holds on a process mesh (``mesh.held_rows`` over the SP
    axes); the ``length`` rows it was given must be that many."""
    if seq_len is None:
        raise ValueError("a process mesh's forward needs seq_len")
    start, stop = ctx.mesh.held_rows(ctx.sp.sp_axes, seq_len)
    if length != stop - start:
        raise ValueError(f"a shard of {length} rows: this process holds "
                         f"rows [{start}, {stop}) of {seq_len}")
    return start, stop


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpoint policy of remat "dots": save the outputs of
    matrix products without batch dims, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


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

def _rope_freqs(rot_dim: int, theta: float, device) -> torch.Tensor:
    """The [rot_dim // 2] f32 rotary frequencies, taken in float64 on the
    host and rounded once, so every device gets the same table."""
    return device_constant(
        ("rope", rot_dim, theta), device,
        lambda: torch.tensor([theta ** (-i / rot_dim)
                              for i in range(0, rot_dim, 2)],
                             dtype=torch.float32))


def _rope_angles(positions: torch.Tensor, rot_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> (sin, cos) of shape [..., rot_dim // 2], f32.

    The frequencies, and the sine and cosine of the f32 angles, are taken
    in float64 and rounded once to f32, so every device gets the same
    table.  A device's own f32 pow and sin differ by an ulp or two, and at
    position p an ulp of a frequency moves the angle by p ulps: ~1e-4 rad
    at p ~ 1000, which peaked attention amplifies."""
    freqs = _rope_freqs(rot_dim, theta, positions.device)
    ang = (positions[..., None].float() * freqs).double()
    return torch.sin(ang).float(), torch.cos(ang).float()


_CONSTANTS: dict[tuple, torch.Tensor] = {}


def device_constant(key: tuple, device: torch.device | str | None,
                    make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``make()`` (a host tensor) on ``device``, made and moved once per
    (key, device).  A step captured as a CUDA graph cannot copy from the
    host while it is captured; its eager warm-up fills this cache."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    t = _CONSTANTS.get((key, device))
    if t is None:
        # outside inference mode: the table outlives the step that made it
        with torch.inference_mode(False):
            t = _CONSTANTS[(key, device)] = make().to(device)
    return t


def _rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., :r/2], x[..., r/2:]) — GPT-NeoX convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _mrope_angles(positions: torch.Tensor, rot_dim: int,
                  theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (qwen2-vl §2.1): positions [3, B, L] of the (t, h, w)
    components, each over one of three sections of the rotary half-dims
    (sizes ~ equal thirds, the last takes the remainder) -> (sin, cos)
    [B, L, rot_dim // 2], with _rope_angles' float64 table."""
    freqs = _rope_freqs(rot_dim, theta, positions.device)
    half = rot_dim // 2
    s1, s2 = half // 3, 2 * (half // 3)
    ang = torch.cat([positions[c][..., None].float() * freqs[lo:hi]
                     for c, (lo, hi) in enumerate(((0, s1), (s1, s2),
                                                   (s2, half)))], dim=-1)
    ang = ang.double()
    return torch.sin(ang).float(), torch.cos(ang).float()


def apply_rope(
    q: torch.Tensor,  # [B, L, H, D]
    k: torch.Tensor,
    positions: torch.Tensor,  # [B, L] or [3, B, L] for mrope
    *,
    variant: str,
    theta: float,
    rope_pct: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary embedding of q and k, every variant of the reference: "rope"
    (partial with ``rope_pct``, stablelm), "rope2d" (chatglm: the first
    D/2 dims, rotated with the NeoX half split as the reference's code
    does, not in the interleaved pairs its config's comment names) and
    "mrope" (qwen2-vl's three position components)."""
    if variant in ("none", "sinusoidal"):
        return q, k
    d = q.shape[-1]
    if variant == "rope2d":
        rot = d // 2  # chatglm: rotary on half the head dim
    else:
        rot = int(d * rope_pct) // 2 * 2
    if variant == "mrope":
        sin, cos = _mrope_angles(positions, rot, theta)
    elif variant in ("rope", "rope2d"):
        sin, cos = _rope_angles(positions, rot, theta)
    else:
        raise ValueError(f"unknown rope variant {variant!r}")
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]

    def rot_fn(x):
        xr, xp = x[..., :rot], x[..., rot:]
        return torch.cat([_rotate(xr, sin, cos).to(x.dtype), xp], dim=-1)

    return rot_fn(q), rot_fn(k)


def sinusoidal_rows(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Rows ``positions`` (integers, any shape) of the Whisper-style
    sinusoidal table: [..., d] f32, each row f32(position) * freqs as the
    reference's full table computes it, so one row needs no table."""
    half = d // 2
    freqs = device_constant(
        ("sinusoidal", half), positions.device,
        lambda: torch.exp(-torch.log(torch.tensor(10000.0)) * torch.arange(
            half, dtype=torch.float32) / (half - 1)))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_embedding(length: int, d: int,
                         device: torch.device | None = None) -> torch.Tensor:
    """Whisper-style sinusoidal positional table [length, d], f32."""
    return sinusoidal_rows(torch.arange(length, device=device), d)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def init_attention(b: ParamBuilder, cfg, prefix: str = "attn") -> None:
    """The attention's projections under ``prefix`` (whisper's decoder:
    ``self_attn`` and ``cross_attn``)."""
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    init_linear(b, f"{prefix}/wq", d, hq * hd, bias=cfg.qkv_bias)
    init_linear(b, f"{prefix}/wk", d, hkv * hd, bias=cfg.qkv_bias)
    init_linear(b, f"{prefix}/wv", d, hkv * hd, bias=cfg.qkv_bias)
    init_linear(b, f"{prefix}/wo", hq * hd, d,
                scale=(hq * hd) ** -0.5 / (2 * cfg.n_layers) ** 0.5)


def attention(
    x: torch.Tensor,  # [B, L, d]
    p: Params,
    cfg,
    ctx: ParallelContext,
    positions: torch.Tensor,  # [B, L] or [3, B, L] (mrope)
    *,
    window: int | None = None,
    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cur_index: torch.Tensor | int | None = None,
    xkv: torch.Tensor | None = None,  # cross-attention source (whisper)
    causal: bool | None = None,
    extra_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    return_kv: bool = False,
):
    """Attention block: projections, RoPE, SP attention, output
    projection.  Returns [B, L, d]; in decode mode ``(out, (k_cache,
    v_cache))``.

    ``window`` — sliding-window size (keys in (q - window, q]); None is
    global attention.

    Decode (``ctx.decode``): the new token's K/V go into ``kv_cache`` at
    ``cur_index`` and q attends the cache through ``core.decode_attention``
    (the cache is sharded on L over the SP ranks and written in place; on
    a process mesh ``kv_cache`` is this process's part of it).

    On a process mesh ``x`` and ``positions`` are this process's sequence
    shard (the positions its rows' own) and the output covers its rows.

    ``extra_kv`` — one-step-stale full-sequence KV of the *non-resident*
    rows for the displaced patch pipeline (K already post-RoPE): the
    patch's fresh KV and these rows are attended as two segments of one
    carried softmax (core/pipefusion.py ``displaced_attention``) instead
    of the SP schedule.  Only for non-causal, unwindowed attention (DiT).

    ``return_kv`` — also return this call's (post-RoPE K, V), as
    ``(out, (k, v))``, so the sampler can populate the stale-KV state.

    ``xkv`` [B, T, d] — cross-attention (whisper's decoder): K and V are
    projected from ``xkv``, nothing is rotated, and in decode mode the one
    query attends the whole source unsharded (strategy "full", as the
    reference's ``_xattn_cfg``), returning ``(out, kv_cache)``.
    """
    b_, l_, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    causal = cfg.causal if causal is None else causal
    src = x if xkv is None else xkv
    q = linear(x, p["wq"]).reshape(b_, l_, hq, hd)
    k = linear(src, p["wk"]).reshape(b_, src.shape[1], hkv, hd)
    v = linear(src, p["wv"]).reshape(b_, src.shape[1], hkv, hd)
    if xkv is None:  # no rope on cross-attention
        q, k = apply_rope(q, k, positions, variant=cfg.rope,
                          theta=cfg.rope_theta, rope_pct=cfg.rope_pct)
    if extra_kv is not None:
        if causal or ctx.decode or window is not None or xkv is not None:
            raise ValueError("displaced attention is DiT-only "
                             "(bidirectional, unwindowed self-attention "
                             "prefill)")
        o = displaced_attention(q, k, v, extra_kv[0], extra_kv[1])
    elif ctx.decode and xkv is not None:
        o = sp_attention(q, k, v, cfg=dataclasses.replace(ctx.sp,
                                                          strategy="full"),
                         mesh=ctx.mesh, causal=False, window=None)
        return linear(o.reshape(b_, l_, hq * hd), p["wo"]), kv_cache
    elif ctx.decode:
        if kv_cache is None or cur_index is None:
            raise ValueError("decode attention needs kv_cache and cur_index")
        o, kc, vc = decode_attention(q, kv_cache[0], kv_cache[1], k, v,
                                     cur_index, mesh=ctx.mesh, cfg=ctx.sp,
                                     window=window)
        return linear(o.reshape(b_, l_, hq * hd), p["wo"]), (kc, vc)
    else:
        o = sp_attention(q, k, v, cfg=ctx.sp, mesh=ctx.mesh, causal=causal,
                         window=window)
    out = linear(o.reshape(b_, l_, hq * hd), p["wo"])
    return (out, (k, v)) if return_kv else out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(b: ParamBuilder, cfg, prefix: str = "mlp",
             d_ff: int | None = None) -> None:
    """The MLP's weights under ``prefix`` (the moe family's ``shared_mlp``
    and ``dense_mlp`` too), of hidden size ``d_ff`` (``cfg.d_ff`` when
    None)."""
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        init_linear(b, f"{prefix}/wi_gate", d, ff)
    init_linear(b, f"{prefix}/wi_up", d, ff)
    init_linear(b, f"{prefix}/wo", ff, d,
                scale=ff ** -0.5 / (2 * cfg.n_layers) ** 0.5)


def mlp(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    if cfg.act == "swiglu":
        h = F.silu(linear(x, p["wi_gate"])) * linear(x, p["wi_up"])
    elif cfg.act == "geglu":
        h = gelu(linear(x, p["wi_gate"])) * linear(x, p["wi_up"])
    else:
        h = gelu(linear(x, p["wi_up"]))
    return linear(h, p["wo"])
