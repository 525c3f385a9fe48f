"""Decoder-only language model of the port: the attention-free RWKV6
family (``family == "ssm"``, rwkv6-1.6b) of the reference's unified
``models/lm.py``.

Per layer (the reference's ssm branch of ``_layer``):

  time mix    : token shift, data-dependent decay w = exp(-exp(w0 + lora)),
                the WKV recurrence over the sequence, per-head group norm,
                silu gate, output projection
  channel mix : token shift, squared-relu MLP, sigmoid receptance gate

Prefill runs the WKV recurrence through ``_distributed_scan_rwkv``: at SP
degree 1 that is the WKV kernel K5 (kernels/rwkv6_wkv.py), once per layer;
over a mesh of virtual ranks, K5 on every rank's shard plus the two-pass
distributed prefix scan of models/ssm.py.  Decode threads per-layer caches
(shift_tm, shift_cm, wkv_state) through ``rwkv6_decode_step``, with no
kernel.

The reference runs the layers in one ``lax.scan`` over stacked weights;
here they are a Python loop over a list of per-layer dicts, and caches
stay stacked on a leading layer axis, as the reference's.  The other
families (dense, moe, hybrid, vlm) and whisper are not ported yet
(ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rwkv6_wkv import rwkv6_wkv_heads
from . import ssm
from .blocks import (
    ParallelContext,
    ParamBuilder,
    Params,
    init_linear,
    init_norm,
    linear,
    norm,
    params_from_numpy,
    resolve_device,
    torch_dtype,
)

LM_ITEM = "ROADMAP Queue 1 item 7"


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.arch_id} ({cfg.family}): only the rwkv6 (ssm) language "
            f"model is ported; the other families wait for {LM_ITEM}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_rwkv_layer(b: ParamBuilder, cfg: ModelConfig) -> Params:
    b.params = {}
    d = cfg.d_model
    h = cfg.ssm.n_ssm_heads
    n = d // h
    init_norm(b, "ln_tm", d, cfg.norm)
    init_norm(b, "ln_cm", d, cfg.norm)
    for name in ("r", "k", "v", "g"):
        b.add(f"tm/mu_{name}", (d,), init="zeros")
        init_linear(b, f"tm/w{name}", d, d)
    b.add("tm/mu_w", (d,), init="zeros")
    b.add("tm/w0", (d,), init="zeros")
    lora = max(32, d // 32)
    init_linear(b, "tm/wlora_a", d, lora)
    init_linear(b, "tm/wlora_b", lora, d, init="zeros")
    b.add("tm/u", (h, n), init="zeros")
    b.add("tm/gn_scale", (d,), init="ones")
    init_linear(b, "tm/wo", d, d, scale=d ** -0.5 / (2 * cfg.n_layers) ** 0.5)
    # channel mix
    b.add("cm/mu_k", (d,), init="zeros")
    b.add("cm/mu_r", (d,), init="zeros")
    init_linear(b, "cm/wk", d, cfg.d_ff)
    init_linear(b, "cm/wv", cfg.d_ff, d,
                scale=cfg.d_ff ** -0.5 / (2 * cfg.n_layers) ** 0.5)
    init_linear(b, "cm/wr", d, d)
    return b.params


def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None,
            device: str | torch.device | None = None) -> Params:
    """Fresh LM parameters on ``device`` (CUDA by default), drawn from
    ``generator`` (one on that device; seeded with 0 when None), with the
    reference's shapes and distributions.  The decay base ``w0``, the bonus
    ``u``, every ``mu_*`` and ``wlora_b`` start at zero, as in the
    reference: perturb them before comparing anything."""
    _check_family(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    b = ParamBuilder(generator, torch_dtype(cfg.dtype), device)
    b.add("embed", (cfg.vocab, cfg.d_model), scale=0.02)
    if not cfg.tie_embeddings:
        init_linear(b, "lm_head", cfg.d_model, cfg.vocab)
    init_norm(b, "ln_f", cfg.d_model, cfg.norm)
    params = b.params
    params["layers"] = [_init_rwkv_layer(b, cfg) for _ in range(cfg.n_layers)]
    return params


def load_jax_lm_params(tree: Mapping[str, Any], cfg: ModelConfig,
                       device: str | torch.device | None = None) -> Params:
    """The weight bridge: the reference's ``init_lm`` parameter tree,
    converted to numpy by the caller, as this package's params (stacked
    layers split into one dict per layer, leaves cast to ``cfg.dtype`` on
    ``device``; nothing is transposed)."""
    _check_family(cfg)
    return params_from_numpy(tree, cfg, device)


def init_lm_caches(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device | None = None) -> Params:
    """Decode caches stacked over layers, as the reference's.  The token
    shift caches take the dtype of the activations they store from the
    first step on (the reference's scan outputs do the same); the WKV state
    stays float32."""
    _check_family(cfg)
    device = resolve_device(device)
    nl, h = cfg.n_layers, cfg.ssm.n_ssm_heads
    n = cfg.d_model // h
    return {
        "shift_tm": torch.zeros((nl, batch, 1, cfg.d_model), dtype=dtype,
                                device=device),
        "shift_cm": torch.zeros((nl, batch, 1, cfg.d_model), dtype=dtype,
                                device=device),
        "wkv_state": torch.zeros((nl, batch, h, n, n), dtype=torch.float32,
                                 device=device),
    }


# ---------------------------------------------------------------------------
# the RWKV6 mixers
# ---------------------------------------------------------------------------

def _sp_shards(x: torch.Tensor, ctx: ParallelContext) -> list[torch.Tensor]:
    """x [B, L, ...] split over the SP ranks along L (flat-rank order)."""
    mesh = ctx.mesh
    for a in ctx.sp.effective_batch_axes(mesh) or ():
        if mesh.shape[a] > 1:
            raise NotImplementedError(
                f"batch axis {a!r} of size {mesh.shape[a]}: sharding the "
                "batch over the mesh in the LM's SP prefill is not ported "
                "yet (ROADMAP Queue 1 item 7)")
    size = ctx.sp_degree
    if x.shape[1] % size:
        raise ValueError(f"sequence length {x.shape[1]} does not split "
                         f"evenly over SP degree {size}")
    return list(torch.chunk(x, size, dim=1))


def _token_shift(x: torch.Tensor, ctx: ParallelContext,
                 prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} with the boundary between SP ranks handled (the first token
    of rank p sees the last of rank p - 1; rank 0 sees zeros)."""
    if prev is not None:  # decode: previous token from the cache
        return prev
    size = ctx.sp_degree
    if size == 1:
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    shards = _sp_shards(x, ctx)
    (recv,) = ssm.shift_ranks(([s[:, -1:] for s in shards],),
                              ctx.sp.sp_axes, size, 1)
    recv[0] = torch.zeros_like(shards[0][:, :1])
    return torch.cat([torch.cat([recv[p], s[:, :-1]], dim=1)
                      for p, s in enumerate(shards)], dim=1)


def _distributed_scan_rwkv(r, k, v, w, u, ctx: ParallelContext):
    """The WKV recurrence of a whole sequence sharded over the SP ranks.
    Every rank's outputs with S_in = 0 come from K5; the rank's decay and
    final state, the exclusive prefix scan of those over the ranks and the
    influence of S_in are plain torch ops."""
    size = ctx.sp_degree
    if size == 1:
        return rwkv6_wkv_heads(r, k, v, w, u)
    shards = [_sp_shards(t, ctx) for t in (r, k, v, w)]
    outs, a_dev, s_out, infl = [], [], [], []
    for rp, kp, vp, wp in zip(*shards):
        outs.append(rwkv6_wkv_heads(rp, kp, vp, wp, u))
        a, s, i = ssm.rwkv6_shard_summary(rp, kp, vp, wp)
        a_dev.append(a)
        s_out.append(s)
        infl.append(i)
    s_in = ssm.distributed_state_in(a_dev, s_out, ctx.sp.sp_axes, size)
    return torch.cat([ssm.rwkv6_apply_influence(o, i, s)
                      for o, i, s in zip(outs, infl, s_in)], dim=1)


def _promoted_matmul(x: torch.Tensor, w: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """x @ w.astype(dtype) with JAX's type promotion of mixed operands."""
    dt = torch.promote_types(x.dtype, dtype)
    return torch.matmul(x.to(dt), w.to(dtype).to(dt))


def _rwkv_time_mix(x, p, cfg: ModelConfig, ctx: ParallelContext, cache):
    d = cfg.d_model
    h = cfg.ssm.n_ssm_heads
    n = d // h
    b_, l_, _ = x.shape
    prev = cache["shift_tm"] if ctx.decode else None
    xx = _token_shift(x, ctx, prev)
    mix = lambda mu: x + (xx - x) * mu
    r = linear(mix(p["mu_r"]), p["wr"]).reshape(b_, l_, h, n)
    k = linear(mix(p["mu_k"]), p["wk"]).reshape(b_, l_, h, n)
    v = linear(mix(p["mu_v"]), p["wv"]).reshape(b_, l_, h, n)
    g = F.silu(linear(mix(p["mu_g"]), p["wg"]))
    xw = mix(p["mu_w"])
    dd = _promoted_matmul(xw, p["wlora_a"]["w"], x.dtype)
    dd = _promoted_matmul(torch.tanh(dd), p["wlora_b"]["w"], x.dtype)
    w = torch.exp(-torch.exp(p["w0"].float() + dd.float()))
    w = w.reshape(b_, l_, h, n)

    if ctx.decode:
        o, s_new = ssm.rwkv6_decode_step(
            r[:, 0], k[:, 0], v[:, 0], w[:, 0], p["u"], cache["wkv_state"])
        o = o[:, None]
        new_cache = {"shift_tm": x, "wkv_state": s_new}
    else:
        o = _distributed_scan_rwkv(r, k, v, w, p["u"], ctx)
        new_cache = None
    # per-head group norm, in float32
    o = o.reshape(b_, l_, h, n)
    mu = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, correction=0)
    o = (o - mu) * torch.rsqrt(var + 1e-5)
    o = o.reshape(b_, l_, d) * p["gn_scale"].float()
    o = o.to(x.dtype) * g
    return linear(o, p["wo"]), new_cache


def _layer(x, lp, cfg: ModelConfig, ctx: ParallelContext, cache):
    """One RWKV6 layer.  Returns (x, new_cache)."""
    new_cache: dict[str, Any] = {}
    o, nc = _rwkv_time_mix(norm(x, lp["ln_tm"], cfg.norm), lp["tm"], cfg, ctx,
                           cache)
    if nc:
        new_cache.update(nc)
    x = x + o
    h_ = norm(x, lp["ln_cm"], cfg.norm)
    prev = cache["shift_cm"] if ctx.decode else None
    xx = _token_shift(h_, ctx, prev)
    if ctx.decode:
        new_cache["shift_cm"] = h_
    km = h_ + (xx - h_) * lp["cm"]["mu_k"]
    rm = h_ + (xx - h_) * lp["cm"]["mu_r"]
    kk = torch.square(F.relu(linear(km, lp["cm"]["wk"])))
    x = x + torch.sigmoid(linear(rm, lp["cm"]["wr"])) * linear(kk, lp["cm"]["wv"])
    return x, new_cache


def lm_forward(
    params: Params,
    cfg: ModelConfig,
    ctx: ParallelContext,
    *,
    tokens: torch.Tensor,  # [B, L] int
    caches: Params | None = None,  # decode caches, stacked over layers
    cur_index: Any = None,
    last_only: bool = False,  # prefill: logits for the final position only
) -> tuple[torch.Tensor, torch.Tensor, Params | None]:
    """Returns (logits [B, L, V] (or [B, 1, V] if last_only), aux, caches).

    ``cur_index`` (the decode position) is accepted for the reference's
    signature; the recurrent state needs no position.  As the reference's
    layer scan keeps its carry's dtype, every layer's output is cast back
    to the embedding's dtype: a bfloat16 model decoding from float32
    caches stays in bfloat16 between layers."""
    _check_family(cfg)
    x = params["embed"].to(torch_dtype(cfg.dtype))[tokens]
    per_layer = []
    for i, lp in enumerate(params["layers"]):
        cache = ({name: c[i] for name, c in caches.items()}
                 if caches is not None else None)
        y, new_cache = _layer(x, lp, cfg, ctx, cache)
        x = y.to(x.dtype)
        per_layer.append(new_cache)
    new_caches = None
    if caches is not None:
        new_caches = {name: torch.stack([c[name] for c in per_layer])
                      for name in caches}

    if last_only:
        x = x[:, -1:]
    x = norm(x, params["ln_f"], cfg.norm)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"].to(x.dtype).t())
    else:
        logits = linear(x, params["lm_head"])
    return logits, torch.zeros((), dtype=torch.float32, device=x.device), \
        new_caches
