"""Decoder-only language models of the port, the reference's unified
``models/lm.py``: the attention-free RWKV6 family (``family == "ssm"``,
rwkv6-1.6b), the attention families ``dense`` (qwen2-1.5b, stablelm-3b,
starcoder2-7b, chatglm3-6b) and ``vlm`` (qwen2-vl-2b's backbone), the
``hybrid`` family (hymba-1.5b) and the ``moe`` family (qwen2-moe-a2.7b,
arctic-480b).

Per layer (the reference's ``_layer``):

  rwkv6  : time mix (token shift, data-dependent decay, the WKV recurrence,
           group norm, silu gate) and channel mix (token shift, squared-relu
           MLP, sigmoid gate)
  dense  : norm -> attention (RoPE variant, GQA, causal, sliding window)
           -> residual; norm -> MLP (swiglu / geglu / gelu) -> residual
  hybrid : attention ∥ SSD branch on the same normed input, mean-combined;
           layers {0, n/2, n-1} global, the rest windowed
  moe    : attention; routed experts (models/moe.py) plus shared experts
           (qwen2-moe) or a dense residual MLP (arctic)

rwkv6 prefill runs the WKV recurrence through ``_distributed_scan_rwkv``:
at SP degree 1 that is the WKV kernel K5 (kernels/rwkv6_wkv.py), once per
layer; over a mesh of virtual ranks, K5 on every rank's shard plus the
two-pass distributed prefix scan of models/ssm.py.  The SSD branch runs
the same two passes over plain torch chunk scans.  Attention prefill runs
``core.sp_attention``: K1 at degree 1, the SP schedule (K1, K2 and the
put kernels) over a mesh.  Batch axes of the mesh split the batch into
slices, each with its own SP ranks.  Decode threads per-layer caches:
(shift_tm, shift_cm, wkv_state) through ``rwkv6_decode_step``, the
attention KV caches, sharded on L over the SP ranks, through
``core.decode_attention`` (plain torch, as the reference's), and the SSD
state through ``ssd_decode_step``; attention and SSD caches are written
in place.

The reference runs the layers in one ``lax.scan`` over stacked weights;
here they are a Python loop over a list of per-layer dicts, and caches
stay stacked on a leading layer axis, as the reference's.  In train mode
each layer runs under ``ctx.remat_wrap`` (activation checkpointing), as
the reference's scan body does; every family trains, at SP degree 1 and
over a mesh (the WKV scan's gradient is K5b, attention's K1b, and the
token shifts' and state passes' puts are differentiable, comm/grad.py).
Whisper is models/whisper.py.

Over a process mesh (launch/procs.py) each process runs its batch slice
and its run of SP ranks' sequence shards (``lm_forward(..., seq_len=)``):
the rank lists of the token shifts and the state passes hold its owned
entries and carry their owner map, K5 runs on each owned shard, and the
KV caches are its part (``init_lm_caches`` with the mesh); the MoE
layer's experts are its EP ranks' (``moe.held_experts``), its exchange and
its gathers puts (models/moe.py), and its aux already the mean over every
mesh point.  Training is refused there (``check_process_mesh``).
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F

from ..comm.channel import owned_ranks, rank_map
from ..comm.kernel_backend import process_step
from ..configs.base import ModelConfig
from ..core.decode import device_index
from ..kernels.rwkv6_wkv import rwkv6_wkv_heads
from . import ssm
from .moe import (check_held_experts, held_layer, init_moe, moe_block,
                  padded_n_experts, ep_degree as moe_ep_degree)
from .blocks import (
    ParallelContext,
    ParamBuilder,
    Params,
    attention,
    held_shard,
    inference_on_processes,
    init_attention,
    init_linear,
    init_mlp,
    init_norm,
    linear,
    mlp,
    norm,
    params_from_numpy,
    resolve_device,
    torch_dtype,
)


GLOBAL_WINDOW = 1 << 30  # "window" value meaning full/global attention

ATTENTION_FAMILIES = ("dense", "vlm", "hybrid", "moe")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "ssm" and cfg.family not in ATTENTION_FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch_id} ({cfg.family}): the port's language models are "
            f"the rwkv6 (ssm), dense, vlm, hybrid and moe families; the "
            f"{cfg.family} family is models/whisper.py or models/dit.py")


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


def _init_ssd_branch(b: ParamBuilder, cfg: ModelConfig) -> None:
    d = cfg.d_model
    h = cfg.ssm.n_ssm_heads
    p_ = (d * cfg.ssm.expand) // h
    n = cfg.ssm.state_size
    init_linear(b, "ssd/in_x", d, h * p_)
    init_linear(b, "ssd/in_z", d, h * p_)
    init_linear(b, "ssd/in_dt", d, h)
    init_linear(b, "ssd/in_b", d, h * n)
    init_linear(b, "ssd/in_c", d, h * n)
    b.add("ssd/a_log", (h,), init="zeros")
    b.add("ssd/norm_scale", (h * p_,), init="ones")
    init_linear(b, "ssd/out", h * p_, d,
                scale=(h * p_) ** -0.5 / (2 * cfg.n_layers) ** 0.5)


def _init_attention_layer(b: ParamBuilder, cfg: ModelConfig,
                          ep_degree: int) -> Params:
    """A dense / vlm / hybrid / moe layer (the reference's
    ``_init_layer``): the moe family's experts padded to a multiple of
    ``ep_degree``."""
    b.params = {}
    init_norm(b, "ln_attn", cfg.d_model, cfg.norm)
    init_attention(b, cfg)
    if cfg.family == "hybrid":
        _init_ssd_branch(b, cfg)
    init_norm(b, "ln_mlp", cfg.d_model, cfg.norm)
    if cfg.family == "moe":
        init_moe(b, cfg, n_pad_experts=padded_n_experts(cfg, ep_degree)
                 - cfg.moe.n_experts)
        if cfg.moe.n_shared_experts:
            init_mlp(b, cfg, prefix="shared_mlp",
                     d_ff=cfg.moe.moe_d_ff * cfg.moe.n_shared_experts)
        if cfg.moe.dense_residual:
            init_mlp(b, cfg, prefix="dense_mlp", d_ff=cfg.d_ff)
    else:
        init_mlp(b, cfg)
    return b.params


def init_lm(cfg: ModelConfig, generator: torch.Generator | None = None,
            device: str | torch.device | None = None,
            ep_degree: int | None = None, mesh=None) -> Params:
    """Fresh LM parameters on ``device`` (CUDA by default), drawn from
    ``generator`` (one on that device; seeded with 0 when None), with the
    reference's shapes and distributions.  The decay base ``w0``, the bonus
    ``u``, every ``mu_*`` and ``wlora_b`` start at zero, as in the
    reference: perturb them before comparing anything.  An attention
    model's biases and the SSD's ``a_log`` start at zero and its norms at
    one, as the reference's.  A moe model's experts are padded to
    ``padded_n_experts(cfg, ep_degree)``, to split over an EP axis of that
    size (by default the 'model' axis of ``mesh``, 1 without one).  On a
    process ``mesh`` each MoE layer's experts are cut to the process's EP
    ranks' as the layer is built (``moe.held_layer``: the same values as
    cutting the whole, which is never held at once)."""
    _check_family(cfg)
    device = resolve_device(device)
    if ep_degree is None:
        ep_degree = moe_ep_degree(mesh)
    if generator is None and device.type != "meta":  # meta draws nothing
        generator = torch.Generator(device=device).manual_seed(0)
    b = ParamBuilder(generator, torch_dtype(cfg.dtype), device)
    b.add("embed", (cfg.vocab, cfg.d_model), scale=0.02)
    if not cfg.tie_embeddings:
        init_linear(b, "lm_head", cfg.d_model, cfg.vocab)
    init_norm(b, "ln_f", cfg.d_model, cfg.norm)
    params = b.params
    if cfg.family == "ssm":
        layers = [_init_rwkv_layer(b, cfg) for _ in range(cfg.n_layers)]
    else:
        layers = []
        for _ in range(cfg.n_layers):
            lp = _init_attention_layer(b, cfg, ep_degree)
            if cfg.family == "moe":
                lp["moe"] = held_layer(lp["moe"], cfg, mesh)
            layers.append(lp)
        if (cfg.family == "moe" and device.type == "cuda"
                and mesh is not None and mesh.is_process_mesh):
            torch.cuda.empty_cache()  # the whole layers' experts, freed
    params["layers"] = layers
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
                   device: str | torch.device | None = None,
                   mesh=None, sp=None) -> Params:
    """Decode caches stacked over layers, as the reference's.  rwkv6: the
    token shift caches take the dtype of the activations they store from
    the first step on (the reference's scan outputs do the same); the WKV
    state stays float32.  Attention: the K and V caches [n_layers, batch,
    max_len, Hkv, D], sharded on max_len over the SP ranks in decode; their
    dtype must be the activations' (``core.decode_attention``).  hymba
    adds the SSD state [n_layers, batch, H, P, N], float32.

    On a process ``mesh`` (with ``sp``, the SPConfig) the caches are this
    process's part, on the mesh's device: its batch slice of the
    ``batch`` slots and its SP ranks' ``max_len x held / SP`` positions;
    the SSD state and the rwkv6 caches are whole over the SP ranks of the
    slice."""
    _check_family(cfg)
    if mesh is not None and mesh.is_process_mesh:
        if sp is None:
            raise ValueError("a process mesh's caches need the SPConfig")
        device = mesh.device
        rows = mesh.held_batch(sp.effective_batch_axes(mesh) or (), batch)
        batch = rows.stop - rows.start
        start, stop = mesh.held_rows(sp.sp_axes, max_len)
        max_len = stop - start
    device = resolve_device(device)
    nl = cfg.n_layers
    zeros = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt,
                                                device=device)
    if cfg.family in ATTENTION_FAMILIES:
        shape = (nl, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        c = {"k": zeros(shape), "v": zeros(shape)}
        if cfg.family == "hybrid":
            h = cfg.ssm.n_ssm_heads
            p_ = (cfg.d_model * cfg.ssm.expand) // h
            c["ssd_state"] = zeros((nl, batch, h, p_, cfg.ssm.state_size),
                                   torch.float32)
        return c
    h = cfg.ssm.n_ssm_heads
    n = cfg.d_model // h
    return {
        "shift_tm": zeros((nl, batch, 1, cfg.d_model)),
        "shift_cm": zeros((nl, batch, 1, cfg.d_model)),
        "wkv_state": zeros((nl, batch, h, n, n), torch.float32),
    }


# ---------------------------------------------------------------------------
# the RWKV6 mixers
# ---------------------------------------------------------------------------

def _batch_slices(ctx: ParallelContext) -> int:
    """Batch slices of the mesh: the product of its batch axes."""
    mesh = ctx.mesh
    if mesh is None:
        return 1
    return mesh.axes_size(ctx.sp.effective_batch_axes(mesh) or ())


def _owners(ctx: ParallelContext):
    """On a process mesh, the owner map of the (batch slice, SP rank)
    lists (launch.mesh.OwnerMap over the batch and SP axes); else None."""
    mesh = ctx.mesh
    if mesh is None or not mesh.is_process_mesh:
        return None
    return mesh.owner_map(tuple(ctx.sp.effective_batch_axes(mesh) or ())
                          + tuple(ctx.sp.sp_axes))


def _sp_shards(x: torch.Tensor, ctx: ParallelContext) -> list[torch.Tensor]:
    """x [B, L, ...] split over the batch slices on B and the SP ranks on
    L: one shard per (slice, SP rank), slice-major, as the reference's
    shard_map places them.  On a process mesh x is this process's part
    (its batch slice, its run of SP ranks' shards): the list holds its
    owned entries and None for the others."""
    owners = _owners(ctx)
    if owners is not None:
        owned = owners.owned
        if x.shape[1] % len(owned):
            raise ValueError(f"a shard of {x.shape[1]} rows does not split "
                             f"evenly over this process's {len(owned)} SP "
                             "ranks")
        parts = dict(zip(owned, torch.chunk(x, len(owned), dim=1)))
        return [parts.get(p) for p in range(owners.size)]
    slices, size = _batch_slices(ctx), ctx.sp_degree
    if x.shape[0] % slices:
        raise ValueError(f"batch {x.shape[0]} does not split evenly over "
                         f"{slices} batch slices")
    if x.shape[1] % size:
        raise ValueError(f"sequence length {x.shape[1]} does not split "
                         f"evenly over SP degree {size}")
    return [c for xs in torch.chunk(x, slices, dim=0)
            for c in torch.chunk(xs, size, dim=1)]


def _sp_join(parts: list[torch.Tensor], ctx: ParallelContext) -> torch.Tensor:
    """The inverse of ``_sp_shards``."""
    if _owners(ctx) is not None:
        return torch.cat([p for p in parts if p is not None], dim=1)
    size = ctx.sp_degree
    return torch.cat([torch.cat(parts[i:i + size], dim=1)
                      for i in range(0, len(parts), size)], dim=0)


def _token_shift(x: torch.Tensor, ctx: ParallelContext,
                 prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} with the boundary between SP ranks handled (the first token
    of rank p sees the last of rank p - 1; rank 0 sees zeros).  Over a
    mesh the boundary rows move in one put (on a process mesh, one step
    of the heap's fence)."""
    if prev is not None:  # decode: previous token from the cache
        return prev
    size = ctx.sp_degree
    if size == 1:
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    shards = _sp_shards(x, ctx)
    with process_step(x.device):
        (recv,) = ssm.shift_ranks((rank_map(lambda s: s[:, -1:], shards),),
                                  ctx.sp.sp_axes, size, 1,
                                  _batch_slices(ctx), _owners(ctx))
    return _sp_join([None if s is None else torch.cat(
        [torch.zeros_like(s[:, :1]) if r is None else r, s[:, :-1]], dim=1)
        for r, s in zip(recv, shards)], ctx)


def _distributed_scan_rwkv(r, k, v, w, u, ctx: ParallelContext):
    """The WKV recurrence of a whole sequence sharded over the SP ranks.
    Every rank's outputs with S_in = 0 come from K5; the rank's decay and
    final state, the exclusive prefix scan of those over the ranks and the
    influence of S_in are plain torch ops.  On a process mesh K5 runs on
    each SP rank's shard this process holds."""
    size = ctx.sp_degree
    if size == 1:
        return rwkv6_wkv_heads(r, k, v, w, u)
    shards = [_sp_shards(t, ctx) for t in (r, k, v, w)]
    n = len(shards[0])
    outs, a_dev, s_out, infl = ([None] * n for _ in range(4))
    for p in owned_ranks(shards[0]):
        rp, kp, vp, wp = (t[p] for t in shards)
        outs[p] = rwkv6_wkv_heads(rp, kp, vp, wp, u)
        a_dev[p], s_out[p], infl[p] = ssm.rwkv6_shard_summary(rp, kp, vp, wp)
    s_in = ssm.distributed_state_in(a_dev, s_out, ctx.sp.sp_axes, size,
                                    _batch_slices(ctx), _owners(ctx))
    return _sp_join(rank_map(ssm.rwkv6_apply_influence, outs, infl, s_in),
                    ctx)


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


def _hymba_ssd(x, p, cfg: ModelConfig, ctx: ParallelContext, cache):
    """The SSD branch.  Returns (out, the new SSD state in decode, else
    None)."""
    h = cfg.ssm.n_ssm_heads
    d_in = cfg.d_model * cfg.ssm.expand
    p_ = d_in // h
    n = cfg.ssm.state_size
    b_, l_, _ = x.shape
    xs = linear(x, p["in_x"]).reshape(b_, l_, h, p_)
    z = F.silu(linear(x, p["in_z"]))
    dt = F.softplus(linear(x, p["in_dt"]))
    bm = linear(x, p["in_b"]).reshape(b_, l_, h, n)
    cm = linear(x, p["in_c"]).reshape(b_, l_, h, n)
    a = -torch.exp(p["a_log"].float())

    state = None
    if ctx.decode:
        o, state = ssm.ssd_decode_step(xs[:, 0], dt[:, 0], bm[:, 0],
                                       cm[:, 0], a, cache["ssd_state"])
        o = o[:, None].to(x.dtype)
    else:
        o = _distributed_scan_ssd(xs, dt, bm, cm, a, ctx).to(x.dtype)
    o = o.reshape(b_, l_, d_in)
    of = o.float()
    of = of * torch.rsqrt((of * of).mean(dim=-1, keepdim=True) + 1e-6)
    o = (of * p["norm_scale"].float()).to(x.dtype) * z
    return linear(o, p["out"]), state


def _distributed_scan_ssd(xs, dt, bm, cm, a, ctx: ParallelContext):
    """The SSD recurrence of a whole sequence sharded over the SP ranks
    (each batch slice on its own): every rank's chunk scan with S_in = 0,
    the exclusive prefix scan of the ranks' (decay, state) and the
    influence of S_in."""
    size = ctx.sp_degree
    if size == 1:
        res = ssm.ssd_chunk_scan(xs, dt, bm, cm, a)
        return ssm.ssd_apply_influence(res.out, res.infl,
                                       torch.zeros_like(res.s_out))
    res = rank_map(lambda *t: ssm.ssd_chunk_scan(*t, a),
                   *(_sp_shards(t, ctx) for t in (xs, dt, bm, cm)))
    s_in = ssm.distributed_state_in(rank_map(lambda r: r.a_dev, res),
                                    rank_map(lambda r: r.s_out, res),
                                    ctx.sp.sp_axes, size, _batch_slices(ctx),
                                    _owners(ctx))
    return _sp_join(rank_map(lambda r, s: ssm.ssd_apply_influence(
        r.out, r.infl, s), res, s_in), ctx)


def _attention_layer(x, lp, cfg: ModelConfig, ctx: ParallelContext,
                     positions, window, cache, cur_index):
    """One dense / vlm / hybrid / moe layer (the reference's attention
    branch of ``_layer``).  Returns (x, aux, the new SSD state or None);
    the KV caches are written in place."""
    h_ = norm(x, lp["ln_attn"], cfg.norm)
    if ctx.decode:
        attn_out, _ = attention(
            h_, lp["attn"], cfg, ctx, positions, window=window,
            kv_cache=(cache["k"], cache["v"]), cur_index=cur_index)
    else:
        attn_out = attention(h_, lp["attn"], cfg, ctx, positions,
                             window=window)
    state = None
    if cfg.family == "hybrid":
        ssd_out, state = _hymba_ssd(h_, lp["ssd"], cfg, ctx, cache)
        x = x + (attn_out + ssd_out) * 0.5
    else:
        x = x + attn_out
    h_ = norm(x, lp["ln_mlp"], cfg.norm)
    aux = None
    if cfg.family == "moe":
        y, aux = moe_block(h_, lp["moe"], cfg, ctx)
        if cfg.moe.n_shared_experts:
            y = y + mlp(h_, lp["shared_mlp"], cfg)
        if cfg.moe.dense_residual:
            y = y + mlp(h_, lp["dense_mlp"], cfg)
        x = x + y
        aux = aux * cfg.moe.router_aux_coef
    else:
        x = x + mlp(h_, lp["mlp"], cfg)
    return x, aux, state


def _per_layer_windows(cfg: ModelConfig) -> list[int | None]:
    """hymba: layers {0, mid, last} global (GLOBAL_WINDOW), the rest
    sliding-window.  Other archs with cfg.window: uniform window.  None:
    fully global."""
    if cfg.family == "hybrid" and cfg.window:
        glb = {0, cfg.n_layers // 2, cfg.n_layers - 1}
        return [GLOBAL_WINDOW if i in glb else cfg.window
                for i in range(cfg.n_layers)]
    return [cfg.window or None] * cfg.n_layers


def _default_positions(cfg: ModelConfig, ctx: ParallelContext, b: int,
                       l: int, cur_index, device,
                       start: int = 0) -> torch.Tensor:
    """[B, L] token positions, rows ``start`` on of the sequence (decode:
    the one position ``cur_index``), or [3, B, L] with the three M-RoPE
    components equal."""
    if ctx.decode:
        if cur_index is None:
            raise ValueError("decode needs cur_index")
        base = cur_index.expand(b, 1)
    else:
        base = torch.arange(start, start + l, device=device)[None].expand(b, l)
    if cfg.rope == "mrope":
        return base[None].expand(3, b, base.shape[1])
    return base


def check_process_mesh(cfg: ModelConfig, ctx: ParallelContext,
                       params: Params) -> bool:
    """Whether ``ctx`` runs on a process mesh; what the LMs do not run
    there yet is refused: any call that could want a gradient
    (``inference_on_processes``).  A MoE model's ``params`` must hold the
    process's experts there (``moe.held_experts``), checked before any
    put."""
    procs = inference_on_processes(ctx)
    if procs and cfg.family == "moe":
        for lp in params["layers"]:
            check_held_experts(lp["moe"], cfg, ctx.mesh)
    return procs


def lm_forward(
    params: Params,
    cfg: ModelConfig,
    ctx: ParallelContext,
    *,
    tokens: torch.Tensor | None = None,  # [B, L] int
    inputs_embeds: torch.Tensor | None = None,  # [B, L, d] (vlm frontend)
    positions: torch.Tensor | None = None,  # [B, L] or [3, B, L] (mrope)
    caches: Params | None = None,  # decode caches, stacked over layers
    cur_index: Any = None,
    last_only: bool = False,  # prefill: logits for the final position only
    seq_len: int | None = None,  # the whole sequence (a process mesh)
) -> tuple[torch.Tensor, torch.Tensor, Params | None]:
    """Returns (logits [B, L, V] (or [B, 1, V] if last_only), aux, caches).

    ``cur_index`` is the decode position (an int or a 0-d device tensor):
    attention writes the new K/V there; the recurrent state needs none.
    ``inputs_embeds`` replaces the token embedding (qwen2-vl's stubbed
    vision frontend hands in patch and text embeddings), ``positions`` the
    default ``arange`` (qwen2-vl's [3, B, L] M-RoPE ids).  As the
    reference's layer scan keeps its carry's dtype, every layer's output
    is cast back to the input's dtype: a bfloat16 model decoding from
    float32 rwkv6 caches stays in bfloat16 between layers.  Attention
    caches (and hymba's SSD state) are updated in place and returned.
    ``aux`` is the moe family's load-balance loss times
    ``router_aux_coef``, summed over the layers (0 for the others).

    On a process mesh (launch/procs.py) the forward runs on this
    process's part: ``tokens`` (or ``inputs_embeds``) are its batch slice
    and, in prefill, its sequence shard, the rows ``mesh.held_rows`` of
    ``seq_len`` in all; the default positions are the shard's slice of the
    global ``arange`` (``positions`` passed in must be the shard's own),
    and the logits cover the shard's rows.  ``last_only`` gives the final
    position on the process that holds it and zero rows on the others.
    In decode ``caches`` are the process's part (``init_lm_caches`` with
    the mesh); a MoE model's ``params`` hold the process's experts
    (``moe.held_experts``).  Any call that could want a gradient raises
    there (``check_process_mesh``)."""
    _check_family(cfg)
    procs = check_process_mesh(cfg, ctx, params)
    if inputs_embeds is not None:
        x = inputs_embeds
    else:
        x = params["embed"].to(torch_dtype(cfg.dtype))[tokens]
    start = 0
    if procs and not ctx.decode:
        start, _ = held_shard(ctx, x.shape[1], seq_len)
    attn = cfg.family in ATTENTION_FAMILIES
    if attn and cur_index is not None:
        cur_index = device_index(cur_index, x.device)
    if attn and positions is None:
        positions = _default_positions(cfg, ctx, x.shape[0], x.shape[1],
                                       cur_index, x.device, start)
    elif attn and procs and positions.shape[-1] != x.shape[1]:
        raise ValueError(f"positions of {positions.shape[-1]} rows for a "
                         f"shard of {x.shape[1]}: pass the shard's own")
    windows = _per_layer_windows(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_layer = []
    attention_layer = ctx.remat_wrap(_attention_layer)
    rwkv_layer = ctx.remat_wrap(_layer)
    for i, lp in enumerate(params["layers"]):
        cache = ({name: c[i] for name, c in caches.items()}
                 if caches is not None else None)
        if attn:
            y, a, state = attention_layer(x, lp, cfg, ctx, positions,
                                          windows[i], cache, cur_index)
            if a is not None:
                aux = aux + a
            if state is not None:  # hymba's SSD state, written in place
                caches["ssd_state"][i].copy_(state)
        else:
            y, new_cache = rwkv_layer(x, lp, cfg, ctx, cache)
            per_layer.append(new_cache)
        x = y.to(x.dtype)
    new_caches = None
    if caches is not None:
        # attention (and SSD) caches were written in place: the same tensors
        new_caches = dict(caches) if attn else {
            name: torch.stack([c[name] for c in per_layer])
            for name in caches}

    if last_only:
        # on a process mesh the final position is on the last shard only
        holds_last = not procs or ctx.decode or start + x.shape[1] == seq_len
        x = x[:, -1:] if holds_last else x[:, :0]
    x = norm(x, params["ln_f"], cfg.norm)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"].to(x.dtype).t())
    else:
        logits = linear(x, params["lm_head"])
    return logits, aux, new_caches
