"""K1: FlashAttention over multiple discontiguous Q/KV chunks with a fused
online-softmax merge (paper Algorithm 2) — the wrapper of the CUDA kernel
in ``csrc/flash_mqkv.cu`` and its plain PyTorch version.

The caller concatenates any number of discontiguous chunks and passes
their *global positions*; padding slots carry ``k_pos = -1`` and are
masked in-kernel, so exact causal/sliding-window masks hold wherever a
chunk sits in memory.  The kernel accepts a carried-in ``(O', l, m)``
running state from previous calls and divides by ``l`` only when
``finalize`` is set (FA2, eq. 3).  GQA reads kv head ``h // group``; K and
V are never repeated in device memory.

Dispatch is by the device of the tensors, nothing else:

  * CPU tensors run ``flash_mqkv_plain`` (kernels/ref.py);
  * CUDA tensors launch the kernel, or raise on anything it does not take;
  * any other device raises.

The kernel is instantiated at the head dims ``HEAD_DIMS``.  A head dim
between them (stablelm-3b's 80) runs at the next one up: the wrapper
zero-pads q, k and v (and a carried o') to it, keeps the scale of the true
head dim, and slices o back.  Zero columns add nothing to Q·Kᵀ and give
zero output columns, so the result is the unpadded attention's; the cost
is the padded head dim's work and three padding copies
(``kernel_head_dim``, ``pad_head_dim``).

Gradients.  A finalized, stateless call whose q, k or v requires grad
(with grad enabled) runs through ``FlashMQKV``, a
``torch.autograd.Function``: its forward is the call above and saves
(o, l, m); its backward is K1b (``flash_mqkv_bwd``, the hand-written
kernels of ``csrc/flash_mqkv_bwd.cu``) on CUDA tensors and its plain
version ``flash_mqkv_bwd_plain`` (kernels/ref.py) on CPU tensors.  K1b's
bf16 body is built for Hopper from K1's parts (TMA tiles, ``wgmma``
products, a dK/dV kernel and a dQ kernel that each write every output
element from one block) under the tile plan ``bwd_tile_plan``; its f32
body is the CUDA-core parity path.  A call with a carried state or
without ``finalize`` (the SP ring's partial calls) raises when it would
need a gradient: SP training differentiates the whole schedule instead
(core/sp_grad.py), calling K1b once per KV chunk with the rows' global
(m, l); a K1b that also forwards the chunk, as K2 does in the forward, is
ROADMAP Queue 2 item 8.

There is no fallback from a kernel to its plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from . import _build
from .ref import flash_attention_ref, flash_mqkv_bwd_plain

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1
# ctypes types of flash_mqkv_fwd's arguments before the stream (K2's entry
# point takes the same ones first)
ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float]
            + [ctypes.c_int] * 8)
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
STAGES = 2  # KV tiles in flight in the bf16 body (csrc/flash_mqkv.cuh, Hop)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Tiles of the bf16 kernel body: ``bq`` query rows per block (64 per
    consumer warpgroup), ``bk`` keys per KV tile, ``stages`` KV tiles in
    flight."""
    bq: int
    bk: int
    stages: int


def tile_plan(bh: int, lq: int, lk: int, d: int) -> TilePlan:
    """The bf16 body's tiles for q [bh, lq, d] against lk keys: blocks of
    128 query rows (two consumer warpgroups) where a grid of them fills the
    card's SMs, else blocks of 64 rows (one warpgroup; twice the blocks,
    two to an SM).  A KV tile has as many keys as the block has rows.
    Neither lk nor d changes the choice: every tile fits in shared memory
    at every head dim the kernel takes (``smem_bytes``)."""
    bq = 128 if bh * -(-lq // 128) >= SMS else 64
    return TilePlan(bq=bq, bk=bq, stages=STAGES)


def smem_bytes(plan: TilePlan, d: int) -> int:
    """Dynamic shared memory of the bf16 body under ``plan`` at head dim
    ``d`` (``Hop::SMEM`` in csrc/flash_mqkv.cuh): 1024 bytes to align the
    tiles to the swizzle's period, the Q tile, a K and a V tile per stage,
    the mbarriers (full and empty for K and for V per stage, one for Q),
    the k positions per stage and a padding flag per stage."""
    return (1024 + 2 * d * (plan.bq + 2 * plan.stages * plan.bk)
            + 8 * (4 * plan.stages + 1) + 4 * plan.stages * plan.bk
            + 4 * plan.stages)


# rows of a tile of K1b's bf16 body (csrc/flash_mqkv_bwd.cu: TILE): a
# streamed Q/dO tile of the dK/dV kernel, a K/V tile of the dQ kernel, a
# consumer warpgroup's keys or rows (a dQ block has one warpgroup), and a
# tile of the positions' bounds.  Both kernels keep STAGES tiles in flight.
BWD_TILE = 64


@dataclasses.dataclass(frozen=True)
class BwdTilePlan:
    """Tiles of K1b's bf16 body: ``kv_wg`` consumer warpgroups of 64 keys
    a dK/dV block; a GQA group's q heads split over ``splits`` dK/dV
    blocks (partial sums added in order by a second pass); ``pair``: a
    dK/dV block takes key tiles j and n-1-j."""
    kv_wg: int
    splits: int
    pair: bool

    @property
    def bk(self) -> int:
        """Keys of a dK/dV block."""
        return BWD_TILE * self.kv_wg


def bwd_tile_plan(bh: int, group: int, lq: int, lk: int, d: int,
                  causal: bool = False) -> BwdTilePlan:
    """K1b's bf16 tiles for q [bh, lq, d] against lk keys of bh / group KV
    heads.  A dK/dV block has two consumer warpgroups at head dim 128 (its
    dK and dV take 128 registers a thread: one block an SM), else one (two
    blocks an SM).  Under a causal mask key tile j sees the q tiles from j
    on, so a block takes tiles j and n-1-j and every block does the same
    work.  Where the blocks would leave SMs idle, the group's q heads are
    split over more blocks: the split count (a divisor of the group) that
    minimises waves of blocks / splits, the fewest on a tie.  Lq does not
    change the choice."""
    kv_wg = 2 if kernel_head_dim(d) == 128 else 1
    nkt = -(-lk // (BWD_TILE * kv_wg))
    pair = bool(causal) and nkt > 1
    cols = -(-nkt // 2) if pair else nkt
    slots = SMS * (1 if kv_wg == 2 else 2)
    bhkv = bh // group
    best, best_waves = 1, -(-cols * bhkv // slots)
    for s in range(2, group + 1):
        if group % s:
            continue
        waves = -(-cols * bhkv * s // slots)
        if waves * best < best_waves * s:  # waves / s < best_waves / best
            best, best_waves = s, waves
    return BwdTilePlan(kv_wg=kv_wg, splits=best, pair=pair)


def bwd_smem_bytes(plan: BwdTilePlan, d: int) -> tuple[int, int]:
    """Dynamic shared memory of K1b's bf16 (dK/dV, dQ) kernels under
    ``plan`` at head dim ``d`` (``KvTiles::SMEM`` and ``QTiles::SMEM`` in
    csrc/flash_mqkv_bwd.cu): 1024 bytes to align the tiles to the swizzle's
    period; dK/dV: the K and V tiles, a Q and a dO tile per stage, full
    and empty mbarriers per stage and for K/V, and per stage each row's
    -m·log2(e), 1/l, Δ and position; dQ: the Q and dO tiles, a K and a V
    tile per stage, full and empty mbarriers per stage and one for Q/dO,
    and the k positions per stage."""
    t, s = BWD_TILE, STAGES
    kv = 1024 + 2 * d * (2 * plan.bk + 2 * s * t) + 8 * (2 * s + 2) + 16 * s * t
    q = 1024 + 2 * d * (2 * t + 2 * s * t) + 8 * (2 * s + 1) + 4 * s * t
    return kv, q


def kernel_head_dim(d: int) -> int:
    """The head dim the kernel runs head dim ``d`` at: the smallest of
    ``HEAD_DIMS`` that holds it."""
    for hd in HEAD_DIMS:
        if d <= hd:
            return hd
    raise ValueError(f"flash_mqkv kernel takes head dims up to "
                     f"{HEAD_DIMS[-1]}, got {d}")


def pad_head_dim(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., D] zero-padded to ``kernel_head_dim(D)`` for a launch;
    CPU tensors (the plain versions take any D) and kernel head dims are
    returned as they are."""
    d = x.shape[-1]
    if x.device.type == "cpu" or d in HEAD_DIMS:
        return x
    return F.pad(x, (0, kernel_head_dim(d) - d))


# kernel launches since the last reset (the port's counterpart of the
# reference's per-variant trace counter: eager PyTorch has no traces)
_launches = 0


def launch_count() -> int:
    """CUDA kernel launches made by ``flash_mqkv`` since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


# K1b calls (each one delta, one dK/dV and one dQ launch) since the last
# reset
_bwd_launches = 0


def bwd_launch_count() -> int:
    """CUDA launches of K1b made by ``flash_mqkv_bwd`` since the last
    reset (one per backward call)."""
    return _bwd_launches


def reset_bwd_launch_count() -> None:
    global _bwd_launches
    _bwd_launches = 0


def flash_mqkv_plain(q, k, v, q_pos, k_pos, *, group=1, scale=None,
                     causal=False, window=None, state=None, finalize=True):
    """The kernel's function in plain PyTorch, on any device: KV heads are
    repeated ``group`` times and kernels/ref.py computes (o, l, m)."""
    if group > 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    o, l, m = flash_attention_ref(q, k, v, q_pos, k_pos, scale=scale,
                                  causal=causal, window=window, state=state,
                                  finalize=False)
    if finalize:
        o = (o / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
             ).to(q.dtype)
    return o, l, m


def check_tensor(name: str, t: torch.Tensor, shape: tuple,
                 dtype: torch.dtype, device: torch.device,
                 align: int = 4) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def kernel_args(q, k, v, q_pos, k_pos, *, group, scale, causal, window,
                state, finalize):
    """Check what the kernel body takes (it is K1's and K2's) and allocate
    the outputs.  Returns ``(o, l, m)`` and the C arguments of
    ``flash_mqkv_fwd`` before its stream, as ctypes values."""
    bh, lq, d = q.shape
    bhkv, lk, _ = k.shape
    dev = q.device
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_mqkv kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_mqkv kernel takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    if window is not None and not 0 <= window <= _INT32_MAX:
        raise ValueError(f"window {window} out of int32 range")
    # the bf16 path loads q/k/v through TMA (16-byte aligned bases);
    # everything else is read element by element
    align = 16 if q.dtype == torch.bfloat16 else 4
    check_tensor("q", q, (bh, lq, d), q.dtype, dev, align)
    check_tensor("k", k, (bhkv, lk, d), q.dtype, dev, align)
    check_tensor("v", v, (bhkv, lk, d), q.dtype, dev, align)
    check_tensor("q_pos", q_pos, (lq,), torch.int32, dev)
    check_tensor("k_pos", k_pos, (lk,), torch.int32, dev)
    if state is not None:
        o_in, l_in, m_in = state
        check_tensor("state o", o_in, (bh, lq, d), torch.float32, dev)
        check_tensor("state l", l_in, (bh, lq), torch.float32, dev)
        check_tensor("state m", m_in, (bh, lq), torch.float32, dev)
    o = torch.empty((bh, lq, d), dtype=q.dtype if finalize else torch.float32,
                    device=dev)
    l = torch.empty((bh, lq), dtype=torch.float32, device=dev)
    m = torch.empty((bh, lq), dtype=torch.float32, device=dev)
    null = ctypes.c_void_p(None)
    plan = tile_plan(bh, lq, lk, d)
    args = (ptr(q), ptr(k), ptr(v), ptr(q_pos), ptr(k_pos),
            *((ptr(t) for t in state) if state is not None
              else (null, null, null)),
            ptr(o), ptr(l), ptr(m),
            bh, lq, lk, d, group, _DTYPE_CODE[q.dtype], float(scale),
            int(causal), int(window is not None),
            0 if window is None else int(window), int(state is not None),
            int(finalize), plan.bq, plan.bk, plan.stages)
    return (o, l, m), args


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch(q, k, v, q_pos, k_pos, **kw):
    global _launches
    out, args = kernel_args(q, k, v, q_pos, k_pos, **kw)
    if q.shape[0] == 0 or q.shape[1] == 0:
        return out
    lib = _bound_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_mqkv_fwd(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.flash_mqkv_error_string(err).decode()
        raise RuntimeError(f"flash_mqkv kernel launch failed: {msg} ({err})")
    _launches += 1
    return out


def _bound_library() -> ctypes.CDLL:
    lib = _build.load("flash_mqkv")
    if lib.flash_mqkv_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_mqkv_fwd.argtypes = ARGTYPES + [p]
        lib.flash_mqkv_fwd.restype = i
        lib.flash_mqkv_error_string.argtypes = [i]
        lib.flash_mqkv_error_string.restype = ctypes.c_char_p
        lib.flash_mqkv_smem_bytes.argtypes = [i, i]
        lib.flash_mqkv_smem_bytes.restype = ctypes.c_longlong
    return lib


def _forward(
    q: torch.Tensor,  # [BH, Lq, D]
    k: torch.Tensor,  # [BHkv, Lk, D]
    v: torch.Tensor,
    q_pos: torch.Tensor,  # [Lq] int32
    k_pos: torch.Tensor,  # [Lk] int32, -1 = padding
    *,
    group: int = 1,  # GQA: q heads per kv head (BH = BHkv * group)
    scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    finalize: bool = True,
):
    """The forward without autograd: the plain version on the CPU, K1 on
    CUDA (at the padded head dim where ``d`` is not one of HEAD_DIMS)."""
    d = q.shape[-1]
    if q.device.type == "cpu":
        return flash_mqkv_plain(q, k, v, q_pos, k_pos, group=group,
                                scale=scale, causal=causal, window=window,
                                state=state, finalize=finalize)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mqkv runs on cpu or cuda, not {q.device}")
    if d not in HEAD_DIMS:  # run at the next instantiated head dim
        q, k, v = (pad_head_dim(t) for t in (q, k, v))
        if state is not None:
            state = (pad_head_dim(state[0]), state[1], state[2])
        o, l, m = _launch(q, k, v, q_pos, k_pos, group=group, scale=scale,
                          causal=causal, window=window, state=state,
                          finalize=finalize)
        return o[..., :d].contiguous(), l, m
    return _launch(q, k, v, q_pos, k_pos, group=group, scale=scale,
                   causal=causal, window=window, state=state,
                   finalize=finalize)


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class FlashMQKV(torch.autograd.Function):
    """K1's finalized, stateless call with K1b as its gradient.  Forward:
    ``_forward`` (K1 on CUDA, the plain version on the CPU), saving
    (o, l, m) so the backward needs no second forward.  Backward:
    ``flash_mqkv_bwd``.  l and m are outputs without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, group, scale, causal, window):
        o, l, m = _forward(q, k, v, q_pos, k_pos, group=group, scale=scale,
                           causal=causal, window=window, state=None,
                           finalize=True)
        ctx.save_for_backward(q, k, v, o, l, m, q_pos, k_pos)
        ctx.kw = dict(group=group, scale=scale, causal=causal, window=window)
        ctx.mark_non_differentiable(l, m)
        return o, l, m

    @staticmethod
    def backward(ctx, do, _dl, _dm):
        q, k, v, o, l, m, q_pos, k_pos = ctx.saved_tensors
        dq, dk, dv = flash_mqkv_bwd(q, k, v, o, do, m, l, q_pos, k_pos,
                                    **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def flash_mqkv(
    q: torch.Tensor,  # [BH, Lq, D]
    k: torch.Tensor,  # [BHkv, Lk, D]
    v: torch.Tensor,
    q_pos: torch.Tensor,  # [Lq] int32
    k_pos: torch.Tensor,  # [Lk] int32, -1 = padding
    *,
    group: int = 1,  # GQA: q heads per kv head (BH = BHkv * group)
    scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    finalize: bool = True,
):
    """Returns (o, l, m); o normalized iff ``finalize`` (then in q's dtype,
    else float32).  Any Lq and Lk: the kernel masks ragged edges itself.
    Differentiable in q, k and v when finalized without a carried state
    (``FlashMQKV``); such a call with a state or without ``finalize``
    raises while a gradient is wanted."""
    bh, lq, d = q.shape
    bhkv, lk, _ = k.shape
    if bh != bhkv * group:
        raise ValueError(f"BH {bh} != BHkv {bhkv} * group {group}")
    if scale is None:
        scale = d ** -0.5
    if _wants_grad(q, k, v):
        if state is not None or not finalize:
            raise NotImplementedError(
                "flash_mqkv has a gradient only for a finalized call "
                "without a carried state: SP training differentiates the "
                "whole schedule (core/sp_grad.py SPAttention), not its "
                "partial calls")
        return FlashMQKV.apply(q, k, v, q_pos, k_pos, group, scale, causal,
                               window)
    return _forward(q, k, v, q_pos, k_pos, group=group, scale=scale,
                    causal=causal, window=window, state=state,
                    finalize=finalize)


_BWD_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                 + [ctypes.c_float] + [ctypes.c_int] * 3
                 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p])


def _bound_bwd_library() -> ctypes.CDLL:
    lib = _build.load("flash_mqkv_bwd")
    if lib.flash_mqkv_bwd.argtypes is None:
        i = ctypes.c_int
        lib.flash_mqkv_bwd.argtypes = _BWD_ARGTYPES
        lib.flash_mqkv_bwd.restype = i
        lib.flash_mqkv_bwd_error_string.argtypes = [i]
        lib.flash_mqkv_bwd_error_string.restype = ctypes.c_char_p
        lib.flash_mqkv_bwd_smem_bytes.argtypes = [i, i]
        lib.flash_mqkv_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def flash_mqkv_bwd(q, k, v, o, do, m, l, q_pos, k_pos, *, group=1,
                   scale=None, causal=False, window=None):
    """(dq, dk, dv) of the finalized, stateless ``flash_mqkv`` from its
    saved (o, l, m) and the gradient ``do`` of o: K1b on CUDA tensors (the
    Hopper body in bf16 under ``bwd_tile_plan``, the CUDA-core parity body
    in f32), the plain version (kernels/ref.py) on CPU tensors.  A head dim
    that is not one of HEAD_DIMS runs zero-padded (q, k, v, o and do), and
    the gradients are sliced back: zero columns add nothing to the
    scores."""
    global _bwd_launches
    bh, lq, d = q.shape
    bhkv, lk, _ = k.shape
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_mqkv_bwd_plain(q, k, v, o, do, m, l, q_pos, k_pos,
                                    group=group, scale=scale, causal=causal,
                                    window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mqkv_bwd runs on cpu or cuda, not {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_mqkv_bwd kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if bh != bhkv * group:
        raise ValueError(f"BH {bh} != BHkv {bhkv} * group {group}")
    if window is not None and not 0 <= window <= _INT32_MAX:
        raise ValueError(f"window {window} out of int32 range")
    kd = kernel_head_dim(d)
    q, k, v, o, do = (pad_head_dim(t.contiguous()) for t in (q, k, v, o, do))
    dev = q.device
    bf16 = q.dtype == torch.bfloat16
    # the bf16 body loads q, k, v and dO through TMA and o in 16-byte words
    align = 16 if bf16 else 4
    for name, t, shape in (("q", q, (bh, lq, kd)), ("k", k, (bhkv, lk, kd)),
                           ("v", v, (bhkv, lk, kd)), ("o", o, (bh, lq, kd)),
                           ("do", do, (bh, lq, kd))):
        check_tensor(name, t, shape, q.dtype, dev, align)
    check_tensor("m", m, (bh, lq), torch.float32, dev)
    check_tensor("l", l, (bh, lq), torch.float32, dev)
    check_tensor("q_pos", q_pos, (lq,), torch.int32, dev)
    check_tensor("k_pos", k_pos, (lk,), torch.int32, dev)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if bh and lq:
        delta = torch.empty((bh, lq), dtype=torch.float32, device=dev)
        plan = bwd_tile_plan(bh, group, lq, lk, kd, causal)
        null = ctypes.c_void_p(None)
        tiles = partial = None
        if bf16:  # the positions' bounds per 64-row tile; the shares' sums
            n_tiles = -(-lq // BWD_TILE) + -(-lk // BWD_TILE)
            tiles = torch.empty((n_tiles, 4), dtype=torch.int32, device=dev)
            if plan.splits > 1:
                partial = torch.empty((2, plan.splits, bhkv, lk, kd),
                                      dtype=torch.float32, device=dev)
        lib = _bound_bwd_library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.flash_mqkv_bwd(
                ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(m), ptr(l),
                ptr(q_pos), ptr(k_pos), ptr(delta), ptr(dq), ptr(dk), ptr(dv),
                bh, lq, lk, kd, group, _DTYPE_CODE[q.dtype], float(scale),
                int(causal), int(window is not None),
                0 if window is None else int(window),
                null if tiles is None else ptr(tiles),
                null if partial is None else ptr(partial), plan.kv_wg,
                plan.splits, int(plan.pair), ctypes.c_void_p(stream))
        if err != 0:
            msg = lib.flash_mqkv_bwd_error_string(err).decode()
            raise RuntimeError(f"flash_mqkv_bwd kernel launch failed: {msg} "
                               f"({err})")
        _bwd_launches += 1
    else:  # nothing to differentiate
        for t in (dq, dk, dv):
            t.zero_()
    if kd != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv
