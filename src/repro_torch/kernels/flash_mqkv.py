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

There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import flash_attention_ref

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1

# kernel launches since the last reset (the port's counterpart of the
# reference's per-variant trace counter: eager PyTorch has no traces)
_launches = 0


def launch_count() -> int:
    """CUDA kernel launches made by ``flash_mqkv`` since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


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


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device, align: int = 4) -> None:
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


def _launch(q, k, v, q_pos, k_pos, *, group, scale, causal, window, state,
            finalize):
    global _launches
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
    # the bf16 path loads q/k/v rows as 16-byte vectors; everything else
    # is read element by element
    align = 16 if q.dtype == torch.bfloat16 else 4
    _check("q", q, (bh, lq, d), q.dtype, dev, align)
    _check("k", k, (bhkv, lk, d), q.dtype, dev, align)
    _check("v", v, (bhkv, lk, d), q.dtype, dev, align)
    _check("q_pos", q_pos, (lq,), torch.int32, dev)
    _check("k_pos", k_pos, (lk,), torch.int32, dev)
    if state is not None:
        o_in, l_in, m_in = state
        _check("state o", o_in, (bh, lq, d), torch.float32, dev)
        _check("state l", l_in, (bh, lq), torch.float32, dev)
        _check("state m", m_in, (bh, lq), torch.float32, dev)
    o = torch.empty((bh, lq, d), dtype=q.dtype if finalize else torch.float32,
                    device=dev)
    l = torch.empty((bh, lq), dtype=torch.float32, device=dev)
    m = torch.empty((bh, lq), dtype=torch.float32, device=dev)
    if bh == 0 or lq == 0:
        return o, l, m
    lib = _bound_library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    null = ctypes.c_void_p(None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_mqkv_fwd(
            ptr(q), ptr(k), ptr(v), ptr(q_pos), ptr(k_pos),
            *((ptr(t) for t in state) if state is not None
              else (null, null, null)),
            ptr(o), ptr(l), ptr(m),
            bh, lq, lk, d, group, _DTYPE_CODE[q.dtype], float(scale),
            int(causal), int(window is not None),
            0 if window is None else int(window), int(state is not None),
            int(finalize), ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.flash_mqkv_error_string(err).decode()
        raise RuntimeError(f"flash_mqkv kernel launch failed: {msg} ({err})")
    _launches += 1
    return o, l, m


def _bound_library() -> ctypes.CDLL:
    lib = _build.load("flash_mqkv")
    if lib.flash_mqkv_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_mqkv_fwd.argtypes = (
            [p] * 11 + [i] * 6 + [ctypes.c_float] + [i] * 5 + [p])
        lib.flash_mqkv_fwd.restype = i
        lib.flash_mqkv_error_string.argtypes = [i]
        lib.flash_mqkv_error_string.restype = ctypes.c_char_p
    return lib


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
    else float32).  Any Lq and Lk: the kernel masks ragged edges itself."""
    bh, lq, d = q.shape
    bhkv, lk, _ = k.shape
    if bh != bhkv * group:
        raise ValueError(f"BH {bh} != BHkv {bhkv} * group {group}")
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_mqkv_plain(q, k, v, q_pos, k_pos, group=group,
                                scale=scale, causal=causal, window=window,
                                state=state, finalize=finalize)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mqkv runs on cpu or cuda, not {q.device}")
    return _launch(q, k, v, q_pos, k_pos, group=group, scale=scale,
                   causal=causal, window=window, state=state,
                   finalize=finalize)
