"""K2: the fused ring step — flash_mqkv plus the one-sided put of the KV
chunk to the next ring rank (paper Algorithm 2's overlap).  The wrapper of
the CUDA kernel in ``csrc/ring_flash.cu`` and its plain PyTorch version.

The reference (``kernels/ring_flash.py``) starts a *local* DMA of the whole
(K, V) chunk into forward buffers at its first grid step and waits it
after its last compute block; the hop to the next device is a separate
ppermute.  On Hopper the destination is any preallocated buffer, and the
ring schedule (core/ring.py) hands in the next ring rank's receive
buffers, so the kernel's copy is the put itself.  In the bf16 body the
blocks of each KV head's first q head store the K and V tiles they loaded
for their attention into the forward buffers, about one tile each (the
f32 body copies the chunk in a prologue shared by all blocks), and the
last of those blocks release-stores
``epoch`` into the completion word ``flag``.  The attention is K1's kernel
body (``csrc/flash_mqkv.cuh``), so ``(o, l, m)`` equal flash_mqkv's bit
for bit.

Dispatch is by the device of the tensors, as for K1: CPU tensors run
``ring_flash_step_plain``, CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_mqkv import (ARGTYPES, check_tensor, flash_mqkv_plain,
                         kernel_args, ptr)

_launches = 0


def launch_count() -> int:
    """CUDA kernel launches made by ``ring_flash_step`` since the last
    reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def ring_flash_step_plain(q, k, v, q_pos, k_pos, *, k_dst, v_dst,
                          flag=None, epoch=0, **kw):
    """The kernel's function in plain PyTorch: flash_mqkv's plain version,
    the copies into the forward buffers and the completion word."""
    out = flash_mqkv_plain(q, k, v, q_pos, k_pos, **kw)
    k_dst.copy_(k)
    v_dst.copy_(v)
    if flag is not None:
        flag.fill_(epoch)
    return out


def _launch(q, k, v, q_pos, k_pos, *, k_dst, v_dst, flag, arrive, epoch,
            **kw):
    global _launches
    dev = q.device
    if q.shape[0] == 0 or q.shape[1] == 0:
        raise ValueError("ring_flash_step needs a non-empty q: its blocks "
                         "carry the copy of the chunk")
    out, args = kernel_args(q, k, v, q_pos, k_pos, **kw)
    for name, t, like in (("k", k, k), ("v", v, k), ("k_dst", k_dst, k),
                          ("v_dst", v_dst, k)):
        # the chunk moves as 16-byte vectors (f32) or TMA tiles (bf16)
        check_tensor(name, t, tuple(like.shape), k.dtype, dev, align=16)
    if (flag is None) != (arrive is None):
        raise ValueError("flag and arrive go together")
    for name, t in (("flag", flag), ("arrive", arrive)):
        if t is not None:
            check_tensor(name, t, (1,), torch.int32, dev)
    n_vec = k.numel() * k.element_size() // 16
    lib = _bound_library()
    null = ctypes.c_void_p(None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ring_flash_fwd(
            *args, ptr(k_dst), ptr(v_dst), n_vec,
            null if flag is None else ptr(flag),
            null if arrive is None else ptr(arrive),
            epoch & 0xFFFFFFFF, ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.ring_flash_error_string(err).decode()
        raise RuntimeError(f"ring_flash kernel launch failed: {msg} ({err})")
    _launches += 1
    return out


def _bound_library() -> ctypes.CDLL:
    lib = _build.load("ring_flash")
    if lib.ring_flash_fwd.argtypes is None:
        p = ctypes.c_void_p
        lib.ring_flash_fwd.argtypes = ARGTYPES + [
            p, p, ctypes.c_longlong, p, p, ctypes.c_uint, p]
        lib.ring_flash_fwd.restype = ctypes.c_int
        lib.ring_flash_error_string.argtypes = [ctypes.c_int]
        lib.ring_flash_error_string.restype = ctypes.c_char_p
    return lib


def ring_flash_step(
    q: torch.Tensor,  # [BH, Lq, D]
    k: torch.Tensor,  # [BHkv, Lk, D]
    v: torch.Tensor,
    q_pos: torch.Tensor,  # [Lq] int32
    k_pos: torch.Tensor,  # [Lk] int32, -1 = padding
    *,
    k_dst: torch.Tensor | None = None,  # forward buffers, shaped like k / v
    v_dst: torch.Tensor | None = None,
    flag: torch.Tensor | None = None,  # [1] int32 completion word
    arrive: torch.Tensor | None = None,  # [1] int32 counter, kept 0
    epoch: int = 0,
    group: int = 1,
    scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    finalize: bool = True,
):
    """One fused ring step.  Same contract as ``flash_mqkv`` plus the
    forwarded chunk: returns ``(o, l, m), (k_dst, v_dst)``, the forward
    buffers holding the consumed KV chunk (allocated here when not
    given).  ``flag`` reads ``epoch`` once the chunk has landed."""
    bh, lq, d = q.shape
    bhkv, lk, _ = k.shape
    if bh != bhkv * group:
        raise ValueError(f"BH {bh} != BHkv {bhkv} * group {group}")
    if scale is None:
        scale = d ** -0.5
    k_dst = torch.empty_like(k) if k_dst is None else k_dst
    v_dst = torch.empty_like(v) if v_dst is None else v_dst
    kw = dict(group=group, scale=scale, causal=causal, window=window,
              state=state, finalize=finalize)
    if q.device.type == "cpu":
        out = ring_flash_step_plain(q, k, v, q_pos, k_pos, k_dst=k_dst,
                                    v_dst=v_dst, flag=flag, epoch=epoch, **kw)
    elif q.device.type == "cuda":
        out = _launch(q, k, v, q_pos, k_pos, k_dst=k_dst, v_dst=v_dst,
                      flag=flag, arrive=arrive, epoch=epoch, **kw)
    else:
        raise ValueError(f"ring_flash_step runs on cpu or cuda, not {q.device}")
    return out, (k_dst, v_dst)
