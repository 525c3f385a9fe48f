"""K5: the chunked RWKV6 (Finch) WKV scan — the wrapper of the CUDA kernel
in ``csrc/rwkv6_wkv.cu`` and its plain PyTorch version.

The recurrence, per (batch, head) row, from S_0 = 0:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

evaluated chunk by chunk in matmul form over cumulative decays clipped to
[1e-6, 1] (kernels/ref.py:rwkv6_wkv_ref is the plain version).  It is the
output of models/ssm.py:rwkv6_chunk_scan with no state carried in.

Two entry points share the kernel:

  * ``rwkv6_wkv`` — the reference's signature, [BH, L, N] and u [BH, N];
  * ``rwkv6_wkv_heads`` — the model's layout, [B, L, H, N] and u [H, N]:
    the kernel reads the projections through their strides, so the model
    makes no transposed copy.

Dispatch is by the device of the tensors, nothing else: CPU tensors run
the plain version, CUDA tensors launch the kernel or raise on anything it
does not take, any other device raises.  There is no fallback from the
kernel to the plain version.  The kernel loads r, k, v and w with TMA, so
each needs a 16-byte aligned base and byte strides that are multiples of
16 (the model's projections are); a view that is not raises ValueError,
and the kernel never copies one quietly.

The gradient is K5b (``csrc/rwkv6_wkv_bwd.cu``, ``rwkv6_wkv_heads_bwd``;
its plain version is kernels/ref.py:rwkv6_wkv_bwd_plain): ``WKV`` is the
autograd Function of ``rwkv6_wkv_heads``, whose forward is K5 and whose
backward is K5b on CUDA (the plain versions on the CPU).
``rwkv6_wkv_heads`` goes through it only while a gradient is wanted: a
forward without grad (prefill, the captured decode tick) launches K5
directly.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import PLAIN_DEVICES, WKV_CHUNK, rwkv6_wkv_bwd_plain, rwkv6_wkv_ref, wkv_chunk

SIZES = (8, 16, 32, 64)  # head sizes N and chunks c the kernel takes
SPLITS = (1, 2, 4)  # blocks of value columns per row the kernel takes
MIN_SPLIT_COLUMNS = 16  # value columns of a block when a row is split
_BF16 = {torch.float32: 0, torch.bfloat16: 1}

_launches = 0
_bwd_launches = 0


def launch_count() -> int:
    """CUDA kernel launches made by the WKV wrappers since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def bwd_launch_count() -> int:
    """Calls that launched K5b since the last reset; each call is three
    launches (the states, the chunk gradients, the ordered sum of du)."""
    return _bwd_launches


def reset_bwd_launch_count() -> None:
    global _bwd_launches
    _bwd_launches = 0


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[B, L, H, N] -> [B*H, L, N]"""
    b, l, h, n = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, l, n)


def rwkv6_wkv_heads_plain(r, k, v, w, u, *, chunk: int = WKV_CHUNK):
    """``rwkv6_wkv_heads`` in plain PyTorch: the [B, L, H, N] layout mapped
    to the kernel's [BH, L, N] and back."""
    b, l, h, n = r.shape
    ub = u.expand(b, h, n).reshape(b * h, n)
    o = rwkv6_wkv_ref(_flat(r), _flat(k), _flat(v), _flat(w), ub, chunk=chunk)
    return o.reshape(b, h, l, n).permute(0, 2, 1, 3)


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, r on {device}")
    if t.dtype not in _BF16:
        raise TypeError(f"rwkv6_wkv kernel takes float32 or bfloat16, {name} "
                        f"is {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous along its last axis")


def _aligned(t: torch.Tensor) -> bool:
    """TMA's terms for a [B, L, H, N] input, which K5b's 16-byte loads
    share: a 16-byte aligned base, and byte strides of the batch, time and
    head axes (those of extent > 1) that are multiples of 16."""
    es = t.element_size()
    return not (t.data_ptr() % 16 or any(t.stride(d) * es % 16
                                         for d in range(3) if t.shape[d] > 1))


def _check_aligned(name: str, t: torch.Tensor) -> None:
    if not _aligned(t):
        es = t.element_size()
        raise ValueError(
            f"rwkv6_wkv kernels load {name} with TMA or 16-byte loads, which "
            f"need a 16-byte "
            f"aligned base and strides of 16-byte multiples; got "
            f"{name}.data_ptr() % 16 = {t.data_ptr() % 16}, byte strides "
            f"{tuple(s * es for s in t.stride())} (pass .contiguous())")


def value_split(bh: int, n: int, sms: int) -> int:
    """Blocks over which the kernel splits a row's N value columns: the
    largest of SPLITS that keeps N / split >= MIN_SPLIT_COLUMNS and the
    BH x split blocks (one per SM) within one wave of ``sms`` SMs.  Each
    block recomputes the chunk's decays and att, which the tensor cores
    make cheap, so few rows (B 1 x L 1024: 32) still fill the card."""
    split = 1
    while (2 * split in SPLITS and n // (2 * split) >= MIN_SPLIT_COLUMNS
           and bh * 2 * split <= sms):
        split *= 2
    return split


def _bound_library() -> ctypes.CDLL:
    lib = _build.load("rwkv6_wkv")
    if lib.rwkv6_wkv_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rwkv6_wkv_fwd.argtypes = [p] * 6 + [i] * 8 + [p, p]
        lib.rwkv6_wkv_fwd.restype = i
        lib.rwkv6_wkv_smem.argtypes = [i] * 4 + [p]
        lib.rwkv6_wkv_smem.restype = i
        lib.rwkv6_wkv_error_string.argtypes = [i]
        lib.rwkv6_wkv_error_string.restype = ctypes.c_char_p
    return lib


def smem_plan(chunk: int, n: int, split: int, bf16: int) -> dict:
    """The kernel's dynamic shared memory per block ("bytes") and its ring
    of TMA stages ("stages") at (chunk, N, split), for the input dtypes
    ``bf16`` (bit 0 r, 1 k, 2 v, 3 w set where that input is bfloat16), as
    the library computes them at launch; 0 and 0 for a shape it does not
    take."""
    lib = _bound_library()
    stages = ctypes.c_int(0)
    nbytes = lib.rwkv6_wkv_smem(chunk, n, split, bf16, ctypes.byref(stages))
    return {"bytes": nbytes, "stages": stages.value}


def _launch(r, k, v, w, u, *, chunk: int) -> torch.Tensor:
    """The kernel on [B, L, H, N] inputs (contiguous channels, strides and
    base TMA can load: see _check_aligned) and u [U, N]: row bh = b * H + h
    reads u[bh % U].  Each row's value columns go to value_split(...)
    blocks.  Returns o [B, L, H, N] float32, contiguous."""
    global _launches
    b, l, h, n = r.shape
    dev = r.device
    if n not in SIZES:
        raise ValueError(f"rwkv6_wkv kernel takes head sizes {SIZES}, got {n}")
    c = wkv_chunk(l, chunk)
    if c not in SIZES:
        raise ValueError(f"rwkv6_wkv kernel takes chunks {SIZES}, got "
                         f"min(chunk, L) = {c}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check(name, t, (b, l, h, n), dev)
        _check_aligned(name, t)
    if u.dim() != 2 or u.shape[0] < 1:
        raise ValueError(f"u must be [rows, {n}], got {tuple(u.shape)}")
    _check("u", u, (u.shape[0], n), dev)
    u = u.contiguous()
    o = torch.empty((b, l, h, n), dtype=torch.float32, device=dev)
    if b * h == 0:
        return o
    strides = (ctypes.c_longlong * 15)(*(
        s for t in (r, k, v, w, o)
        for s in (t.stride(0), t.stride(2), t.stride(1))))
    bf16 = sum(_BF16[t.dtype] << i for i, t in enumerate((r, k, v, w, u)))
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    split = value_split(b * h, n,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = _bound_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rwkv6_wkv_fwd(p(r), p(k), p(v), p(w), p(u), p(o), b * h, h,
                                l, n, c, u.shape[0], bf16, split, strides,
                                ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.rwkv6_wkv_error_string(err).decode()
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: {msg} ({err})")
    _launches += 1
    return o


def _dispatch(x: torch.Tensor) -> str:
    if x.device.type in PLAIN_DEVICES:
        return "cpu"
    if x.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv runs on cpu or cuda, not {x.device}")
    return "cuda"


def rwkv6_wkv(
    r: torch.Tensor,  # [BH, L, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # decay in (0, 1]
    u: torch.Tensor,  # [BH, N] per-head bonus
    *,
    chunk: int = WKV_CHUNK,
) -> torch.Tensor:
    """Returns o [BH, L, N] (float32)."""
    if _dispatch(r) == "cpu":
        return rwkv6_wkv_ref(r, k, v, w, u, chunk=chunk)
    bh, l, n = r.shape
    if tuple(u.shape) != (bh, n):
        raise ValueError(f"u has shape {tuple(u.shape)}, expected {(bh, n)}")
    o = _launch(*(t[:, :, None] for t in (r, k, v, w)), u, chunk=chunk)
    return o[:, :, 0]


def _heads_forward(r, k, v, w, u, chunk):
    if _dispatch(r) == "cpu":
        return rwkv6_wkv_heads_plain(r, k, v, w, u, chunk=chunk)
    return _launch(r, k, v, w, u, chunk=chunk)


class WKV(torch.autograd.Function):
    """``rwkv6_wkv_heads`` with K5b as its gradient.  Forward: K5 on CUDA,
    the plain version on the CPU, saving only the inputs (the backward
    recomputes the chunks' states).  Backward: ``rwkv6_wkv_heads_bwd``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        return _heads_forward(r, k, v, w, u, chunk)

    @staticmethod
    def backward(ctx, do):
        grads = rwkv6_wkv_heads_bwd(*ctx.saved_tensors, do, chunk=ctx.chunk)
        return (*grads, None)


def rwkv6_wkv_heads(
    r: torch.Tensor,  # [B, L, H, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # decay in (0, 1]
    u: torch.Tensor,  # [H, N] per-head bonus
    *,
    chunk: int = WKV_CHUNK,
) -> torch.Tensor:
    """``rwkv6_wkv`` in the model's layout: returns o [B, L, H, N]
    (float32), which equals ``rwkv6_chunk_scan(r, k, v, w, u).out``.
    Differentiable in every input (``WKV``) while a gradient is wanted."""
    if tuple(u.shape) != (r.shape[2], r.shape[3]):
        raise ValueError(f"u has shape {tuple(u.shape)}, expected "
                         f"{(r.shape[2], r.shape[3])}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, w, u)):
        return WKV.apply(r, k, v, w, u, chunk)
    return _heads_forward(r, k, v, w, u, chunk)


def rwkv6_wkv_heads_bwd_plain(r, k, v, w, u, do, *, chunk: int = WKV_CHUNK):
    """``rwkv6_wkv_heads_bwd`` in plain PyTorch: (dr, dk, dv, dw) [B, L, H,
    N] and du [H, N] (summed over the batch), in the inputs' dtypes."""
    b, l, h, n = r.shape
    grads = rwkv6_wkv_bwd_plain(*(_flat(t) for t in (r, k, v, w)), u,
                                _flat(do), chunk=chunk)
    unflat = lambda g: g.reshape(b, h, l, n).permute(0, 2, 1, 3)
    return (*(unflat(g) for g in grads[:4]), grads[4])


# K5b's launches (csrc/rwkv6_wkv_bwd.cu): threads of a block of the states'
# launch and of the chunk gradients', and the card's shared memory per SM
# and per block (H100: 228 KiB an SM, of which 1 KiB is reserved per block)
K5B_CHAIN_THREADS = 256
K5B_CHUNK_THREADS = 192
K5B_DU_THREADS = 256
SM_SMEM = 233472
SM_THREADS = 2048
BLOCK_RESERVED_SMEM = 1024
SMEM_LIMIT = 232448


def k5b_split(bh: int, n: int, sms: int) -> int:
    """Blocks over which K5b's states launch splits a row's N value
    columns: the largest of SPLITS that keeps N / split >= MIN_SPLIT_COLUMNS
    and the BH x 2 chains x split blocks within two per SM of ``sms``."""
    split = 1
    while (2 * split in SPLITS and n // (2 * split) >= MIN_SPLIT_COLUMNS
           and bh * 2 * (2 * split) <= 2 * sms):
        split *= 2
    return split


def k5b_smem(kernel: str, chunk: int, n: int, split: int = 1) -> int:
    """Dynamic shared memory of one block of K5b's ``kernel`` ("chain", the
    states; "chunk", the chunk gradients) at (chunk, N, split), as
    ChainPlan / ChunkPlan lay it out in csrc/rwkv6_wkv_bwd.cu (float32
    tiles padded to a row stride of max(N, 16) + 4; the chain's stage holds
    the next chunk's k or r, w, and v or dO at up to 4 bytes an element)."""
    cp, np_ = max(chunk, 16), max(n, 16)
    ld = np_ + 4
    if kernel == "chain":  # the tiles, then a stage of the next chunk's
        tv = n // split
        tiles = 4 * (2 * cp * ld + cp * (tv + 4) + np_)
        return -(-tiles // 16) * 16 + 4 * chunk * (2 * n + tv)
    if kernel == "chunk":
        mp, mt = max(cp, np_), cp // 16
        return 4 * (6 * mp * ld + 2 * np_ + 2 * cp + np_ + mt * np_)
    raise ValueError(f"K5b has no kernel {kernel!r}")


def _blocks_per_sm(smem: int, threads: int) -> int:
    return min(SM_SMEM // (smem + BLOCK_RESERVED_SMEM), SM_THREADS // threads)


def k5b_plan(b: int, h: int, l: int, n: int, chunk: int, sms: int,
             u_rows: int | None = None) -> dict:
    """K5b's launches for [B, L, H, N] inputs at ``chunk`` on a card of
    ``sms`` SMs: each launch's grid, threads and dynamic shared memory (and
    blocks an SM holds by shared memory and threads; the kernels' launch
    bounds hold registers to that), the states' value split, and the
    float32 scratch the wrapper allocates (S_in and dS [BH, nc, N, N], the
    du partials [BH, nc, N])."""
    c = wkv_chunk(l, chunk)
    if n not in SIZES or c not in SIZES:
        raise ValueError(f"rwkv6_wkv_bwd kernel takes head sizes and chunks "
                         f"{SIZES}, got N {n}, min(chunk, L) = {c}")
    bh, nc = b * h, l // c
    u_rows = h if u_rows is None else u_rows
    split = k5b_split(bh, n, sms)
    chain = k5b_smem("chain", c, n, split)
    chunks = k5b_smem("chunk", c, n)
    return {
        "chunk": c, "split": split,
        "chain": {"grid": (bh, split, 2), "threads": K5B_CHAIN_THREADS,
                  "smem": chain,
                  "per_sm": _blocks_per_sm(chain, K5B_CHAIN_THREADS)},
        "chunks": {"grid": (bh * nc,), "threads": K5B_CHUNK_THREADS,
                   "smem": chunks,
                   "per_sm": _blocks_per_sm(chunks, K5B_CHUNK_THREADS)},
        "du": {"grid": (-(-u_rows * n // K5B_DU_THREADS),),
               "threads": K5B_DU_THREADS, "smem": 0},
        "scratch_bytes": 4 * bh * nc * n * (2 * n + 1),
    }


def _bound_bwd_library() -> ctypes.CDLL:
    lib = _build.load("rwkv6_wkv_bwd")
    if lib.rwkv6_wkv_bwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rwkv6_wkv_bwd.argtypes = [p] * 14 + [i] * 9 + [p, p]
        lib.rwkv6_wkv_bwd.restype = i
        lib.rwkv6_wkv_bwd_smem.argtypes = [i] * 4
        lib.rwkv6_wkv_bwd_smem.restype = i
        lib.rwkv6_wkv_bwd_error_string.argtypes = [i]
        lib.rwkv6_wkv_bwd_error_string.restype = ctypes.c_char_p
    return lib


def rwkv6_wkv_heads_bwd(
    r: torch.Tensor,  # [B, L, H, N]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,  # [U, N]: row b * H + h reads u[(b * H + h) % U]
    do: torch.Tensor,  # [B, L, H, N] the gradient of o
    *,
    chunk: int = WKV_CHUNK,
    carry: bool = True,
):
    """(dr, dk, dv, dw, du) of ``rwkv6_wkv_heads`` given the gradient
    ``do`` of its output: K5b on CUDA tensors, the plain version on CPU
    tensors.  dr, dk, dv, dw are [B, L, H, N] in r's, k's, v's and w's
    dtypes; du [U, N] in u's, summed over the rows that read each row of u
    (U = H: over the batch) in a fixed order, so a repeat is bitwise equal.
    Any of r, k, v, w, do and u may be float32 or bfloat16; the kernel
    reads the inputs through their strides (channels contiguous) with
    16-byte loads, so r, k, v and w need what K5's TMA needs (see
    _check_aligned; a view that is not raises ValueError, do is made
    contiguous), and the chunk min(chunk, L) and N in SIZES.  A call is
    three launches from ``k5b_plan``: the states (S_in and dS per chunk,
    into float32 scratch), the chunk gradients, the ordered sum of du; it
    counts once in ``bwd_launch_count``.  ``carry=False`` makes the kernel
    drop the state's gradient between chunks, a wrong result that negative
    controls use; the plain version has no such switch."""
    global _bwd_launches
    b, l, h, n = r.shape
    if _dispatch(r) == "cpu":
        if not carry:
            raise ValueError("the plain backward always carries dS")
        return rwkv6_wkv_heads_bwd_plain(r, k, v, w, u, do, chunk=chunk)
    dev = r.device
    if n not in SIZES:
        raise ValueError(f"rwkv6_wkv_bwd kernel takes head sizes {SIZES}, "
                         f"got {n}")
    c = wkv_chunk(l, chunk)
    if c not in SIZES:
        raise ValueError(f"rwkv6_wkv_bwd kernel takes chunks {SIZES}, got "
                         f"min(chunk, L) = {c}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check(name, t, (b, l, h, n), dev)
        _check_aligned(name, t)
    if do.stride(-1) != 1 or not _aligned(do):
        do = do.contiguous()
    _check("do", do, (b, l, h, n), dev)
    if u.dim() != 2 or u.shape[0] < 1 or (b * h) % u.shape[0]:
        raise ValueError(f"u must be [rows, {n}] with rows dividing "
                         f"{b * h}, got {tuple(u.shape)}")
    _check("u", u, (u.shape[0], n), dev)
    u = u.contiguous()
    grads = [torch.empty((b, l, h, n), dtype=t.dtype, device=dev)
             for t in (r, k, v, w)]
    du = torch.empty_like(u)
    if b * h == 0:
        for t in (*grads, du):
            t.zero_()
        return (*grads, du)
    plan = k5b_plan(b, h, l, n, chunk,
                    torch.cuda.get_device_properties(dev).multi_processor_count,
                    u.shape[0])
    states, dstates = (torch.empty((b * h, l // c, n, n), dtype=torch.float32,
                                   device=dev) for _ in range(2))
    du_parts = torch.empty((b * h, l // c, n), dtype=torch.float32,
                           device=dev)
    strides = (ctypes.c_longlong * 15)(*(
        s for t in (r, k, v, w, do)
        for s in (t.stride(0), t.stride(2), t.stride(1))))
    bf16 = sum(_BF16[t.dtype] << i for i, t in enumerate((r, k, v, w, do, u)))
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    lib = _bound_bwd_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rwkv6_wkv_bwd(p(r), p(k), p(v), p(w), p(do), p(u),
                                *(p(g) for g in grads), p(du), p(states),
                                p(dstates), p(du_parts), b * h, h, l, n, c,
                                u.shape[0], bf16, int(carry), plan["split"],
                                strides, ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.rwkv6_wkv_bwd_error_string(err).decode()
        raise RuntimeError(f"rwkv6_wkv_bwd kernel launch failed: {msg} "
                           f"({err})")
    _bwd_launches += 1
    return (*grads, du)
