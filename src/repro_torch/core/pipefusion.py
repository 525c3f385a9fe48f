"""Displaced patch pipeline parallelism for DiT inference (PipeFusion,
arXiv:2405.14430), composed with the SwiftFusion SP strategies — the
counterpart of ``src/repro/core/pipefusion.py``.

Diffusion sampling runs the same network num_steps times on slowly-varying
inputs.  PipeFusion exploits this with two moves:

  1. **Patch pipelining** — split the latent sequence into ``num_patches``
     contiguous patches and the DiT block stack into ``pp`` contiguous
     stages, one stage per rank of a ``pipe`` mesh axis.
  2. **Displaced (one-step-stale) activations** — attention needs KV for
     the *full* sequence, but only the resident patch is fresh; every other
     row reuses the previous sampler step's per-layer KV.  The first
     ``warmup_steps`` steps run fully synchronous to populate the state.

Freshness rule (async PipeFusion): when patch p is processed at step t,
layer l's attention sees fresh K, V for the rows of patch p and stale
(step t-1, same layer) K, V for every other row.

This module owns the schedule bookkeeping and the displaced attention;
the DiT forward lives in models/dit.py (``dit_forward_displaced``).  The
KV state is a ``KVState`` of tensors that the caller threads through the
steps; ``update_state_rows`` writes into it in place (the counterpart of
the reference's buffer donation).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..kernels.ops import flash_attention_segments


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Patch-level pipeline parallelism knobs (PipeFusion).

    ``pp``           — pipeline stages; DiT blocks are split into ``pp``
                       contiguous groups along a ``pp_axis`` mesh axis.
    ``num_patches``  — latent patches streamed through the stages; 0 means
                       "same as pp" (the paper's default M = N choice).
    ``warmup_steps`` — leading sampler steps run fully synchronous (no
                       staleness) to populate the per-layer KV state; must
                       be >= 1.
    ``resync_every`` — after warmup, run one fully-synchronous re-sync step
                       every this many sampler steps.  0 = never; 1 = every
                       step synchronous (no staleness at all).
    ``pp_axis``      — mesh axis name holding the stages.
    """

    pp: int = 1
    num_patches: int = 0
    warmup_steps: int = 1
    resync_every: int = 0
    pp_axis: str = "pipe"

    def __post_init__(self):
        assert self.pp >= 1, self
        assert self.num_patches >= 0, self
        assert self.warmup_steps >= 1, "first step must populate the KV state"
        assert self.resync_every >= 0, self

    @property
    def patches(self) -> int:
        return self.num_patches or self.pp

    @property
    def enabled(self) -> bool:
        return self.pp > 1 or self.patches > 1

    def warm_step(self, i: int) -> bool:
        """Whether sampler step ``i`` runs fully synchronous: the warmup
        prefix, plus every ``resync_every``-th step after it."""
        if i < self.warmup_steps:
            return True
        if self.resync_every <= 0:
            return False
        return (i - self.warmup_steps + 1) % self.resync_every == 0


class KVState(NamedTuple):
    """Per-layer full-sequence attention KV from the previous sampler step.

    ``k`` is stored post-RoPE so stale rows can be attended directly.
    Shapes: [n_layers, B, T_total, Hkv, D] each, where T_total counts the
    conditioning tokens + latent tokens (models/dit.py concatenates them).
    """

    k: torch.Tensor
    v: torch.Tensor


def init_kv_state(n_layers: int, batch: int, seq_total: int, n_kv_heads: int,
                  head_dim: int, dtype: torch.dtype,
                  device: torch.device | str) -> KVState:
    """Zero state of the shape the hybrid steps thread, on ``device``.
    Never *read* before warmup writes it (warmup_steps >= 1)."""
    shape = (n_layers, batch, seq_total, n_kv_heads, head_dim)
    return KVState(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# static partitioning helpers (plain ints)
# ---------------------------------------------------------------------------

def patch_slices(cond_tokens: int, latent_len: int,
                 num_patches: int) -> list[tuple[int, int]]:
    """(start, length) patches over the concatenated [cond ; latents] seq.

    Patch 0 additionally owns the conditioning tokens, so their activations
    are refreshed every step by whichever stage holds patch 0.
    """
    assert num_patches >= 1
    assert latent_len % num_patches == 0, (
        f"latent length {latent_len} must divide into {num_patches} patches")
    chunk = latent_len // num_patches
    out = [(0, cond_tokens + chunk)]
    for p in range(1, num_patches):
        out.append((cond_tokens + p * chunk, chunk))
    return out


def stage_layers(n_layers: int, pp: int) -> list[tuple[int, int]]:
    """(first_layer, count) per pipeline stage — contiguous block split."""
    assert n_layers % pp == 0, (
        f"n_layers {n_layers} must divide into {pp} pipeline stages")
    per = n_layers // pp
    return [(s * per, per) for s in range(pp)]


def drop_rows(x: torch.Tensor, start: int, length: int,
              axis: int) -> torch.Tensor:
    """Remove rows [start, start+length) along ``axis``."""
    lo = x.narrow(axis, 0, start)
    hi = x.narrow(axis, start + length, x.shape[axis] - start - length)
    return torch.cat([lo, hi], dim=axis)


# ---------------------------------------------------------------------------
# displaced attention
# ---------------------------------------------------------------------------

def displaced_attention(
    q: torch.Tensor,        # [B, Lp, Hq, D] fresh queries of the resident patch
    k_fresh: torch.Tensor,  # [B, Lp, Hkv, D] fresh (post-RoPE) resident KV
    v_fresh: torch.Tensor,
    k_stale: torch.Tensor,  # [B, Lr, Hkv, D] one-step-stale KV, other rows
    v_stale: torch.Tensor,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention of a patch's fresh Q against mixed-freshness full-seq KV.

    The Appendix-C partial-and-merge algebra of the reference
    (``attend_partial`` on each part, one ``merge``) through the flash_mqkv
    kernel: two KV segments — the fresh rows, then the stale rows — with
    the (O', l, m) state carried from the first launch into the second and
    finalized once (``kernels.ops.flash_attention_segments``).  DiT
    attention is bidirectional and unwindowed, so no mask is needed.
    """
    segments = [(k_fresh, v_fresh, None)]
    if k_stale.shape[1]:
        segments.append((k_stale.to(q.dtype), v_stale.to(q.dtype), None))
    return flash_attention_segments(q, segments, scale=scale)


def kv_drift(old: KVState, new: KVState, *,
             per_item: bool = False) -> torch.Tensor:
    """Per-step KV staleness metric: RMS change of the per-layer KV state
    across one sampler step, in units of the state's own RMS magnitude.

    Scalar by default; ``per_item`` keeps the batch axis ([B]) so each
    batched request gets its own trajectory.  Finite even for an all-zero
    state.  Accumulated layer by layer in float32, so no full-size float
    copy of the state is made.
    """
    n_layers, b = old.k.shape[:2]
    dims = (1, 2, 3)  # [B, T, H, D] -> [B]
    num = torch.zeros(b, dtype=torch.float32, device=old.k.device)
    den = torch.zeros_like(num)
    for l in range(n_layers):
        for o, n in ((old.k[l], new.k[l]), (old.v[l], new.v[l])):
            o = o.float()
            num += ((n.float() - o) ** 2).sum(dim=dims)
            den += (o * o).sum(dim=dims)
    count = old.k[:, 0].numel()  # elements of one item's k (or v)
    if not per_item:
        num, den, count = num.sum(), den.sum(), count * b
    return torch.sqrt((num / count) / torch.clamp(den / count, min=1e-12))


def update_state_rows(state: KVState, k_new: torch.Tensor,
                      v_new: torch.Tensor, start: int,
                      first_layer: int = 0) -> KVState:
    """Write fresh per-layer KV rows of one patch into the state, in place.

    k_new/v_new: [n, B, Lp, Hkv, D] for layers [first_layer, first_layer+n);
    rows [start, start+Lp) of the sequence axis (2) are replaced.  Returns
    ``state``.
    """
    n, lp = k_new.shape[0], k_new.shape[2]
    layers = slice(first_layer, first_layer + n)
    rows = slice(start, start + lp)
    state.k[layers, :, rows] = k_new.to(state.k.dtype)
    state.v[layers, :, rows] = v_new.to(state.v.dtype)
    return state
