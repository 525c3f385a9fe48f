"""AdamW with a cosine schedule and global-norm clipping, in torch (the
counterpart of the reference's ``train/optimizer.py``).

The optimizer state mirrors the params tree.  ``adamw_update`` updates
the params and the moments in place (the counterpart of the reference's
``donate_argnums``: no second copy of the model or its moments is made),
one tensor at a time in float32 under ``torch.no_grad``, and casts each
result back to its tensor's dtype.  The schedule and the bias corrections
are host scalars computed in float32, as the reference computes them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch


class AdamWState(NamedTuple):
    step: int  # updates applied so far
    mu: Any  # first moment, mirrors params
    nu: Any  # second moment, mirrors params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # bf16 moments halve the optimizer's memory (the reference's setting
    # for very large MoEs)
    moments_dtype: str = "float32"


def tree_leaves(tree) -> list:
    """Leaves of a tree of dicts (keys sorted, as jax flattens them),
    lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``, called in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def init_adamw(params, cfg: AdamWConfig | None = None) -> AdamWState:
    """Zero moments beside every parameter, in ``cfg.moments_dtype``
    (float32 without a config, as the reference)."""
    dt = getattr(torch, cfg.moments_dtype) if cfg else torch.float32
    z = lambda p: torch.zeros_like(p, dtype=dt, requires_grad=False)
    return AdamWState(step=0, mu=tree_map(z, params), nu=tree_map(z, params))


def schedule(cfg: AdamWConfig, step) -> float:
    """Linear warmup to ``cfg.lr``, then a cosine decay to
    ``min_lr_frac * lr`` at ``total_steps``: the learning rate of update
    ``step`` (0-based), in float32 arithmetic."""
    f32 = np.float32
    step = f32(int(step))
    warm = min(f32(1.0), (step + f32(1)) / f32(cfg.warmup_steps))
    prog = np.clip((step - f32(cfg.warmup_steps))
                   / f32(max(1, cfg.total_steps - cfg.warmup_steps)),
                   f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * prog))
    frac = f32(cfg.min_lr_frac) + f32(1 - cfg.min_lr_frac) * cos
    return float(f32(cfg.lr) * warm * frac)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d tensor
    on the leaves' device)."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW update of ``params`` (and of the moments in ``state``) in
    place.  Returns (params, new state, metrics {"grad_norm": 0-d tensor,
    "lr": float}).  ``grads`` mirrors ``params``; it is clipped to
    ``clip_norm`` by its global norm."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, state.step)
    b1c = float(np.float32(1) - np.float32(cfg.b1) ** np.float32(step))
    b2c = float(np.float32(1) - np.float32(cfg.b2) ** np.float32(step))
    for p, m, n, g in zip(tree_leaves(params), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(grads)):
        g = g.float() * scale
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
        n_new = cfg.b2 * n.float() + (1 - cfg.b2) * g * g
        delta = (m_new / b1c) / (torch.sqrt(n_new / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        n.copy_(n_new)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {
        "grad_norm": gnorm, "lr": lr}
