"""Deterministic synthetic data (the counterpart of the reference's
``train/data.py``).

A seeded, stateless stream (step -> batch) matching the registry's
``input_specs``.  Token streams are an order-1 Markov chain over a fixed
random permutation with noise, so the LM loss can fall; every other input
is drawn in spec order.  The draws are the reference's numpy draws in the
same order, so a batch equals the reference's bit for bit; only the last
step, numpy -> tensor on ``device``, differs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape
from ..models.blocks import resolve_device
from ..models.registry import get_model


@dataclasses.dataclass(frozen=True)
class SyntheticStream:
    cfg: ModelConfig
    shape: InputShape
    seed: int = 0

    def _tokens(self, rng: np.random.Generator, b: int, l: int) -> np.ndarray:
        v = max(self.cfg.vocab, 4)
        # order-1 markov chain with shared transition structure: next token
        # depends on current via a fixed random permutation + noise.
        perm = np.random.default_rng(self.seed).permutation(v)
        x = np.empty((b, l + 1), np.int32)
        x[:, 0] = rng.integers(0, v, size=b)
        noise = rng.random((b, l))
        jump = rng.integers(0, v, size=(b, l))
        for t in range(l):
            nxt = perm[x[:, t]]
            x[:, t + 1] = np.where(noise[:, t] < 0.8, nxt, jump[:, t])
        return x

    def batch_numpy(self, step: int) -> dict[str, np.ndarray]:
        """Batch ``step`` as numpy arrays (floats in float32, before the
        cast to the model's dtype)."""
        rng = np.random.default_rng(self.seed * 100003 + step)
        spec = get_model(self.cfg).input_specs(self.cfg, self.shape,
                                               abstract=True)
        out = {}
        if "tokens" in spec and "labels" in spec:
            b, l = spec["tokens"].shape
            seq = self._tokens(rng, b, l)
            out["tokens"] = seq[:, :-1]
            out["labels"] = seq[:, 1:]
        for name, s in spec.items():
            if name in out:
                continue
            if not s.dtype.is_floating_point:
                if name == "positions":
                    out[name] = np.broadcast_to(
                        np.arange(s.shape[-1], dtype=np.int32), s.shape)
                else:
                    out[name] = rng.integers(0, max(self.cfg.vocab, 2),
                                             size=s.shape, dtype=np.int32)
            else:
                out[name] = (rng.standard_normal(s.shape).astype(np.float32)
                             * 0.02)
        return out

    def batch(self, step: int, device: str | torch.device | None = None
              ) -> dict[str, torch.Tensor]:
        """Batch ``step`` as tensors of the specs' dtypes on ``device``
        (CUDA unless the caller asks otherwise)."""
        device = resolve_device(device)
        spec = get_model(self.cfg).input_specs(self.cfg, self.shape,
                                               abstract=True)
        return {name: torch.from_numpy(np.ascontiguousarray(a)).to(
                    device=device, dtype=spec[name].dtype)
                for name, a in self.batch_numpy(step).items()}
