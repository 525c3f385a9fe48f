"""Training loop (the counterpart of the reference's ``train/trainer.py``).

``make_train_step`` builds the update function: the bundle's loss in mode
"train" (every attention through K1, its gradient through K1b, each layer
under the context's activation checkpointing), ``torch.autograd.grad``
over the parameters, then ``adamw_update`` in place.  ``Trainer`` drives
steps, metrics and checkpointing.

The port trains every family at SP degree 1 on one device: dense, vlm,
audio (whisper), dit, the rwkv6 family (ssm: the WKV scan's gradient is
K5b), hybrid (hymba: attention through K1/K1b, the SSD scan in plain
torch) and moe (at EP 1 the expert exchange is the identity, so no put
kernel lies on the path).  Training over a mesh of virtual ranks needs the
backward of the SP schedule and of the expert-parallel exchanges (K2,
K3/K4): ROADMAP Queue 1 item 7.  It is refused, not run: on CUDA those
kernels' outputs carry no gradient.

The reference's ``batch_shardings`` (batch over the data axes, sequence
over the SP axes) has no counterpart: at SP degree 1 the whole batch lives
on the one device.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape
from ..core import SPConfig
from ..models import ParallelContext, get_model, resolve_device
from . import checkpoint as ckpt_lib
from .data import SyntheticStream
from .optimizer import (AdamWConfig, AdamWState, adamw_update, init_adamw,
                        tree_leaves, tree_map)

TRAIN_ITEM = "ROADMAP Queue 1 item 7"


def check_trainable(mesh=None) -> None:
    """Raise NotImplementedError for what the port cannot train yet: a
    mesh of more than one rank."""
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"training over a mesh of {mesh.size} virtual ranks needs the "
            f"backward of the SP schedule and of the puts ({TRAIN_ITEM})")


def make_train_step(cfg: ModelConfig, mesh, sp: SPConfig,
                    opt_cfg: AdamWConfig, remat: str = "full",
                    device: str | torch.device | None = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    params and moments updated in place.  ``mesh`` is None (or a mesh of
    one rank); ``device`` defaults to CUDA."""
    check_trainable(mesh)
    bundle = get_model(cfg)
    ctx = ParallelContext(sp, "train", device=device, mesh=mesh, remat=remat)

    def train_step(params, opt_state: AdamWState, batch):
        leaves = tree_leaves(params)
        loss, aux = bundle.loss(params, batch, cfg, ctx)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state,
                                                  params)
        metrics.update({"loss": loss.detach(), "aux_loss": aux.detach()})
        return params, opt_state, metrics

    return train_step


@dataclasses.dataclass
class Trainer:
    cfg: ModelConfig
    mesh: object  # None: one device (SP degree 1)
    sp: SPConfig
    shape: InputShape
    opt_cfg: AdamWConfig = AdamWConfig()
    seed: int = 0
    ckpt_path: str | None = None
    device: str | torch.device | None = None
    remat: str = "full"

    def setup(self):
        check_trainable(self.mesh)
        self.device = resolve_device(self.device)
        bundle = get_model(self.cfg)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        params = bundle.init(self.cfg, gen, self.device)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        opt_state = init_adamw(params)
        self.stream = SyntheticStream(self.cfg, self.shape, self.seed)
        self.step_fn = make_train_step(self.cfg, self.mesh, self.sp,
                                       self.opt_cfg, self.remat, self.device)
        return params, opt_state

    def run(self, steps: int, log_every: int = 10):
        """``steps`` updates from fresh parameters.  Returns (params,
        history): one dict (loss, aux_loss, grad_norm, lr, step, wall) per
        logged step.  ``self.step_seconds`` holds every step's host time,
        the device synchronised at its end."""
        params, opt_state = self.setup()
        history = []
        self.step_seconds = []
        cuda = self.device.type == "cuda"
        t0 = time.time()
        for step in range(steps):
            ts = time.perf_counter()
            batch = self.stream.batch(step, self.device)
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            if cuda:
                torch.cuda.synchronize(self.device)
            self.step_seconds.append(time.perf_counter() - ts)
            if step % log_every == 0 or step == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["wall"] = time.time() - t0
                history.append(m)
                print(f"step {step:5d} loss {m['loss']:.4f} "
                      f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}")
        if self.ckpt_path:
            ckpt_lib.save(self.ckpt_path, {"params": params, "step": steps})
        return params, history
