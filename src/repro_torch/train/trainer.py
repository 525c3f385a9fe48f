"""Training loop (the counterpart of the reference's ``train/trainer.py``).

``make_train_step`` builds the update function: the bundle's loss in mode
"train" (every attention through K1, its gradient through K1b, each layer
under the context's activation checkpointing), ``torch.autograd.grad``
over the parameters, then ``adamw_update`` in place.  ``Trainer`` drives
steps, metrics and checkpointing.

Every family trains, at SP degree 1 on one device and over a mesh of
virtual ranks (``mesh``, with ``sp`` naming its SP and batch axes): dense,
vlm, audio (whisper), dit, the rwkv6 family (ssm: the WKV scan's gradient
is K5b), hybrid (hymba: attention through K1/K1b, the SSD scan in plain
torch) and moe.  Over a mesh, attention is the SP schedule,
differentiated as a whole (core/sp_grad.py: K1b per KV chunk, the
all-to-alls and ring hops through the put kernels K3/K4), whisper's
cross-attention too (Lq != Lk); every other transfer is a channel put,
differentiable on its own (comm/grad.py: the backward puts the cotangents
along the inverse route): rwkv6's token shifts, the cross-rank state
passes of rwkv6 and hymba, and the moe family's expert-parallel exchange
at EP > 1.  The data axis needs no code: every virtual rank lives in this
process and reads the one set of parameters, so autograd sums the ranks'
gradients.

The reference's ``batch_shardings`` has no counterpart: the whole batch
lives on the one device and ``sp_attention`` splits it per rank.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape
from ..core import SPConfig
from ..models import ParallelContext, get_model, resolve_device
from ..models.moe import ep_degree
from . import checkpoint as ckpt_lib
from .data import SyntheticStream
from .optimizer import (AdamWConfig, AdamWState, adamw_update, init_adamw,
                        tree_leaves, tree_map)

def make_train_step(cfg: ModelConfig, mesh, sp: SPConfig,
                    opt_cfg: AdamWConfig, remat: str = "full",
                    device: str | torch.device | None = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    params and moments updated in place.  ``mesh`` is None for one device
    (``device``, CUDA by default) or a mesh of virtual ranks, whose device
    it is then."""
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
    mesh: object  # None: one device (SP degree 1); else launch.mesh.Mesh
    sp: SPConfig
    shape: InputShape
    opt_cfg: AdamWConfig = AdamWConfig()
    seed: int = 0
    ckpt_path: str | None = None
    device: str | torch.device | None = None
    remat: str = "full"

    def setup(self):
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(self.device))
        bundle = get_model(self.cfg)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        # the moe family's experts padded to split over the EP axis
        kw = ({"ep_degree": ep_degree(self.mesh)}
              if self.cfg.family == "moe" else {})
        params = bundle.init(self.cfg, gen, self.device, **kw)
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
