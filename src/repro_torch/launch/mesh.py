"""Meshes of virtual ranks (counterpart of ``src/repro/launch/mesh.py``).

The reference lays its SP schedules out on a ``jax.sharding.Mesh`` of
named axes, one device per point.  The port runs every point of a mesh in
one process on ONE device: a *virtual rank*.  Each rank's shard is a
tensor of its own, and a put writes into the peer rank's receive buffer,
which lies in the same address space — NVSHMEM's symmetric heap, trivially.
Ranks are numbered as ``lax.axis_index(axes)`` numbers them: the flat rank
over a tuple of axes is major-first.

Puts across NVLink or InfiniBand (one process per card) are not modelled
here; see ROADMAP.  Functions, not module constants: importing this module
touches no device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.blocks import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes; every rank lives on ``device``."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes "
                             f"{self.axis_sizes}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis in {self.axis_names}")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1: {self.axis_sizes}")
        dev = torch.device(self.device)
        if dev.type == "cuda" and dev.index is None:
            # the index tensors report, so that devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
        object.__setattr__(self, "device", dev)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (as ``jax`` meshes give it)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def axes_size(self, axes: tuple[str, ...]) -> int:
        """Number of ranks over ``axes`` (the flat-rank range)."""
        shape = self.shape
        return math.prod(shape[a] for a in axes)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device: str | torch.device | None = None) -> Mesh:
    """A mesh of virtual ranks on ``device`` (CUDA unless the caller asks
    for the CPU)."""
    return Mesh(tuple(axes), tuple(int(s) for s in shape),
                resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None) -> Mesh:
    """The reference's production mesh, (data 16, model 16), or (pod 2,
    data 16, model 16) with ``multi_pod``, as virtual ranks on ``device``
    (the dry-run runs it on ``meta``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(model: int = 1, data: int = 1,
                   device: str | torch.device | None = None) -> Mesh:
    """(data, model) mesh, as the reference's ``make_host_mesh``."""
    return make_mesh((data, model), ("data", "model"), device)


def make_hybrid_mesh(cfg: int = 1, pipe: int = 1, data: int = 1,
                     model: int = 1,
                     device: str | torch.device | None = None) -> Mesh:
    """(cfg, pipe, data, model) mesh for hybrid-parallel DiT serving, in
    the reference's axis order: cfg (syncs once per step) outermost, then
    pipe (stage hand-offs), then the batch and SP axes.  Size-1 axes are
    kept, so one SPConfig works across degrees."""
    return make_mesh((cfg, pipe, data, model), ("cfg", "pipe", "data", "model"),
                     device)


def launch_mesh(name: str, model: int = 1, data: int = 1,
                strategy: str = "swift_torus",
                device: str | torch.device | None = None):
    """The mesh of virtual ranks and the SP config that a launcher's
    ``--mesh`` names: ``host`` is (data, model) from ``data`` and
    ``model``, SP over model; ``pod`` is the paper's (pod 2, model 8), SP
    over both axes; ``multipod`` adds a data axis of 2, (pod 2, data 2,
    model 8).  Above SP degree 1 the schedule runs ``strategy`` through
    the put kernels (``comm_backend="pallas"``, the direct put K3 on a
    single-axis route); at degree 1 attention is "full"."""
    from ..core import SPConfig

    if name == "host":
        mesh = make_host_mesh(model=model, data=data, device=device)
        sp_axes, machine = ("model",), None
    elif name == "pod":
        mesh = make_mesh((2, 8), ("pod", "model"), device)
        sp_axes, machine = ("pod", "model"), "pod"
    elif name == "multipod":
        mesh = make_mesh((2, 2, 8), ("pod", "data", "model"), device)
        sp_axes, machine = ("pod", "model"), "pod"
    else:
        raise ValueError(f"unknown mesh {name!r}")
    degree = mesh.axes_size(sp_axes)
    sp = SPConfig(strategy=strategy if degree > 1 else "full",
                  sp_axes=sp_axes, batch_axes=("data",),
                  machine_axis=machine,
                  comm_backend="pallas" if degree > 1 else "xla",
                  kernel_interpret=False)
    return mesh, sp
