"""Meshes of virtual ranks (counterpart of ``src/repro/launch/mesh.py``).

The reference lays its SP schedules out on a ``jax.sharding.Mesh`` of
named axes, one device per point.  The port runs every point of a mesh in
one process on ONE device: a *virtual rank*.  Each rank's shard is a
tensor of its own, and a put writes into the peer rank's receive buffer,
which lies in the same address space — NVSHMEM's symmetric heap, trivially.
Ranks are numbered as ``lax.axis_index(axes)`` numbers them: the flat rank
over a tuple of axes is major-first.

A *process mesh* is the same mesh of ranks spread over ``procs``
processes (launch/procs.py), each owning a contiguous block of them:
one process per rank is the reference's layout, one device each
(``rank % device_count``).  A block lies within one coordinate of every
axis outside the SP axes (``Mesh.check_blocks``), so it holds one batch
slice and one coordinate of each replicated axis (pipe).  A rank list
spans some of the axes (the SP axes, the batch and SP axes, the batch
and pipe axes); its entry i stands for the flat rank with i's
coordinates on those axes and this process's own on the others, and
that rank's process owns it (``OwnerMap``).  Puts write into a peer
process's receive buffers, mapped here over CUDA IPC
(comm/kernel_backend.py); the default, one process owning every rank, is
the mesh of virtual ranks above.  What one card cannot show (NVLink and
InfiniBand, ``.sys`` visibility across cards) is ROADMAP Queue 1 item 8.
Functions, not module constants:
importing this module touches no device.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..models.blocks import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes; the ranks this process owns live on
    ``device``.  ``procs`` processes split the ranks into contiguous
    blocks and this one is ``process``: the default, one process, owns
    every rank (the mesh of virtual ranks)."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device
    process: int = 0
    procs: int = 1

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
        if self.size % self.procs or not 0 <= self.process < self.procs:
            raise ValueError(f"{self.size} ranks do not split over "
                             f"{self.procs} processes as process "
                             f"{self.process}")

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

    @property
    def owned(self) -> range:
        """The flat ranks (over every axis) this process owns."""
        k = self.size // self.procs
        return range(self.process * k, (self.process + 1) * k)

    @property
    def is_process_mesh(self) -> bool:
        """True when other processes own some of the ranks."""
        return self.procs > 1

    def coords(self, rank: int) -> tuple[int, ...]:
        """Flat rank ``rank``'s coordinate on every axis, in axis order."""
        out = []
        for n in reversed(self.axis_sizes):
            rank, c = divmod(rank, n)
            out.append(c)
        return tuple(reversed(out))

    def rank_of(self, coords) -> int:
        """The flat rank at ``coords`` (one per axis, in axis order)."""
        r = 0
        for c, n in zip(coords, self.axis_sizes):
            r = r * n + c
        return r

    def owner_map(self, axes) -> "OwnerMap":
        """Who owns each entry of a rank list over ``axes``."""
        return OwnerMap(self, tuple(axes))

    def check_blocks(self, sp_axes) -> None:
        """Refuse a process block that holds ranks of two coordinates of
        an axis outside ``sp_axes`` (two pipe stages, two batch slices):
        the process would then run two programs.  Blocks across the SP
        axes are fine, so long as they hold a contiguous run of SP ranks
        (a process's sequence shard is one run of rows)."""
        if not self.is_process_mesh:
            return
        k = self.size // self.procs
        sp = [self.axis_names.index(a) for a in sp_axes]
        for q in range(self.procs):
            block = [self.coords(r) for r in range(q * k, (q + 1) * k)]
            for i, name in enumerate(self.axis_names):
                if i not in sp and len({c[i] for c in block}) > 1:
                    raise ValueError(
                        f"process {q} of {self.procs} owns ranks {q * k}.."
                        f"{(q + 1) * k - 1} of mesh {self.shape}, across "
                        f"{name} coordinates {sorted({c[i] for c in block})}"
                        f": a process block must lie within one coordinate "
                        f"of every axis outside the SP axes {tuple(sp_axes)}")
            runs = sorted(self.owner_map(sp_axes).index_of(r)
                          for r in range(q * k, (q + 1) * k))
            if runs != list(range(runs[0], runs[0] + k)):
                raise ValueError(
                    f"process {q} of {self.procs} owns SP ranks {runs} of "
                    f"{tuple(sp_axes)} on mesh {self.shape}: a process "
                    "block must hold a contiguous run of SP ranks")

    def sp_owned(self, sp_axes) -> range:
        """The SP ranks (over ``sp_axes``) this process holds, a run."""
        owned = self.owner_map(sp_axes).owned
        return range(owned[0], owned[-1] + 1)

    def slice_of(self, axes) -> tuple[int, int]:
        """(index, count) of this process's slice over ``axes`` (the batch
        axes: a block lies within one coordinate of each)."""
        om = self.owner_map(axes or ())
        return om.owned[0], om.size

    def held_rows(self, sp_axes, total: int) -> tuple[int, int]:
        """The rows [start, stop) of a sequence of ``total`` rows that
        this process holds: its run of SP ranks' shards over ``sp_axes``
        (every row on a mesh of virtual ranks)."""
        if not self.is_process_mesh:
            return 0, total
        sp = self.axes_size(sp_axes)
        if total % sp:
            raise ValueError(f"a sequence of {total} rows does not split "
                             f"evenly over SP degree {sp}")
        held = self.sp_owned(sp_axes)
        return held.start * total // sp, held.stop * total // sp

    def held_batch(self, batch_axes, total: int) -> slice:
        """The rows of a batch of ``total`` that this process's batch
        slice holds (every row on a mesh of virtual ranks)."""
        if not self.is_process_mesh:
            return slice(0, total)
        s, n = self.slice_of(batch_axes)
        if total % n:
            raise ValueError(f"batch {total} does not split evenly over "
                             f"{n} batch slices")
        return slice(s * total // n, (s + 1) * total // n)


@dataclasses.dataclass(frozen=True)
class OwnerMap:
    """The owner map of a rank list over ``axes`` (major first) of
    ``mesh``: its entry i is the flat rank with i's coordinates on
    ``axes`` and this process's own on every other axis, and belongs to
    that rank's process.  ``owner(i)`` is (process, slot): the slot is
    i's place among the entries that process owns, which is where its
    receive buffers and signal words sit in every slab.  On a mesh whose
    SP axes are its only axes above size 1 the list's index is the flat
    rank."""

    mesh: Mesh
    axes: tuple[str, ...]

    @property
    def size(self) -> int:
        return self.mesh.axes_size(self.axes)

    def rank(self, index: int) -> int:
        """The flat rank that entry ``index`` stands for."""
        mesh = self.mesh
        coords = list(mesh.coords(mesh.owned[0]))
        for a in reversed(self.axes):
            index, coords[mesh.axis_names.index(a)] = divmod(
                index, mesh.shape[a])
        return mesh.rank_of(coords)

    def index_of(self, rank: int) -> int:
        """The entry of flat rank ``rank`` (its coordinates on ``axes``)."""
        coords = self.mesh.coords(rank)
        i = 0
        for a in self.axes:
            i = i * self.mesh.shape[a] + coords[self.mesh.axis_names.index(a)]
        return i

    @functools.cached_property
    def table(self) -> tuple[tuple[int, int], ...]:
        """(process, slot) of every entry."""
        per = self.mesh.size // self.mesh.procs
        slots: dict[int, int] = {}
        out = []
        for i in range(self.size):
            q = self.rank(i) // per
            out.append((q, slots.get(q, 0)))
            slots[q] = slots.get(q, 0) + 1
        return tuple(out)

    def owner(self, index: int) -> tuple[int, int]:
        return self.table[index]

    @functools.cached_property
    def owned(self) -> tuple[int, ...]:
        """The entries this process owns, in order."""
        me = self.mesh.process
        return tuple(i for i, (q, _) in enumerate(self.table) if q == me)


def process_mesh(mesh: Mesh, process: int, procs: int,
                 device: str | torch.device | None = None) -> Mesh:
    """``mesh`` spread over ``procs`` processes, as seen by ``process``:
    on the card its device is ``process % device_count`` unless
    ``device`` says otherwise."""
    if device is None:
        device = mesh.device
        if device.type == "cuda":
            device = torch.device("cuda",
                                  process % torch.cuda.device_count())
    return Mesh(mesh.axis_names, mesh.axis_sizes, resolve_device(device),
                process=process, procs=procs)


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
