"""One process per rank: the launcher of a process mesh.

The reference runs every rank of its mesh on a device of its own.  The
mesh of virtual ranks (launch/mesh.py) runs them all in one process; this
launcher spreads the same mesh over P worker processes, each owning a
contiguous block of its ranks (one rank each at P = mesh size), on the
card ``rank % device_count`` unless the caller asks for the CPU:

  * workers start from ``torch.multiprocessing``'s "spawn" context and
    run a job of this package, ``job(group, *args)``;
  * each makes one zeroed slab (a uint8 ``torch.empty``) for its heap,
    held until every peer is done with it, and hands it to every peer
    through an ``mp.Queue``: torch's reduction shares it over CUDA IPC on
    the card and as shared memory on the CPU; each worker maps every
    peer's slab beside its own and installs the heap
    (comm/kernel_backend.py ``SymmetricHeap``);
  * barriers are ``mp.Barrier``; control messages (``Group.send`` /
    ``recv``) travel over one pipe per pair of workers; results come back
    to the caller as CPU tensors;
  * a watchdog joins the workers with a deadline and kills them all and
    raises when it passes: a stream wait on the card has no trap (a put
    whose signal never comes would wait for ever), and on the CPU a wait
    spins to the same deadline.

The parent builds the kernel libraries before spawning, so workers only
load them.  ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` is
refused: its segments do not share over CUDA IPC.  NCCL refuses two ranks
on one card, so nothing here uses a ``torch.distributed`` collective.

    python -m repro_torch.launch.serve --arch flux-12b --procs 4 ...

runs the serving launcher this way; the jobs below are what the tests and
``chip_smoke.py`` run across processes.
"""
from __future__ import annotations

import faulthandler
import gc
import io
import multiprocessing.connection
import os
import threading
import time
import traceback
from typing import Any, Callable

import torch

DEADLINE_S = 600.0
SLAB_BYTES = {"cuda": 512 << 20, "cpu": 16 << 20}
# what a worker process needs built before it starts (the SP path's, and
# rwkv6's K5 for its prefill)
LIBRARIES = ("flash_mqkv", "ring_flash", "one_sided", "rwkv6_wkv")

_group: "Group | None" = None


def group() -> "Group":
    """This worker's group (only inside a job the launcher runs)."""
    if _group is None:
        raise RuntimeError("not inside a worker of launch/procs.py")
    return _group


def _pack(obj: Any) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _unpack(data: bytes) -> Any:
    return torch.load(io.BytesIO(data), map_location="cpu",
                      weights_only=False)


def to_cpu(obj: Any) -> Any:
    """``obj`` with every tensor moved to the CPU (what crosses a pipe)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj


class Group:
    """The workers of one launch, seen from worker ``rank``: control
    messages over pipes (tensors cross as CPU tensors), a barrier, and
    the gather of a sharded result."""

    def __init__(self, rank: int, size: int, device: torch.device, links,
                 barrier, deadline: float):
        self.rank, self.size, self.device = rank, size, device
        self._links = links
        self._barrier = barrier
        self.deadline = deadline

    def send(self, peer: int, obj: Any) -> None:
        self._links[peer].send_bytes(_pack(to_cpu(obj)))

    def recv(self, peer: int) -> Any:
        if not self._links[peer].poll(self.deadline):
            raise TimeoutError(f"worker {self.rank}: no message from "
                               f"{peer} in {self.deadline} s")
        return _unpack(self._links[peer].recv_bytes())

    def barrier(self) -> None:
        self._barrier.wait(self.deadline)

    def all_gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every worker's ``x``, in rank order, on this worker's device.
        The sends run on a thread, so that no pair of workers blocks on a
        full pipe."""
        peers = [q for q in range(self.size) if q != self.rank]
        sender = threading.Thread(
            target=lambda: [self.send(q, x) for q in peers])
        sender.start()
        got = {q: self.recv(q).to(x.device) for q in peers}
        sender.join()
        got[self.rank] = x
        return [got[q] for q in range(self.size)]


def _check_allocator(device_type: str) -> None:
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "").replace(" ", "")
    if device_type == "cuda" and "expandable_segments:True" in conf:
        raise RuntimeError(
            "PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True: its segments "
            "do not share over CUDA IPC, which a process mesh maps its "
            "peers' heaps with; unset it")


def _worker(rank: int, size: int, job: Callable, args: tuple,
            device_type: str, slab_bytes: int, queues, barrier, links,
            result, deadline: float, threads: int | None) -> None:
    global _group
    from ..comm import kernel_backend as kb

    # a worker still running shortly before the watchdog kills it prints
    # where it waits
    faulthandler.dump_traceback_later(max(deadline - 5.0, 1.0), exit=False)
    try:
        if threads:
            torch.set_num_threads(threads)
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device(device_type)
        slab = torch.zeros(slab_bytes, dtype=torch.uint8, device=device)
        if device_type == "cpu":
            slab.share_memory_()
        for q in range(size):
            if q != rank:
                queues[q].put((rank, slab))
        slabs, peer = [None] * size, None
        slabs[rank] = slab
        for _ in range(size - 1):
            q, peer = queues[rank].get(timeout=deadline)
            slabs[q] = peer
        kb.install_heap(kb.SymmetricHeap(device, slabs, process=rank,
                                         deadline=deadline))
        _group = Group(rank, size, device, links, barrier, deadline)
        barrier.wait(deadline)  # every heap mapped before the first put
        out = to_cpu(job(_group, *args))
        if device_type == "cuda":
            torch.cuda.synchronize(device)
        # let go of the peers' slabs before any peer exits
        kb.uninstall_heap(device)
        del slabs, peer
        gc.collect()
        barrier.wait(deadline)  # every peer done with this slab
        result.send_bytes(_pack(("ok", out)))
    except BaseException:
        barrier.abort()
        result.send_bytes(_pack(("error", traceback.format_exc())))


def launch(job: Callable, procs: int, *args: Any, device: str = "cuda",
           deadline: float = DEADLINE_S, slab_bytes: int | None = None,
           threads: int | None = None) -> list:
    """Run ``job(group, *args)`` (a module-level function) in ``procs``
    worker processes, one heap each; returns each worker's result, in
    rank order, with its tensors on the CPU.  A worker that fails, dies or
    outlives ``deadline`` seconds (from the start) fails the launch: every
    worker is killed and the error raised.  ``threads`` sets each
    worker's intra-op threads.  CUDA tensors in ``args`` reach the
    workers over CUDA IPC: the caller keeps them alive until the launch
    returns."""
    device_type = torch.device(device).type
    _check_allocator(device_type)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu'")
        from ..kernels import _build

        for name in LIBRARIES:
            _build.build(name)
    elif device_type != "cpu":
        raise ValueError(f"a process mesh runs on cuda or cpu, not {device}")
    slab_bytes = slab_bytes or SLAB_BYTES[device_type]
    ctx = torch.multiprocessing.get_context("spawn")
    queues = [ctx.Queue() for _ in range(procs)]
    barrier = ctx.Barrier(procs)
    links = [[None] * procs for _ in range(procs)]
    for a in range(procs):
        for b in range(a + 1, procs):
            links[a][b], links[b][a] = ctx.Pipe()
    workers, results = [], []
    until = time.monotonic() + deadline
    try:
        for r in range(procs):
            rx, tx = ctx.Pipe(duplex=False)
            w = ctx.Process(target=_worker, daemon=True, args=(
                r, procs, job, args, device_type, slab_bytes, queues,
                barrier, links[r], tx, deadline, threads))
            w.start()
            tx.close()
            workers.append(w)
            results.append(rx)
        for row in links:  # the workers hold their own ends now
            for c in row:
                if c is not None:
                    c.close()
        return _watch(workers, results, until, deadline)
    finally:
        for w in workers:
            if w.is_alive():
                w.kill()
        for w in workers:
            w.join(10)


def _watch(workers, results, until: float, deadline: float) -> list:
    """Collect every worker's report before ``until``; raise on the
    first failure (with whatever the others report within a few seconds)
    or at the deadline."""
    out = [None] * len(workers)
    pending = set(range(len(workers)))
    errors: dict[int, str] = {}
    while pending:
        left = until - time.monotonic()
        if left <= 0:
            raise TimeoutError(
                f"process mesh: workers {sorted(pending)} still running "
                f"after the {deadline} s deadline (a put whose signal never "
                "came, or a hung worker); every worker was killed")
        waitables = [results[r] for r in pending] + [
            workers[r].sentinel for r in pending]
        multiprocessing.connection.wait(waitables, timeout=left)
        for r in sorted(pending):
            if results[r].poll():
                try:
                    status, value = _unpack(results[r].recv_bytes())
                except EOFError:
                    status, value = "error", (
                        f"exited with code {workers[r].exitcode} before it "
                        "reported")
                pending.discard(r)
                if status == "ok":
                    out[r] = value
                else:
                    errors[r] = value
            elif not workers[r].is_alive():
                pending.discard(r)
                errors[r] = (f"died with exit code {workers[r].exitcode} "
                             "before it reported")
        if errors:
            grace = time.monotonic() + 3.0
            for r in sorted(pending):
                if results[r].poll(max(grace - time.monotonic(), 0)):
                    try:
                        status, value = _unpack(results[r].recv_bytes())
                    except EOFError:
                        continue  # it died without a report
                    if status != "ok":
                        errors[r] = value
            # the first failure first: the others often only saw the
            # broken barrier it left
            order = sorted(errors, key=lambda r: "BrokenBarrierError"
                           in errors[r])
            raise RuntimeError("process mesh: " + "\n".join(
                f"worker {r} failed:\n{errors[r]}" for r in order))
    for w in workers:
        w.join(max(until - time.monotonic(), 1.0))
        if w.exitcode not in (0, None):
            raise RuntimeError(f"process mesh: a worker exited with code "
                               f"{w.exitcode} after it reported")
    return out


# ---------------------------------------------------------------------------
# jobs: what the tests, chip_smoke.py and the serving launcher run
# ---------------------------------------------------------------------------

def launch_counts() -> dict:
    """The kernel launch counters of this process (CUDA launches only)."""
    from ..comm import kernel_backend as kb
    from ..kernels import flash_mqkv as fm
    from ..kernels import ring_flash as rf

    return {"flash_mqkv": fm.launch_count(),
            "ring_flash_step": rf.launch_count(),
            "remote_put": kb.launch_count("remote_put"),
            "landing_copy": kb.launch_count("landing_copy")}


def reset_counts() -> None:
    from ..comm import kernel_backend as kb
    from ..kernels import flash_mqkv as fm
    from ..kernels import ring_flash as rf

    fm.reset_launch_count()
    rf.reset_launch_count()
    kb.reset_launch_count()


def chain_job(group: Group, jobs: list) -> list:
    """Several jobs, ``(job, args)`` each, one after another in the same
    workers (one spawn for all)."""
    return [job(group, *args) for job, args in jobs]


def _sp_inputs(spec: dict, device: torch.device):
    """q, k, v of an ``sp_attention_job`` case: given (CPU tensors), or
    drawn on the device from ``seed`` (every worker draws the same)."""
    if "qkv" in spec:
        return [x.to(device) for x in spec["qkv"]]
    b, l, hq, hkv, d = spec["shape"]
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    dtype = getattr(torch, spec.get("dtype", "float32"))
    return [torch.randn((b, l, h, d), generator=gen, device=device).to(dtype)
            for h in (hq, hkv, hkv)]


def sp_attention_job(group: Group, cases: list[dict]) -> list[dict]:
    """``core.sp_attention`` on process meshes: per case (``mesh``:
    (shape, axes); ``sp``: SPConfig fields; ``causal``; inputs as
    ``_sp_inputs`` reads them; ``steps``: calls in a row, each on inputs
    of seed + step) this worker's output shards, its launch counts and
    the heap offsets it allocated (``offsets``: a list per call of
    (kind, offset) in allocation order) and the most of its slab a call
    used (``heap_bytes``); ``rows`` and ``batch`` say which rows of the
    sequence and the batch the shards are (its SP ranks', its batch
    slice's).  ``wrong_route`` makes every
    Ulysses stage hop land on the sender itself: a put along the wrong
    route, which a bitwise check must catch."""
    from ..comm import kernel_backend as kb
    from ..core import SPConfig, sp_attention
    from ..core.collectives import GroupLayout
    from .mesh import make_mesh, process_mesh

    out = []
    for spec in cases:
        mesh = process_mesh(make_mesh(*spec["mesh"], device=group.device),
                            group.rank, group.size)
        cfg = SPConfig(**spec["sp"])
        b, ln = (spec["shape"][:2] if "shape" in spec
                 else spec["qkv"][0].shape[:2])
        sp, held = mesh.axes_size(cfg.sp_axes), mesh.sp_owned(cfg.sp_axes)
        rows = slice(held.start * ln // sp, held.stop * ln // sp)
        s, n = mesh.slice_of(cfg.effective_batch_axes(mesh) or ())
        batch = slice(s * b // n, (s + 1) * b // n)
        heap = kb.process_heap(group.device)
        real = GroupLayout.ulysses_stage_perm
        if spec.get("wrong_route"):
            GroupLayout.ulysses_stage_perm = lambda self, k: [
                (p, p) for p, _ in real(self, k)]
        shards, offsets = [], []
        reset_counts()
        t0 = time.perf_counter()
        try:
            for step in range(spec.get("steps", 1)):
                drawn = (dict(spec, seed=spec["seed"] + step)
                         if "seed" in spec else spec)
                q, k, v = (x[batch, rows]
                           for x in _sp_inputs(drawn, group.device))
                heap.trace = []
                shards.append(sp_attention(q, k, v, cfg=cfg, mesh=mesh,
                                           causal=spec.get("causal", False)))
                offsets.append(heap.trace)
                heap.trace = None
            if group.device.type == "cuda":
                torch.cuda.synchronize(group.device)
        finally:
            GroupLayout.ulysses_stage_perm = real
        out.append({"shards": shards, "rows": (rows.start, rows.stop),
                    "batch": (batch.start, batch.stop),
                    "counts": launch_counts(), "offsets": offsets,
                    "seconds": time.perf_counter() - t0,
                    "heap_bytes": heap.high_water})
    return out


def _dit_params(spec: dict, device: torch.device):
    """The DiT config and weights of a job: the reference's tree handed
    across as numpy (``tree``), or ``init_dit`` from ``seed`` with the
    zero-initialised tensors perturbed from ``seed + 1``."""
    import dataclasses

    from ..configs import get_config, get_reduced
    from ..models import init_dit, load_jax_params

    cfg = (get_reduced(spec["arch"]) if spec.get("reduced")
           else get_config(spec["arch"]))
    cfg = dataclasses.replace(cfg, **spec.get("cfg", {}))
    if "tree" in spec:
        return cfg, load_jax_params(spec["tree"], cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    params = init_dit(cfg, gen, device=device)
    gen.manual_seed(spec["seed"] + 1)
    perturb_dit(params, gen)
    return cfg, params


def perturb_dit(params, gen: torch.Generator) -> None:
    """Draw the tensors a fresh DiT holds at zero (adaLN, the output
    projection), so that it is no identity: fan-in normal."""
    with torch.no_grad():
        for tree in [params["ada_f"], params["proj_out"]] + [
                lp["ada"] for lp in params["layers"]]:
            w = tree["w"]
            w.copy_(torch.randn(w.shape, generator=gen, device=w.device)
                    .mul_(w.shape[0] ** -0.5).to(w.dtype))


def dit_step_job(group: Group, spec: dict) -> dict:
    """``serving.sampler.sample_step`` on a process mesh: the latents
    (``inputs["latents"]``, whole) are cut to this worker's rows, stepped
    ``steps`` times from ``t`` by ``dt``, and returned as its shard.  Then
    ``serving.sampler.sample`` from the same latents as noise for
    ``sample_steps`` steps: every worker returns the gathered latents."""
    from ..core import SPConfig
    from ..models import ParallelContext
    from ..models.dit import latent_rows
    from ..serving.sampler import SamplerConfig, sample, sample_step
    from .mesh import make_mesh, process_mesh

    cfg, params = _dit_params(spec, group.device)
    mesh = process_mesh(make_mesh(*spec["mesh"], device=group.device),
                        group.rank, group.size)
    ctx = ParallelContext(SPConfig(**spec["sp"]), mesh=mesh)
    x = spec["inputs"]["latents"].to(group.device)
    seq = x.shape[1]
    x = x[:, latent_rows(ctx, seq)]
    cond = spec["inputs"]["cond"].to(group.device)
    reset_counts()
    t = spec.get("t", 0.8)
    dt = spec.get("dt", 0.25)
    with torch.inference_mode():
        for i in range(spec.get("steps", 1)):
            x = sample_step(params, cfg, ctx, x, cond, t - i * dt, dt,
                            SamplerConfig(num_steps=4), seq_len=seq)
    noise = spec["inputs"]["latents"].to(group.device)
    sampled = sample(params, cfg, ctx, batch=noise.shape[0], seq_len=seq,
                     cond=cond, noise=noise,
                     sc=SamplerConfig(num_steps=spec.get("sample_steps", 2)))
    rows = latent_rows(ctx, seq)
    return {"shard": x, "rows": (rows.start, rows.stop), "sampled": sampled,
            "counts": launch_counts()}


def _sampler(spec: dict):
    """A job's SamplerConfig: ``sampler`` (its fields, ``pipeline`` those
    of a PipelineConfig) or ``num_steps=steps``."""
    from ..core import PipelineConfig
    from ..serving import SamplerConfig

    kw = dict(spec.get("sampler", {"num_steps": spec.get("steps")}))
    if kw.get("pipeline") is not None:
        kw["pipeline"] = PipelineConfig(**kw["pipeline"])
    return SamplerConfig(**kw)


def serve_job(group: Group, spec: dict) -> dict:
    """``DiTServer`` on a process mesh: every worker builds the same
    weights and server (``sampler``: its SamplerConfig fields; ``drift``:
    a DriftPolicy's threshold; ``max_batch``); worker 0 runs the
    scheduler, submits ``requests`` ((rid, latent tokens) pairs, each
    with a cond drawn from ``seed + 2 + rid``) and serves them, the others
    follow its steps.  Worker 0 returns each request's latents, kv_drift
    and resyncs; every worker its launch counts, the wall time of the
    served run and the most of its slab a step used.  ``wrong_route``
    sends every cfg exchange's put to the sender's own branch, or on a
    mesh without a cfg axis every Ulysses stage hop to the sender itself:
    a put along the wrong route, which the latents' check must catch."""
    from ..comm import kernel_backend as kb
    from ..core import SPConfig
    from ..serving import DiTRequest, DiTServer
    from ..serving.sched import DriftPolicy
    from .mesh import make_mesh, process_mesh

    cfg, params = _dit_params(spec, group.device)
    mesh = process_mesh(make_mesh(*spec["mesh"], device=group.device),
                        group.rank, group.size)
    drift = DriftPolicy(spec["drift"]) if "drift" in spec else None
    srv = DiTServer(params, cfg, SPConfig(**spec["sp"]), mesh=mesh,
                    sampler=_sampler(spec), drift=drift,
                    max_batch=spec.get("max_batch", 4), capture=False)
    undo = _misroute(("cfg" if "cfg" in mesh.axis_names else "ulysses")
                     if spec.get("wrong_route") else None)
    reset_counts()
    t0 = time.perf_counter()
    got = {}
    try:
        if group.rank == 0:
            for rid, seq in spec["requests"]:
                gen = torch.Generator(device=group.device).manual_seed(
                    spec["seed"] + 2 + rid)
                cond = torch.randn((256, cfg.d_model), generator=gen,
                                   device=group.device).to(srv.dtype)
                srv.submit(DiTRequest(rid=rid, seq_len=seq, cond=cond))
            got = {r.rid: {"latents": r.latents, "kv_drift": r.kv_drift,
                           "resyncs": r.resyncs} for r in srv.serve()}
            srv.stop_followers()
        else:
            srv.follow()
    finally:
        undo()
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    return {"latents": {rid: r["latents"] for rid, r in got.items()},
            "results": got, "counts": launch_counts(),
            "seconds": time.perf_counter() - t0,
            "heap_bytes": kb.process_heap(group.device).high_water}


def hybrid_sample_job(group: Group, spec: dict) -> dict:
    """``serving.sampler.sample`` on a process mesh with the sampler of
    ``sampler`` (the pipelined and CFG-parallel ones): from the whole
    ``noise`` and ``cond`` of the batch, every worker returns the
    gathered latents, its metrics, its launch counts, the heap offsets
    of its every allocation (``offsets``) and the most of its slab a step
    used (``heap_bytes``)."""
    from ..comm import kernel_backend as kb
    from ..core import SPConfig
    from ..models import ParallelContext
    from ..serving.sampler import sample
    from .mesh import make_mesh, process_mesh

    cfg, params = _dit_params(spec, group.device)
    mesh = process_mesh(make_mesh(*spec["mesh"], device=group.device),
                        group.rank, group.size)
    ctx = ParallelContext(SPConfig(**spec["sp"]), mesh=mesh)
    noise = spec["noise"].to(group.device, getattr(torch, cfg.dtype))
    heap = kb.process_heap(group.device)
    heap.trace, metrics = [], []
    reset_counts()
    out = sample(params, cfg, ctx, batch=noise.shape[0],
                 seq_len=noise.shape[1], cond=spec["cond"].to(noise),
                 noise=noise, sc=_sampler(spec), metrics=metrics)
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    offsets, heap.trace = heap.trace, None
    return {"latents": out, "metrics": metrics, "counts": launch_counts(),
            "offsets": offsets, "heap_bytes": heap.high_water}


def handoff_job(group: Group, cases: list[dict]) -> list[dict]:
    """``comm.pipe_handoff`` on process meshes: per case (``mesh``;
    ``batch_axes``) every worker hands over a tensor filled
    with its own number (so a receiver can tell its sender) and returns
    what it received and its coordinates.  ``old_owner`` routes the put
    by the flat-rank rule, the list's index read as the flat rank
    (``divmod(index, size // procs)``): the negative control."""
    from ..comm import Stream, pipe_handoff
    from ..comm import kernel_backend as kb
    from .mesh import OwnerMap, make_mesh, process_mesh

    out = []
    for spec in cases:
        mesh = process_mesh(make_mesh(*spec["mesh"], device=group.device),
                            group.rank, group.size)
        x = torch.full((2, 4096), float(group.rank), device=group.device)
        real = OwnerMap.owner
        if spec.get("old_owner"):
            OwnerMap.owner = lambda self, i: divmod(
                i, self.size // self.mesh.procs)
        try:
            with kb.process_step(group.device):
                got = pipe_handoff(
                    x, mesh, "pipe", batch_axes=spec.get("batch_axes"),
                    stream=Stream("pipe", backend="pallas",
                                  interpret=False)).wait().clone()
        finally:
            OwnerMap.owner = real
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)
        out.append({"got": got, "coords": mesh.coords(mesh.owned[0]),
                    "counts": launch_counts()})
    return out


def hier_job(group: Group, cases: list[dict]) -> list[dict]:
    """``comm.hier_all_to_all`` on process meshes: per case (``mesh``;
    ``sp_axes``; ``layout``: GroupLayout fields; ``x``: every rank's
    tensor; ``err``: every rank's residuals or None; ``wire_dtype``)
    this worker's received chunks and new residuals, by
    rank."""
    from ..comm import kernel_backend as kb
    from ..comm.stream import hier_all_to_all
    from ..core.collectives import GroupLayout, SlicedLayout
    from .mesh import make_mesh, process_mesh

    out = []
    for spec in cases:
        mesh = process_mesh(make_mesh(*spec["mesh"], device=group.device),
                            group.rank, group.size)
        owners = mesh.owner_map(spec["sp_axes"])
        layout = SlicedLayout(GroupLayout(**spec["layout"]), 1,
                              owners=owners)
        x = [t.to(group.device) if p in owners.owned else None
             for p, t in enumerate(spec["x"])]
        err = spec.get("err")
        if err is not None:
            err = [tuple(e.to(group.device) for e in err[p])
                   if p in owners.owned else None for p in range(len(x))]
        reset_counts()
        with kb.process_step(group.device):
            res = hier_all_to_all(x, layout, split_axis=spec["split_axis"],
                                  backend="pallas",
                                  interpret=False,
                                  wire_dtype=spec.get("wire_dtype"), err=err)
            got, new_err = res if err is not None else (res, None)
            got = [None if t is None else t.clone() for t in got]
        out.append({"out": {p: got[p] for p in owners.owned},
                    "err": (None if new_err is None else
                            {p: new_err[p] for p in owners.owned}),
                    "counts": launch_counts()})
    return out


def shift_put_job(group: Group, withhold: int | None = None) -> dict:
    """One put along a shift of every rank (K3 on the card, its plain
    version on the CPU): this worker's rank receives its predecessor's
    tensor.  Worker ``withhold`` never issues its part: its successor then
    waits on a signal word that never comes (the watchdog's case)."""
    from ..comm import Channel, shift_perm
    from .mesh import make_mesh, process_mesh

    x = [None] * group.size
    x[group.rank] = torch.full((4096,), float(group.rank),
                               device=group.device)
    mesh = process_mesh(make_mesh((group.size,), ("model",),
                                  device=group.device), group.rank,
                        group.size)
    ch = Channel(("model",), shift_perm(group.size), backend="pallas",
                 interpret=False, owners=mesh.owner_map(("model",)))
    reset_counts()
    if group.rank == withhold:
        return {}
    got = ch.put(x).wait()
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    return {"got": got[group.rank], "counts": launch_counts()}


# ---------------------------------------------------------------------------
# the language models over a process mesh
# ---------------------------------------------------------------------------

def perturb_lm(params, gen: torch.Generator) -> None:
    """Draw the tensors a fresh LM or whisper holds at a constant, so that
    each takes part (in place): every linear and LayerNorm bias from
    N(0, 0.1^2) and every norm scale from 1 + N(0, 0.1^2); hymba's SSD
    ``a_log`` from N(0, 0.5^2); rwkv6's decay base ``w0`` from U[-6, -1],
    its token-shift mixes ``mu_*`` from U[0, 1], its bonus ``u`` from
    N(0, 0.5^2) and ``wlora_b`` small (the ranges RWKV6 initialises them
    in: the decays then lie in about [0.68, 0.998])."""
    def draw(t, x):
        return x.to(device=t.device, dtype=t.dtype)

    def normal(t, std, mean=0.0):
        return draw(t, torch.randn(t.shape, generator=gen, device=t.device)
                    * std + mean)

    def walk(tree):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for name, leaf in list(items):
            if isinstance(leaf, (dict, list)):
                walk(leaf)
            elif name in ("b", "bias"):
                tree[name] = normal(leaf, 0.1)
            elif name in ("scale", "norm_scale"):
                tree[name] = normal(leaf, 0.1, 1.0)
            elif name == "a_log":
                tree[name] = normal(leaf, 0.5)

    with torch.no_grad():
        walk(params)
        for lp in params.get("layers", []):
            tm = lp.get("tm")
            if tm is None:
                continue
            rand = lambda t: torch.rand(t.shape, generator=gen,
                                        device=t.device)
            tm["w0"] = draw(tm["w0"], rand(tm["w0"]) * 5.0 - 6.0)
            for mix in (tm, lp["cm"]):
                for name in [k for k in mix if k.startswith("mu_")]:
                    mix[name] = draw(mix[name], rand(mix[name]))
            tm["u"] = normal(tm["u"], 0.5)
            wb = tm["wlora_b"]["w"]
            tm["wlora_b"]["w"] = normal(wb, 0.01 / wb.shape[0] ** 0.5)


def _lm_params(spec: dict, device: torch.device):
    """An LM's or whisper's config and weights for a job: the reference's
    tree handed across as numpy (``tree``), or ``init_lm`` /
    ``init_whisper`` from ``seed`` with the constant tensors drawn from
    ``seed + 1`` (``perturb_lm``).  ``cfg`` overrides config fields
    (``n_layers``, ``dtype``)."""
    import dataclasses

    from ..configs import get_config, get_reduced
    from ..models import (init_lm, init_whisper, load_jax_lm_params,
                          load_jax_whisper_params)

    cfg = (get_reduced(spec["arch"]) if spec.get("reduced")
           else get_config(spec["arch"]))
    cfg = dataclasses.replace(cfg, **spec.get("cfg", {}))
    audio = cfg.family == "audio"
    if "tree" in spec:
        load = load_jax_whisper_params if audio else load_jax_lm_params
        return cfg, load(spec["tree"], cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    params = (init_whisper if audio else init_lm)(cfg, gen, device=device)
    gen.manual_seed(spec["seed"] + 1)
    perturb_lm(params, gen)
    return cfg, params


def lm_inputs(spec: dict, cfg, device: torch.device) -> dict:
    """The whole batch of an LM or whisper job: ``tokens`` [B, L] given as
    a CPU tensor, or drawn on the device from ``seed + 2`` at ``shape``
    (B, L[, T]), every process and the caller drawing the same; whisper's
    ``frames`` [B, T, d], and the vlm's stubbed frontend embeddings
    ``inputs_embeds`` [B, L, d] with its M-RoPE ``positions`` [3, B, L]
    (t, h, w of a patch grid 4 wide) beside them."""
    from ..models.blocks import torch_dtype

    gen = torch.Generator(device=device).manual_seed(spec.get("seed", 0)
                                                      + 2)
    if "tokens" in spec:
        out = {"tokens": spec["tokens"].to(device)}
    else:
        out = {"tokens": torch.randint(0, cfg.vocab, spec["shape"][:2],
                                       generator=gen, device=device)}
    b, l = out["tokens"].shape
    draw = lambda t: (torch.randn((b, t, cfg.d_model), generator=gen,
                                  device=device) * 0.5).to(
                                      torch_dtype(cfg.dtype))
    if cfg.family == "audio":
        out["frames"] = draw(spec["shape"][2])
    if cfg.family == "vlm":
        out["inputs_embeds"] = draw(l)
        t = torch.arange(l, device=device)
        out["positions"] = torch.stack([t, t // 4, t % 4])[:, None].expand(
            3, b, l)
    return out


def _misroute(kind: str | None) -> Callable[[], None]:
    """Put a schedule's puts along a wrong route until the returned undo
    is called: ``"ulysses"`` lands every Ulysses stage hop on the sender
    itself; ``"shift"`` does so for every token shift (models/lm.py
    ``_token_shift``: each rank then reads its own last row); ``"state"``
    for every put of the SSD and WKV state passes' scan
    (``ssm.distributed_state_in``: each rank composes its own summary);
    ``"cfg"`` for every cfg exchange (each branch gets its own velocity
    back)."""
    from ..comm import Stream
    from ..core.collectives import GroupLayout
    from ..models import lm as lm_mod
    from ..models import ssm as ssm_mod

    if kind is None:
        return lambda: None
    if kind == "cfg":
        real_put = Stream.put

        def put(self, axes, perm, *tensors, **kw):
            if self.name == "cfg":
                perm = [(p, p) for p, _ in perm]
            return real_put(self, axes, perm, *tensors, **kw)
        Stream.put = put

        def undo():
            Stream.put = real_put
        return undo
    if kind == "ulysses":
        real = GroupLayout.ulysses_stage_perm
        GroupLayout.ulysses_stage_perm = lambda self, k: [
            (p, p) for p, _ in real(self, k)]

        def undo():
            GroupLayout.ulysses_stage_perm = real
        return undo
    if kind in ("shift", "state"):
        # both ride ssm.shift_ranks' ring puts; misroute them only inside
        # the token shift, or only inside the state passes' scan
        module, name = ((lm_mod, "_token_shift") if kind == "shift"
                        else (ssm_mod, "distributed_state_in"))
        real_fn, real_perm = getattr(module, name), GroupLayout.ring_perm

        def wrong(*a, **kw):
            GroupLayout.ring_perm = lambda self, s=1: [
                (p, p) for p, _ in real_perm(self, s)]
            try:
                return real_fn(*a, **kw)
            finally:
                GroupLayout.ring_perm = real_perm
        setattr(module, name, wrong)

        def undo():
            setattr(module, name, real_fn)
        return undo
    raise ValueError(f"unknown wrong_route {kind!r}")


def _held(logits: torch.Tensor, spec: dict, batch: slice,
          rows: tuple[int, int]) -> dict:
    """A job's logits, or with ``twin`` (the whole batch's logits on the
    mesh of virtual ranks, on this device) how this process's rows hold
    against the twin's: bitwise, and the largest difference relative to
    the twin's max|logits|."""
    twin = spec.get("twin")
    if twin is None:
        return {"logits": logits}
    want = twin[batch, rows[0]:rows[1]]
    scale = max(float(t.abs().max()) for t in twin)  # a batch row at a time
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(logits, want))
    return {"bitwise": torch.equal(logits, want), "err": err / scale}


def _k5_count() -> int:
    import importlib

    return importlib.import_module(
        "repro_torch.kernels.rwkv6_wkv").launch_count()


def _lm_case(group: Group, spec: dict, run: Callable,
             mode: str = "prefill") -> dict:
    """One case of ``lm_prefill_job`` / ``lm_decode_job``: the process
    mesh and its SPConfig, the whole inputs, this process's rows and batch
    slice; ``run(spec, params, cfg, ctx, inputs, batch, rows)`` gives the
    logits.  ``refusal``: the case must raise NotImplementedError, whose
    message is returned."""
    import importlib

    from ..comm import kernel_backend as kb
    from ..core import SPConfig
    from ..models import ParallelContext
    from .mesh import make_mesh, process_mesh

    cfg, params = _lm_params(spec, group.device)
    mesh = process_mesh(make_mesh(*spec["mesh"], device=group.device),
                        group.rank, group.size)
    sp = SPConfig(**spec["sp"])
    ctx = ParallelContext(sp, mode, mesh=mesh)
    inputs = lm_inputs(spec, cfg, group.device)
    b, l = inputs["tokens"].shape
    rows = mesh.held_rows(sp.sp_axes, l) if mode == "prefill" else (0, l)
    batch = mesh.held_batch(sp.effective_batch_axes(mesh) or (), b)
    heap = kb.process_heap(group.device)
    heap.trace = []
    importlib.import_module("repro_torch.kernels.rwkv6_wkv") \
        .reset_launch_count()
    reset_counts()
    undo = _misroute(spec.get("wrong_route"))
    t0 = time.perf_counter()
    try:
        with torch.inference_mode():
            logits = run(spec, params, cfg, ctx, inputs, batch, rows)
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)
    except NotImplementedError as err:
        if not spec.get("refusal"):
            raise
        return {"refused": str(err)}
    finally:
        undo()
        offsets, heap.trace = heap.trace, None
    if spec.get("refusal"):
        raise RuntimeError(f"{spec['arch']} over a process mesh was not "
                           "refused")
    counts = dict(launch_counts(), rwkv6_wkv=_k5_count())
    return dict(_held(logits, spec, batch, rows), rows=rows,
                batch=(batch.start, batch.stop), counts=counts,
                offsets=offsets, seconds=time.perf_counter() - t0,
                heap_bytes=heap.high_water)


def lm_prefill_job(group: Group, cases: list[dict]) -> list[dict]:
    """An LM's prefill, or whisper's teacher-forced forward (``bundle.apply``)
    on process meshes: per case (``arch``, ``reduced``, ``cfg``: config
    overrides; weights as ``_lm_params`` makes them; ``mesh``: (shape,
    axes); ``sp``: SPConfig fields; inputs as ``lm_inputs`` makes them,
    whole) every process runs its batch slice and sequence shard of each
    input (the vlm's embeddings and M-RoPE positions too; whisper's frames
    at their own length, so that its cross-attention has Lq != Lk),
    ``seq_len`` the whole, and returns its logits (or, with ``twin``, how
    they hold against the twin's rows: ``_held``), its rows and batch
    slice, its launch counts (K5's beside the others), the heap offsets it
    allocated and its slab's high-water mark.  ``last_only``: the final
    position's logits (zero rows on the processes that do not hold it).
    ``wrong_route``: a ``_misroute`` kind, a negative control;
    ``refusal``: the case must raise (the MoE LMs)."""
    from ..models import get_model

    def run(spec, params, cfg, ctx, inputs, batch, rows):
        kw = {"last_only": True} if spec.get("last_only") else {}
        shard = {}
        for k, x in inputs.items():
            lo, hi = rows
            if k == "frames":
                kw["enc_len"] = x.shape[1]
                lo, hi = ctx.mesh.held_rows(ctx.sp.sp_axes, x.shape[1])
            shard[k] = (x[..., batch, lo:hi] if k == "positions"
                        else x[batch, lo:hi])
        return get_model(cfg).apply(params, shard, cfg, ctx,
                                    seq_len=inputs["tokens"].shape[1], **kw)

    return [_lm_case(group, spec, run) for spec in cases]


def lm_decode_job(group: Group, cases: list[dict]) -> list[dict]:
    """An LM's teacher-forced decode (``bundle.step`` at every position of
    ``tokens``) on process meshes, each process with its part of caches
    as long as the tokens (``init_caches`` with the mesh): per case, as
    ``lm_prefill_job``, its batch slice's logits at every position
    [B_slice, L, V]."""
    from ..models import get_model, torch_dtype

    def run(spec, params, cfg, ctx, inputs, batch, rows):
        bundle = get_model(cfg)
        tokens = inputs["tokens"][batch]
        caches = bundle.init_caches(
            cfg, inputs["tokens"].shape[0], rows[1], torch_dtype(cfg.dtype),
            ctx.device, mesh=ctx.mesh, sp=ctx.sp)
        outs = []
        for t in range(tokens.shape[1]):
            logit, caches = bundle.step(params, {"tokens": tokens[:, t:t + 1]},
                                        caches, t, cfg, ctx)
            outs.append(logit)
        return torch.stack(outs, dim=1)

    return [_lm_case(group, spec, run, mode="decode") for spec in cases]


def ar_serve_job(group: Group, spec: dict) -> dict:
    """``ARServer`` on a process mesh, eager: every process builds the
    same weights (``_lm_params``) and server (``slots``, ``max_len``,
    caches in the model's dtype); process 0 submits ``requests`` ((rid,
    prompt tokens, new tokens) each) and serves them, the others follow
    its ticks.  Process 0 returns each request's tokens; every process its
    launch counts, the wall time of the served run, the heap offsets it
    allocated and its slab's high-water mark."""
    from ..comm import kernel_backend as kb
    from ..core import SPConfig
    from ..models import torch_dtype
    from ..serving import ARRequest, ARServer
    from .mesh import make_mesh, process_mesh

    cfg, params = _lm_params(spec, group.device)
    mesh = process_mesh(make_mesh(*spec["mesh"], device=group.device),
                        group.rank, group.size)
    srv = ARServer(params, cfg, SPConfig(**spec["sp"]),
                   batch_slots=spec.get("slots", 4),
                   max_len=spec["max_len"],
                   cache_dtype=torch_dtype(cfg.dtype), capture=False,
                   mesh=mesh)
    heap = kb.process_heap(group.device)
    heap.trace = []
    reset_counts()
    t0 = time.perf_counter()
    got = {}
    if group.rank == 0:
        for rid, prompt, new in spec["requests"]:
            srv.submit(ARRequest(rid=rid, prompt=torch.tensor(prompt),
                                 max_new_tokens=new))
        got = srv.serve()
        srv.stop_followers()
    else:
        srv.follow()
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    offsets, heap.trace = heap.trace, None
    return {"tokens": got, "counts": launch_counts(),
            "seconds": time.perf_counter() - t0, "offsets": offsets,
            "heap_bytes": heap.high_water, "rows": (srv.rows.start,
                                                     srv.rows.stop)}
