"""Multi-pod dry-run of the port as FLOP and byte counts (the counterpart of
the reference's ``launch/dryrun.py``).

For an (architecture × input shape × mesh) this builds the port's step —
the train step (AdamW included) for training shapes, the prefill or decode
step for inference shapes — and runs it once on the ``meta`` device over
the production mesh of virtual ranks (launch/mesh.py
``make_production_mesh``): every tensor has its shape and dtype and none
is allocated or computed.  Under a ``TorchDispatchMode`` it counts

  * FLOPs, by ``torch.utils.flop_counter``'s registry (matrix products,
    convolutions, attention calls; elementwise operators count none);
  * bytes accessed: each operator's operands plus its results (a view
    moves nothing and counts nothing; an in-place result is its operand);
  * put bytes, from the comm layer's span records (comm/profiler.py: each
    put's ``nbytes``, what one rank sends), split into intra- and
    inter-pod by whether the put's (src, dst) pairs cross the ``pod`` axis;
  * the live bytes of the storage the step allocates, sampled every
    ``SAMPLE_EVERY`` new storages: its peak is the temp term.

The virtual ranks run in lockstep in one process and the rest of the model
runs once on the whole batch, so the counts are the mesh's; per rank they
are divided by the mesh's rank count (the even split a multi-card run
would give).  On meta every kernel wrapper runs its kernel's plain version
(``kernels/ref.py:PLAIN_DEVICES``), so attention counts as the plain
version computes it: the whole score square, masked.

Where XLA counts a scanned layer once, the reference extrapolates over
depth from compiles at 1 and 2 layers.  The port counts the whole depth
directly when the pair's estimated counting time (from runs at 0 and 1
layers) is within ``DIRECT_S`` seconds; otherwise it uses the two-point
extrapolation from those runs, slope clamped at 0, and the temp term is
null.  The counts are linear in depth, so the points change nothing but
the time: one layer of a training step on the 256 virtual ranks takes
~40 s to count on a CPU core, one of flux_3072's prefill ~150 s.

Memory per rank: ``argument_bytes`` are the parameters and AdamW moments
(every virtual rank reads the one copy, as a rank of a multi-card run
holds its replica: the port shards no weight) plus the batch and caches
divided over the ranks, exactly; ``temp_bytes`` the peak of the step's own
allocations over the ranks; ``code_bytes`` null (eager PyTorch generates
no program).  The JSON keys are the reference's, with ``count_s`` (the
host seconds the counting runs took) for its ``lower_s`` and
``compile_s``, and ``notes`` saying why a term is null.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \
        --shape train_4k --mesh pod --strategy swift_torus
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.report \
        --dir experiments/dryrun_torch

A pair that cannot run on meta prints ``FAIL <tag>: <reason>``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..comm import profiler as comm_profiler
from ..configs import ALL_ARCHS, DIT_ARCHS, ModelConfig, SHAPES, get_config
from ..configs.shapes import DIT_SHAPES, InputShape
from ..core import SPConfig
from ..models import ParallelContext, get_model
from ..train.optimizer import AdamWConfig, init_adamw, tree_leaves
from ..train.trainer import make_train_step
from . import roofline as rl
from .mesh import Mesh, make_production_mesh

LONG_CONTEXT_WINDOW = 4096
ASSIGNED_ARCHS = tuple(a for a in ALL_ARCHS if a not in DIT_ARCHS)
DIRECT_S = 120.0  # count the whole depth when that takes about this long
SAMPLE_EVERY = 64  # new storages between two sweeps of the live tally


def sp_config_for(shape: InputShape, mesh: Mesh, strategy: str,
                  fused_pull_q: bool = False,
                  kv_block: int | None = None) -> SPConfig:
    """Map the assignment's input shapes onto the production mesh axes
    (DESIGN.md §4)."""
    multi_pod = "pod" in mesh.axis_names
    kw = dict(strategy=strategy, torus_fused_pull_q=fused_pull_q,
              attn_kv_block=kv_block)
    if shape.kind == "training":
        ba = ("pod", "data") if multi_pod else ("data",)
        return SPConfig(sp_axes=("model",), batch_axes=ba, **kw)
    if shape.kind == "prefill":
        if shape.global_batch == 1:  # DiT workloads: B=1, seq over data too
            sp = ("pod", "data", "model") if multi_pod else ("data", "model")
            return SPConfig(sp_axes=sp, batch_axes=None, **kw)
        sp = ("pod", "model") if multi_pod else ("model",)
        return SPConfig(sp_axes=sp, batch_axes=("data",), **kw)
    # decode
    if shape.global_batch == 1:  # long_500k: all devices shard the context
        sp = ("pod", "data", "model") if multi_pod else ("data", "model")
        return SPConfig(sp_axes=sp, batch_axes=None, **kw)
    sp = ("pod", "model") if multi_pod else ("model",)
    return SPConfig(sp_axes=sp, batch_axes=("data",), **kw)


def config_for(arch: str, shape: InputShape) -> ModelConfig:
    cfg = get_config(arch)
    if (shape.name == "long_500k" and not cfg.attention_free
            and cfg.window is None):
        # sub-quadratic requirement: sliding-window variant (DESIGN.md §5)
        cfg = dataclasses.replace(cfg, window=LONG_CONTEXT_WINDOW)
    return cfg


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(args, kwargs):
    """The tensors among an operator's arguments (lists one level deep)."""
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (b for b in a if isinstance(b, torch.Tensor))


def _arg_key(a):
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.dtype, a.device.type)
    if isinstance(a, (list, tuple)):
        return tuple(map(_arg_key, a))
    hash(a)  # raises on what cannot key the memo
    return type(a), a  # 1, 1.0 and True are equal keys, not equal arguments


def _fresh(func) -> bool:
    """Whether ``func`` returns only new tensors: no view, no in-place or
    out= result (no return aliases an argument)."""
    rets = func._schema.returns
    return (not func.is_view and bool(rets)
            and all(r.alias_info is None and str(r.type) == "Tensor"
                    for r in rets))


class StepCounter(TorchDispatchMode):
    """FLOPs, bytes accessed and the live-storage peak of every operator
    dispatched under it (the backward's too: autograd carries the mode).

    On ``meta`` an operator's results depend only on its arguments'
    shapes, strides, dtypes and other arguments, and most elementwise
    operators compute them in Python (~0.2 ms each).  So an operator that
    returns only new tensors is memoised by that signature, with its FLOPs
    and bytes: a repeat makes its results with ``torch.empty_strided``
    (the same metadata, a fraction of the host time)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.peak_live = 0
        self._live: dict[int, tuple[StorageWeakRef, int]] = {}
        self._new = 0
        self._fresh: dict = {}
        self._memo: dict = {}

    def _cost(self, func, args, kwargs, out, outs) -> tuple[int, int]:
        """(FLOPs, bytes accessed) of one call: its operands plus the
        results that are not operands."""
        count = flop_registry.get(func._overloadpacket)
        flops = count(*args, **kwargs, out_val=out) if count else 0
        ins = list(_tensors(args, kwargs))
        held = set(map(id, ins))
        byts = sum(map(_nbytes, ins)) + sum(
            _nbytes(t) for t in outs if id(t) not in held)
        return flops, byts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        fresh = self._fresh.get(func)
        if fresh is None:
            fresh = self._fresh[func] = _fresh(func)
        key = None
        if fresh:
            try:
                key = (func, _arg_key(args), _arg_key(tuple(kwargs.items())))
            except TypeError:
                pass
            hit = self._memo.get(key) if key is not None else None
            if hit is not None:
                made, flops, byts = hit
                outs = [torch.empty_strided(size, stride, dtype=dtype,
                                            device="meta")
                        for size, stride, dtype in made]
                self.flops += flops
                self.bytes += byts
                for t in outs:
                    self._track(t)
                return outs[0] if len(outs) == 1 else tuple(outs)
        out = func(*args, **kwargs)
        if func.is_view:
            return out  # aliases its operand: moves and allocates nothing
        outs = ([out] if isinstance(out, torch.Tensor) else
                list(_tensors(out, {})) if isinstance(out, (list, tuple))
                else [])
        flops, byts = self._cost(func, args, kwargs, out, outs)
        self.flops += flops
        self.bytes += byts
        if key is not None and all(t.device.type == "meta" for t in outs):
            self._memo[key] = ([(t.shape, t.stride(), t.dtype) for t in outs],
                               flops, byts)
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st._cdata in self._live:
            return
        self._live[st._cdata] = (StorageWeakRef(st), st.nbytes())
        self._new += 1
        # a sweep costs O(live): space them so that it stays O(1) a storage
        if self._new >= max(SAMPLE_EVERY, len(self._live) // 4):
            self.sweep()

    def sweep(self) -> int:
        """Drop freed storages; returns (and records the peak of) the live
        bytes."""
        self._new = 0
        self._live = {k: v for k, v in self._live.items()
                      if not v[0].expired()}
        live = sum(n for _, n in self._live.values())
        self.peak_live = max(self.peak_live, live)
        return live


def _pod_of(mesh: Mesh, axes: tuple[str, ...]):
    """Flat rank over ``axes`` (slice-major ranks of a sliced layout too)
    -> its pod coordinate, or None when ``axes`` leave out the pod axis."""
    if "pod" not in axes:
        return None
    shape = mesh.shape
    group = math.prod(shape[a] for a in axes)
    inner = math.prod(shape[a] for a in axes[axes.index("pod") + 1:])
    return lambda r: ((r % group) // inner) % shape["pod"]


def put_bytes(events, mesh: Mesh | None) -> tuple[float, float]:
    """(all, inter-pod) bytes that the puts of ``events`` (comm/profiler.py
    observations; the atomic all-to-all of core/collectives.py records its
    issue too) move, summed over the ranks: each leg's per-rank ``nbytes``
    once for every (src, dst) pair with src != dst."""
    total = inter = 0.0
    for ev in events:
        m = ev.meta
        if m.kind != "comm" or ev.phase != "issue":
            continue
        pairs = [(s, d) for s, d in m.perm if s != d]
        # a sliced layout's put covers every slice with one group's perm
        reps = m.ranks / len({s for s, _ in m.perm}) if m.perm else 1.0
        pod = _pod_of(mesh, m.axes) if mesh is not None else None
        total += m.nbytes * len(pairs) * reps
        if pod is not None:
            inter += m.nbytes * reps * sum(pod(s) != pod(d) for s, d in pairs)
    return total, inter


@dataclasses.dataclass
class Counts:
    """One run of a step, summed over the mesh's ranks."""

    flops: float
    bytes: float
    put_bytes: float
    put_inter: float
    peak_live: int
    output_bytes: int
    ops: int
    seconds: float


def _depth_variant(cfg: ModelConfig, n: int) -> ModelConfig:
    kw = {"n_layers": n}
    if cfg.encoder_layers:
        kw["encoder_layers"] = n
    return dataclasses.replace(cfg, **kw)


def build_step(cfg: ModelConfig, shape: InputShape, mesh: Mesh | None,
               sp: SPConfig, remat: str = "full", last_only: bool = False,
               ep_token_gather: bool = False):
    """The port's step for one config: (fn, args, argument bytes), where
    ``fn(*args)`` runs it once; the arguments live on the mesh's device
    (``meta`` without a mesh: one device, SP degree 1) and the argument
    bytes are split into ``{"params", "moments", "batch", "caches"}``."""
    device = mesh.device if mesh is not None else torch.device("meta")
    bundle = get_model(cfg)
    kw = {}
    if cfg.family == "moe":
        kw["ep_degree"] = mesh.shape.get("model", 1) if mesh else 1
    params = bundle.init(cfg, None, device, **kw)
    batch = bundle.input_specs(cfg, shape, abstract=True)
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
             for k, v in batch.items()}
    sizes = {"params": sum(map(_nbytes, tree_leaves(params))),
             "moments": 0, "caches": 0,
             "batch": sum(map(_nbytes, batch.values()))}
    if shape.kind == "training":
        # bf16 Adam moments for arctic-class models (see AdamWConfig)
        big = cfg.params_dense_estimate() > 1e11
        opt_cfg = AdamWConfig(moments_dtype="bfloat16" if big else "float32")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        opt = init_adamw(params, opt_cfg)
        sizes["moments"] = sum(map(_nbytes, tree_leaves((opt.mu, opt.nu))))
        step = make_train_step(cfg, mesh, sp, opt_cfg, remat=remat,
                               device=device)
        return step, (params, opt, batch), sizes
    if shape.kind == "prefill":
        ctx = ParallelContext(sp, "prefill", device, mesh)
        lo = last_only and cfg.family not in ("audio", "dit")

        def prefill_step(params, batch):
            # no_grad, not inference_mode: under inference mode composite
            # operators (matmul, einsum) reach the dispatch mode whole, and
            # the FLOP registry knows only the mm/bmm they decompose into
            with torch.no_grad():
                if lo:
                    return bundle.apply(params, batch, cfg, ctx,
                                        last_only=True)
                return bundle.apply(params, batch, cfg, ctx)

        return prefill_step, (params, batch), sizes
    ctx = ParallelContext(sp, "decode", device, mesh,
                          ep_token_gather=ep_token_gather)
    caches = bundle.init_caches(cfg, shape.global_batch, shape.seq_len,
                                torch.bfloat16, device)
    sizes["caches"] = sum(map(_nbytes, tree_leaves(caches)))

    def serve_step(params, batch, caches, cur_index):
        with torch.no_grad():
            return bundle.step(params, batch, caches, cur_index, cfg, ctx)

    cur = torch.zeros((), dtype=torch.int32, device=device)
    return serve_step, (params, batch, caches, cur), sizes


def count_step(fn, args, mesh: Mesh | None) -> Counts:
    """Run ``fn(*args)`` once under a StepCounter and the span profiler."""
    prof = comm_profiler.CommProfiler()
    t0 = time.perf_counter()
    with comm_profiler.profile(prof), StepCounter() as counter:
        out = fn(*args)
        counter.sweep()
    seconds = time.perf_counter() - t0
    held = {t.untyped_storage()._cdata for t in tree_leaves(args)
            if isinstance(t, torch.Tensor)}
    outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tree_leaves(out) if isinstance(t, torch.Tensor)}
    total, inter = put_bytes(prof.take(), mesh)
    return Counts(flops=float(counter.flops), bytes=float(counter.bytes),
                  put_bytes=total, put_inter=inter,
                  peak_live=counter.peak_live,
                  output_bytes=sum(n for k, n in outs.items()
                                   if k not in held),
                  ops=counter.ops, seconds=seconds)


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """The reference's 6·N·D (training), 2·N·D (prefill) or 2·N·B
    (decode), N the active parameters."""
    n = cfg.params_active_estimate()
    if shape.kind == "training":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * 1 * shape.global_batch


def lower_pair(arch: str, shape_name: str, mesh: Mesh, strategy: str,
               *, fused_pull_q: bool = False, remat: str = "full",
               last_only: bool = False, ep_token_gather: bool = False,
               kv_block: int | None = None, direct_s: float = DIRECT_S,
               cfg: ModelConfig | None = None,
               shape: InputShape | None = None) -> dict:
    """Count one (arch, shape, mesh, strategy).  Returns the result dict.

    The step runs at 0 and 1 layers first (1 and 2 where a model needs a
    layer); if the whole depth would take at most ``direct_s`` seconds by
    their times, it runs at the whole depth and those counts stand, else
    cost(L) = cost(a) + max(0, cost(a + 1) - cost(a))·(L - a): the
    reference's two-point extrapolation, from one layer fewer, since a
    layer of the production mesh takes minutes to count here.  ``cfg`` and ``shape`` override the arch's config and
    the named shape (tests count reduced configs)."""
    shape = shape or {**SHAPES, **DIT_SHAPES}[shape_name]
    cfg = cfg or config_for(arch, shape)
    # the schedule's puts as plain copies (comm_backend "xla", the
    # reference's default): one launch of the put kernels carries at most
    # 96 (rank, tensor) entries and the heap 128 signal words, fewer than
    # the production mesh's 256 ranks; the bytes a put moves are the same
    sp = sp_config_for(shape, mesh, strategy, fused_pull_q, kv_block)
    chips = mesh.size
    opt_kw = dict(remat=remat, last_only=last_only,
                  ep_token_gather=ep_token_gather)

    def run(c: ModelConfig) -> tuple[Counts, dict]:
        fn, args, sizes = build_step(c, shape, mesh, sp, **opt_kw)
        return count_step(fn, args, mesh), sizes

    L = cfg.n_layers
    notes = []
    spent, estimate, lo = 0.0, 0.0, None
    if L > 2:
        try:
            a, c_a = 0, run(_depth_variant(cfg, 0))[0]
        except Exception:  # a model that needs a layer (rwkv6's decode)
            a, c_a = 1, run(_depth_variant(cfg, 1))[0]
        c_b = run(_depth_variant(cfg, a + 1))[0]
        spent = c_a.seconds + c_b.seconds
        estimate = c_a.seconds + max(0.0, c_b.seconds - c_a.seconds) * (L - a)
    if L <= 2 or estimate <= direct_s:
        full, sizes = run(cfg)
        spent += full.seconds
        depth = "direct"
        flops, byts = full.flops, full.bytes
        coll, inter = full.put_bytes, full.put_inter
        temp, out_bytes = full.peak_live / chips, full.output_bytes / chips
    else:
        # slope clamped at 0: never extrapolate downward
        ext = lambda v1, v2: v1 + max(0.0, v2 - v1) * (L - a)
        depth = f"extrapolated from {a} and {a + 1} layers"
        flops, byts = ext(c_a.flops, c_b.flops), ext(c_a.bytes, c_b.bytes)
        coll, inter = (ext(c_a.put_bytes, c_b.put_bytes),
                       ext(c_a.put_inter, c_b.put_inter))
        sizes = build_step(cfg, shape, mesh, sp, **opt_kw)[2]  # not run
        temp = None
        out_bytes = c_b.output_bytes / chips
        notes.append(f"temp_bytes: the step was counted at {a} and {a + 1} "
                     f"layers (the whole depth estimated at {estimate:.0f} "
                     f"s); the live-storage peak needs the whole depth")
    notes.append("code_bytes: eager PyTorch generates no program")
    arg = (sizes["params"] + sizes["moments"]
           + (sizes["batch"] + sizes["caches"]) / chips)
    mflops = model_flops(cfg, shape)
    roof = rl.analyze_from_terms(
        flops=flops / chips, byts=byts / chips, coll_bytes=coll / chips,
        coll_inter=inter / chips, chips=chips, model_flops=mflops)
    return {
        "arch": arch,
        "shape": shape.name,
        "mesh": "multipod" if "pod" in mesh.axis_names else "pod",
        "strategy": strategy,
        "fused_pull_q": fused_pull_q,
        "remat": remat,
        "last_only": last_only,
        "ep_token_gather": ep_token_gather,
        "kv_block": kv_block,
        "chips": chips,
        "step_kind": shape.kind,
        "count_s": round(spent, 2),
        "depth": depth,
        "memory": {
            "argument_bytes": arg,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "code_bytes": None,
            "total_bytes": None if temp is None else arg + temp,
        },
        "cost": {"flops": flops / chips, "bytes accessed": byts / chips},
        "roofline": roof.as_dict(),
        "window_variant": cfg.window,
        "notes": notes,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="pod")
    ap.add_argument("--strategy", default="swift_torus")
    ap.add_argument("--fused-pull-q", action="store_true")
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--last-only", action="store_true")
    ap.add_argument("--ep-token-gather", action="store_true")
    ap.add_argument("--kv-block", type=int, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--dit", action="store_true", help="also run DiT workloads")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    pairs = []
    if args.all:
        for arch in ASSIGNED_ARCHS:
            for shape in SHAPES:
                pairs.append((arch, shape))
        if args.dit:
            for arch in DIT_ARCHS:
                for shape in DIT_SHAPES:
                    pairs.append((arch, shape))
    else:
        if not args.arch or not args.shape:
            ap.error("give --arch and --shape, or --all")
        pairs.append((args.arch, args.shape))

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_fail = 0
    for arch, shape in pairs:
        for mp in meshes:
            mesh = make_production_mesh(multi_pod=mp, device="meta")
            tag = f"{arch}_{shape}_{'multipod' if mp else 'pod'}_{args.strategy}"
            if args.tag:
                tag += f"_{args.tag}"
            try:
                res = lower_pair(arch, shape, mesh, args.strategy,
                                 fused_pull_q=args.fused_pull_q,
                                 remat=args.remat, last_only=args.last_only,
                                 ep_token_gather=args.ep_token_gather,
                                 kv_block=args.kv_block)
                with open(f"{args.out}/{tag}.json", "w") as f:
                    json.dump(res, f, indent=1)
                r, mem = res["roofline"], res["memory"]["total_bytes"]
                mem_s = "—" if mem is None else f"{mem / 2**30:.2f}GiB"
                print(f"OK   {tag}: count={res['count_s']}s "
                      f"({res['depth']}) mem={mem_s} "
                      f"t_comp={r['t_compute']:.2e} t_mem={r['t_memory']:.2e} "
                      f"t_coll={r['t_collective']:.2e} -> {r['bottleneck']}",
                      flush=True)
                n_ok += 1
            except Exception as e:
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
                n_fail += 1
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
