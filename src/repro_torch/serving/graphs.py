"""Captured steps: one CUDA graph per (bucket shape, variant), replayed for
every later step of that bucket (the counterpart of the reference's
``jax.jit`` of the DiT step, ``serving/engine.py:_step_fn``, and of the AR
tick, ``ARServer._step``).

An eager step enqueues every op from Python: on the SP path that is ~60
torch ops per (virtual rank, ring circulation), and the host's enqueue,
not the device, sets the step's time.  A ``CapturedStep`` runs its
function eagerly once, captures it into a ``torch.cuda.CUDAGraph`` on the
next call, and from then on copies the inputs into static buffers and
replays the graph.  No ``torch.compile``: it would break the graph at
every ctypes launch and swap the plain elementwise ops for generated
kernels, which is another program; a replay is the eager step's own
kernels, so its results are bitwise the eager step's.

The hazards a captured step meets, and what this module does about each:

  * *Lazy set-up inside the capture.*  The first call is the warm-up: the
    eager step on a side stream, whose result is the call's result.  It
    builds the ctypes libraries, sets the kernels' shared-memory
    attributes (once per process, ``csrc/*.cu``), makes the symmetric
    heap, cuBLAS's handles and the device constants (rope frequencies,
    timestep table, guidance weights), so none of that happens while
    capturing.
  * *Addresses are frozen.*  Kernels take raw pointers and host-built
    tensor maps, so the graph binds addresses: inputs go through static
    buffers, made when the step is captured, and every call copies its
    inputs into them (a tensor that already is the static buffer is not
    copied).  Outputs are the graph's own tensors and hold until the next
    replay of any graph of the same memory pool: a caller keeps what it
    needs by copying it.
  * *One pool.*  All graphs of one server share one memory pool, because
    they replay one after another, never concurrently.
  * *Frozen epochs.*  K2–K4 take an epoch that the host picks per launch;
    a graph freezes it.  Every captured step starts with a memset node
    that zeroes the heap's signal words, so after a replay each word the
    step's puts write holds its epoch because this replay wrote it
    (``signal_words`` lists them; ordering itself comes from stream
    events, so nothing spins on a word).
  * *Side-stream puts.*  A put forks onto the heap's side stream and its
    wait joins it back; both are captured, and every put is waited, so
    every branch is joined before the capture ends.  While capturing, a
    put's tensors are held by its handle until its wait instead of
    ``record_stream`` (which would bar their memory from reuse for the
    rest of the capture).
  * *Launch counters count Python calls.*  A capture launches nothing, so
    the counts it added are taken back, kept as the step's launches per
    replay, and added at every replay.
  * *Garbage collection.*  A collection during a capture that frees an
    unreachable server destroys its graphs, which a capture forbids:
    garbage is collected before a capture and collection is off during
    it.
  * *Profiling.*  A profiled step's timing events are captured as
    external event-record nodes; after each replay the profiler reads
    them (one synchronisation) and files them as that replay's
    observations.
  * *Schedule bookkeeping* (comm/trace.py) is recorded at capture time,
    once per graph, as the reference records it once per trace; the
    warm-up does not record.

On the CPU, which only the tests ask for, a ``CapturedStep`` calls the
eager step every time.  ``capture=False`` does the same on the card (the
oracle of the capture checks).  There is no fallback: a capture or a
replay that fails raises.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import time
from typing import Any, Callable

import torch

from ..comm import kernel_backend as _kb
from ..comm import profiler as _profiler
from ..comm import trace as _trace

__all__ = ["CapturedStep", "add_launch_counts", "launch_counts",
           "resolve_capture"]


def _kernel_modules():
    from ..kernels import flash_mqkv, ring_flash

    return (("flash_mqkv", flash_mqkv), ("ring_flash_step", ring_flash),
            ("rwkv6_wkv",
             importlib.import_module("repro_torch.kernels.rwkv6_wkv")))


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch counter, by kernel name."""
    counts = {name: mod._launches for name, mod in _kernel_modules()}
    counts.update(_kb._launches)
    return counts


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` to the wrappers' launch counters."""
    for name, mod in _kernel_modules():
        mod._launches += delta.get(name, 0)
    for name in _kb._launches:
        _kb._launches[name] += delta.get(name, 0)


def resolve_capture(capture: bool | None, device: torch.device) -> bool:
    """None means capture on CUDA; capturing needs CUDA."""
    if capture is None:
        return device.type == "cuda"
    if capture and device.type != "cuda":
        raise ValueError(f"capture needs a CUDA device, not {device}")
    return bool(capture)


def _flatten(tree: Any, out: list) -> Any:
    """Leaves of nested tuples, lists and dicts into ``out``; returns the
    structure with leaf slots as their indices."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_flatten(x, out) for x in tree)
    if isinstance(tree, dict):
        return {k: _flatten(v, out) for k, v in tree.items()}
    out.append(tree)
    return len(out) - 1


def _signature(args: Any) -> tuple:
    """The structure, shapes and dtypes of ``args`` (and the types of its
    scalars): a graph replays only inputs of its capture's signature."""
    leaves: list = []
    spec = _flatten(args, leaves)
    return (repr(spec), tuple(
        (tuple(a.shape), a.dtype, a.device) if isinstance(a, torch.Tensor)
        else type(a) for a in leaves))


def _unflatten(spec: Any, leaves: list) -> Any:
    if isinstance(spec, (tuple, list)):
        return type(spec)(_unflatten(x, leaves) for x in spec)
    if isinstance(spec, dict):
        return {k: _unflatten(v, leaves) for k, v in spec.items()}
    return leaves[spec]


class _CudaGraph:
    """The capture and replay of one step on the card."""

    def __init__(self, pool):
        self.pool = pool
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)

    def capture(self, fn: Callable[[], Any]) -> tuple[Any, float, float]:
        """(outputs, capture seconds, instantiation seconds).

        No garbage collection while capturing: a collection that frees an
        unreachable server (servers are reference cycles) destroys its
        graphs, which a capture forbids, and the capture fails.  The
        garbage is collected just before instead, outside the timing."""
        gc.collect()
        t0 = time.perf_counter()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=self.pool):
                out = fn()
        finally:
            if enabled:
                gc.enable()
        t1 = time.perf_counter()
        self.graph.instantiate()
        return out, t1 - t0, time.perf_counter() - t1

    def replay(self) -> None:
        self.graph.replay()


class CapturedStep:
    """``fn`` eagerly on its first call (the warm-up), captured on its
    second, replayed from then on; the eager ``fn`` on every call when
    ``capture`` is off (the CPU's only mode).  A call whose inputs differ
    in shape or dtype from the last call's is one more warm-up: the step
    is captured on the first call that repeats its predecessor's input
    signature (as a jitted function is traced anew for a new one).

    ``fn`` takes tensors, Python floats and ints, and tuples, lists and
    dicts of them; a replay takes arguments of the same structure, shapes
    and dtypes (floats and ints become 0-d float32 and int64 buffers).
    ``pool`` is the memory pool shared by the graphs of one owner;
    ``on_capture`` gives a context manager that brackets the capture
    (the plan cache's span and counter).  ``graph`` makes the graph
    object (tests pass a fake)."""

    def __init__(self, fn: Callable[..., Any], device: torch.device | str, *,
                 capture: bool | None = None, pool=None,
                 on_capture: Callable[[], Any] | None = None,
                 name: str = "step",
                 graph: Callable[[Any], Any] = _CudaGraph):
        self.fn = fn
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # a fake graph (a test's) captures on any device
        self.capture = (resolve_capture(capture, self.device)
                        if graph is _CudaGraph else bool(capture))
        self.pool = pool
        self.on_capture = on_capture
        self.name = name
        self._make_graph = graph
        self.calls = 0
        self.replays = 0
        self.graph = None
        self._spec = None
        # the last call's input signature, until the step is captured
        self._seen = None
        self._static: list = []
        self._out = None
        # kernel launches of one replay, by kernel name
        self.launches: dict[str, int] = {}
        # host seconds of the capture and of the graph's instantiation
        self.capture_s: float | None = None
        self.instantiate_s: float | None = None
        # (signal row, word) -> the epoch the step's puts leave there
        self.signal_words: dict[tuple[int, int], int] = {}
        self._prof_events: list = []
        self._warm_stream = None

    def __call__(self, *args):
        self.calls += 1
        if not self.capture:
            return self.fn(*args)
        with torch.inference_mode():
            if self.graph is None:
                sig = _signature(args)
                if sig != self._seen:
                    # first call, or inputs of another shape or dtype than
                    # the last call's (the AR caches settle their dtype in
                    # the first ticks): the eager warm-up of this signature
                    self._seen = sig
                    return self._warm_up(args)
                self._capture(args)
            self._copy_in(args)
            self._replay()
            return self._out

    # -- the three phases -------------------------------------------------
    def _warm_up(self, args):
        """The eager step on a side stream: lazy set-up happens here."""
        if self.device.type != "cuda":  # a fake graph's test
            with _trace.paused():
                return self.fn(*args)
        cur = torch.cuda.current_stream(self.device)
        if self._warm_stream is None:
            self._warm_stream = torch.cuda.Stream(self.device)
        s = self._warm_stream
        s.wait_stream(cur)
        with torch.cuda.stream(s), _trace.paused():
            out = self.fn(*args)
        cur.wait_stream(s)
        return out

    def _capture(self, args) -> None:
        leaves: list = []
        self._spec = _flatten(args, leaves)
        self._static = [self._static_of(a) for a in leaves]
        static_args = _unflatten(self._spec, self._static)
        heap = _kb.existing_heap(self.device)
        before = launch_counts()
        prof = _profiler.active()
        saved = None
        if prof is not None:
            saved, prof.events = prof.events, []
        words: list = []
        if heap is not None:
            heap.log = words
        graph = self._make_graph(self.pool)

        def body():
            # fresh signal words every replay: see the module's docstring
            _kb.reset_signals(self.device)
            return self.fn(*static_args)

        try:
            span = (self.on_capture() if self.on_capture is not None
                    else contextlib.nullcontext())
            with span:
                out, self.capture_s, self.instantiate_s = graph.capture(body)
        finally:
            if heap is not None:
                heap.log = None
            if prof is not None:
                self._prof_events, prof.events = prof.events, saved
            after = launch_counts()
            self.launches = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
            # the capture launched nothing on the device
            add_launch_counts({k: -v for k, v in self.launches.items()})
        for row, start, n, epoch in words:
            for w in range(start, start + n):
                self.signal_words[(row, w)] = epoch
        self._out = out
        self.graph = graph

    def _static_of(self, a):
        if isinstance(a, torch.Tensor):
            if a.device != self.device:
                raise ValueError(f"{self.name}: input on {a.device}, step on "
                                 f"{self.device}")
            return a.clone()
        if isinstance(a, bool) or not isinstance(a, (float, int)):
            raise TypeError(f"{self.name}: cannot capture an input of type "
                            f"{type(a).__name__}")
        dtype = torch.float32 if isinstance(a, float) else torch.int64
        return torch.full((), a, dtype=dtype, device=self.device)

    def _copy_in(self, args) -> None:
        leaves: list = []
        spec = _flatten(args, leaves)
        if spec != self._spec:
            raise ValueError(f"{self.name}: arguments of another structure "
                             "than the captured step's")
        for i, (buf, a) in enumerate(zip(self._static, leaves)):
            if isinstance(a, torch.Tensor):
                if a is buf:
                    continue
                if a.shape != buf.shape or a.dtype != buf.dtype:
                    raise ValueError(
                        f"{self.name}: input {i} is {a.dtype}"
                        f"{tuple(a.shape)}, captured as {buf.dtype}"
                        f"{tuple(buf.shape)}")
                buf.copy_(a)
            else:
                buf.fill_(a)

    def _replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        add_launch_counts(self.launches)
        prof = _profiler.active()
        if prof is not None and self._prof_events:
            prof.replayed(self._prof_events)
