"""One-sided communication over the virtual ranks of a mesh (counterpart
of ``src/repro/comm``).

  channel        — ``Channel`` / ``InFlight`` / ``fence`` / ``pin``: a put
                   delivers a rank list into the peers' receive buffers on
                   a side CUDA stream; the wait is an event on the
                   consuming stream.
  stream         — staged transfer programs composed from channels: ring
                   shifts, distance-k torus hops, the decomposed
                   all-to-all and its inverse, the hierarchical two-level
                   all-to-all and its inverse, the pipeline hand-off.
  compress       — the fp8 wire codec of the hierarchical all-to-all's
                   inter-machine leg.
  kernel_backend — the ``comm_backend="pallas"`` lowering: the put
                   kernels K3 (direct put) and K4 (landing copy) with
                   per-tensor signal words.
  grad           — the gradient of a put: the put of the cotangents
                   along the inverse route, through the same lowering.
  trace          — records the intended schedule and validates its routes,
                   its overlap (on the host order of an eager program) and
                   its semaphore protocol.
  profiler       — the span profiler: timing events at every put's issue,
                   signal and wait and around marked compute blocks,
                   paired into ``comm.*`` spans.

core/{ring,torus,collectives}.py route all their transfers through this
package; this package imports nothing from core.
"""
from .channel import Channel, InFlight, fence, pin, ring_perm_of, shift_perm
from .compress import (
    dequantize,
    ef_encode,
    has_wire_dtype,
    quantize,
    zero_feedback,
)
from .kernel_backend import BACKENDS
from .profiler import CommProfiler, emit_leg_spans, profile
from .stream import (
    Stream,
    hier_all_to_all,
    hier_ungroup,
    inter_hop,
    intra_hop,
    pipe_handoff,
    ring_shift,
    staged_all_to_all,
    staged_ungroup,
    torus_hop,
)
from .trace import (
    ScheduleTrace,
    SemEvent,
    SemReport,
    TransferEvent,
    ValidationReport,
    mark_compute,
    record,
    validate,
    validate_semaphores,
)

__all__ = [
    "BACKENDS",
    "Channel",
    "CommProfiler",
    "InFlight",
    "ScheduleTrace",
    "SemEvent",
    "SemReport",
    "Stream",
    "TransferEvent",
    "ValidationReport",
    "dequantize",
    "ef_encode",
    "emit_leg_spans",
    "fence",
    "has_wire_dtype",
    "hier_all_to_all",
    "hier_ungroup",
    "inter_hop",
    "intra_hop",
    "mark_compute",
    "pin",
    "pipe_handoff",
    "profile",
    "quantize",
    "record",
    "ring_perm_of",
    "ring_shift",
    "shift_perm",
    "staged_all_to_all",
    "staged_ungroup",
    "torus_hop",
    "validate",
    "validate_semaphores",
    "zero_feedback",
]
