"""One-sided communication over the virtual ranks of a mesh (counterpart
of ``src/repro/comm``).

  channel        — ``Channel`` / ``InFlight`` / ``fence`` / ``pin``: a put
                   delivers a rank list into the peers' receive buffers on
                   a side CUDA stream; the wait is an event on the
                   consuming stream.
  stream         — staged transfer programs composed from channels: ring
                   shifts, distance-k torus hops, the decomposed
                   all-to-all and its inverse, the pipeline hand-off.
  kernel_backend — the ``comm_backend="pallas"`` lowering: the put
                   kernels K3 (direct put) and K4 (landing copy) with
                   per-tensor signal words.
  trace          — records the intended schedule and validates its
                   semaphore protocol.

core/{ring,torus,collectives}.py route all their transfers through this
package; this package imports nothing from core.
"""
from .channel import Channel, InFlight, fence, pin, ring_perm_of, shift_perm
from .kernel_backend import BACKENDS
from .stream import (
    Stream,
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
    mark_compute,
    record,
    validate_semaphores,
)

__all__ = [
    "BACKENDS",
    "Channel",
    "InFlight",
    "ScheduleTrace",
    "SemEvent",
    "SemReport",
    "Stream",
    "TransferEvent",
    "fence",
    "mark_compute",
    "pin",
    "pipe_handoff",
    "record",
    "ring_perm_of",
    "ring_shift",
    "shift_perm",
    "staged_all_to_all",
    "staged_ungroup",
    "torus_hop",
    "validate_semaphores",
]
