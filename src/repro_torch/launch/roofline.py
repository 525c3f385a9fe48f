"""Roofline terms of a counted step (the counterpart of the reference's
``launch/roofline.py``).

Three terms per (arch × shape × mesh), all derived without running on the
card:

  compute    = FLOPs (per rank)            / peak FLOP/s
  memory     = bytes accessed (per rank)   / HBM bandwidth
  collective = intra-pod put bytes (per rank) / intra link
             + inter-pod put bytes (per rank) / inter link

The counts come from ``launch/dryrun.py``, which runs the port's step on
the ``meta`` device and counts each operator's FLOPs and bytes and the comm
layer's puts.  The constants are one NVIDIA H100 SXM's, taken from the
port's ``NetworkModel`` so that the comm model and the roofline share one
source: peak = ``flops`` (dense bf16), intra link = ``intra_bw`` (NVLink),
inter link = ``inter_bw`` (InfiniBand); HBM3 at 3.35e12 B/s.  The
reference divides every collective byte by one ICI link; a DGX H100 has
two levels, so intra- and inter-pod bytes each go over their own link.

The reference's ``parse_collectives`` and ``analyze(cost, hlo_text)`` have
no counterpart: they read XLA's optimized HLO text, and eager PyTorch
compiles no program.  The puts are counted where they are issued instead.
"""
from __future__ import annotations

import dataclasses

from ..core.comm_model import NetworkModel

_NET = NetworkModel()
PEAK_FLOPS = _NET.flops  # dense bf16 FLOP/s per H100 SXM
HBM_BW = 3.35e12  # B/s per H100 SXM (HBM3)
INTRA_BW = _NET.intra_bw  # B/s NVLink per device, each way
INTER_BW = _NET.inter_bw  # B/s inter-machine per device


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    collective_inter_pod: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float  # 6·N·D (dense) or 6·N_active·D
    useful_ratio: float  # MODEL_FLOPS / (counted FLOPs × chips)

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze_from_terms(*, flops: float, byts: float, coll_bytes: float,
                       coll_inter: float, chips: int,
                       model_flops: float) -> Roofline:
    """The three terms of one rank's counts (``coll_bytes`` includes the
    ``coll_inter`` bytes that cross the pod boundary)."""
    t_c = flops / PEAK_FLOPS
    t_m = byts / HBM_BW
    t_x = (coll_bytes - coll_inter) / INTRA_BW + coll_inter / INTER_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops * chips
    return Roofline(
        flops_per_device=flops,
        bytes_per_device=byts,
        collective_bytes=coll_bytes,
        collective_inter_pod=coll_inter,
        t_compute=t_c,
        t_memory=t_m,
        t_collective=t_x,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=(model_flops / total_flops) if total_flops else 0.0,
    )
