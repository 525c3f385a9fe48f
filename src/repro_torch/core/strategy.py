"""SP strategy dispatch: full | ring | ulysses | usp | swift | swift_torus.

This is the entry point models call for attention.  ``SPConfig`` carries
every field of the reference's, so configurations move between the two
packages unchanged.

On one device (SP degree 1) every strategy computes plain attention; the
port runs it through the hand-written flash_mqkv kernel
(``kernels.ops.flash_attention``), the same kernel the reference's fused
path runs when P_r = 1.  The multi-rank schedules (ring, torus, Ulysses)
are not ported yet: any degree above 1 raises.

Strategies (P = SP degree, N = machines, M = devices per machine):
  full        — no SP; single-device attention.
  ring        — Ring Attention over the whole SP group (P_u = 1).
  ulysses     — Ulysses Attention over the whole SP group (P_r = 1).
  usp         — USP baseline [5]: Ulysses intra-machine, Ring inter.
  swift       — SwiftFusion TAS (§4.2): Ulysses *inter*-machine, Ring
                *intra*; monolithic all-to-alls.
  swift_torus — TAS + Torus Attention (§4.3): chunked all-to-all overlapped
                with compute, one-sided puts.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.ops import flash_attention

STRATEGIES = ("full", "ring", "ulysses", "usp", "swift", "swift_torus")
# wire dtypes the fp8 a2a codec produces (the reference's comm/compress.py)
WIRE_DTYPES = ("float8_e4m3fn", "float8_e5m2")


@dataclasses.dataclass(frozen=True)
class SPConfig:
    """How attention is distributed (fields as in the reference)."""

    strategy: str = "swift_torus"
    sp_axes: tuple[str, ...] = ("model",)  # sequence-parallel mesh axes
    batch_axes: tuple[str, ...] | None = ("data",)  # batch (DP) mesh axes
    machine_axis: str = "pod"  # the slow-boundary axis (paper's N)
    replicate_kv: bool = False  # allow P_u up to gcd(SP, Hq) by replicating KV
    # hybrid-parallel axes: the CFG branch axis and the patch-pipeline
    # stage axis (never touched by attention itself)
    cfg_axis: str | None = None
    pp_axis: str | None = None
    unroll_ring: bool = True
    # beyond-paper: fuse all Pull-Q stage compute into one ring circulation
    torus_fused_pull_q: bool = False
    # beyond-paper: cap the materialized score matrix per attend
    attn_kv_block: int | None = None
    # comm lowering: "xla" = puts scheduled between ops, "pallas" = the
    # fused kernel path that issues its own put (names kept from the
    # reference so configurations carry across)
    comm_backend: str = "xla"
    kernel_interpret: bool = True
    # hierarchical a2a and its fp8 wire compression
    hier_a2a: bool = False
    a2a_wire_dtype: str | None = None

    def __post_init__(self):
        assert self.strategy in STRATEGIES, self.strategy
        assert self.comm_backend in ("xla", "pallas"), self.comm_backend
        if self.a2a_wire_dtype is not None:
            assert self.a2a_wire_dtype in WIRE_DTYPES, self.a2a_wire_dtype


def sp_attention(
    q: torch.Tensor,  # [B, L, Hq, D]
    k: torch.Tensor,  # [B, L, Hkv, D]
    v: torch.Tensor,
    *,
    cfg: SPConfig,
    degree: int = 1,
    scale: float | None = None,
    causal: bool = False,
    window: int | None = None,
) -> torch.Tensor:
    """Attention per the configured SP strategy over ``degree`` ranks.

    Degree 1 (one device, any strategy) runs the flash_mqkv kernel.
    """
    if degree > 1:
        raise NotImplementedError(
            f"SP strategy {cfg.strategy!r} at degree {degree} needs the "
            "multi-rank schedules: ROADMAP Queue 1 items 3 (one-sided comm) "
            "and 4 (SP schedules)")
    return flash_attention(q, k, v, causal=causal, window=window, scale=scale)
