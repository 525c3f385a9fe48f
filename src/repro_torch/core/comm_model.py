"""Analytical communication-volume and latency model (paper Appendix D).

Reproduces the paper's inter-machine communication volume formulas for USP
and SwiftFusion, plus a simple two-level (intra/inter) alpha-beta latency
model used by the benchmark harness to regenerate the shape of the paper's
Figures 7/8/10 without multi-machine hardware.

All volumes are **elements per GPU** (multiply by bytes/elem for bytes), in
terms of B (batch), L (global sequence), H (heads), D (head dim), N
(machines), M (devices per machine), P_u, P_r (Ulysses/Ring degrees).

``plan_step_latency`` is the unified scoring entry point the request
scheduler's plan cache and admission policy consume (DESIGN.md §9);
``load_network_model`` loads the parameters ``scripts/calibrate_comm.py``
fits from recorded ``BENCH_*.json`` step measurements, replacing the
testbed-equivalent defaults with calibrated ones.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

from .planner import HybridPlan, SPPlan


def usp_inter_volume(plan: SPPlan, blhd: float) -> float:
    """Appendix D eq. (4)-(5): USP inter-machine elements per GPU."""
    n, p_r, p_u = plan.n_machines, plan.p_ring, plan.p_ulysses
    if n == 1:
        return 0.0
    if p_r >= n:
        # Ring spans machines; each of the N-1 inter-machine hops moves KV.
        return 2.0 * (n - 1) * blhd / n
    # Ring smaller than machine count: Ulysses also crosses machines with
    # degree N / P_r.
    g = n / p_r
    return (2.0 * (p_r - 1) * (n / p_r) + 4.0 * (g - 1) / g) * blhd / n


def swift_inter_volume(plan: SPPlan, blhd: float) -> float:
    """Appendix D eq. (6)-(7): SwiftFusion inter-machine elements per GPU."""
    n, p_u = plan.n_machines, plan.p_ulysses
    if n == 1:
        return 0.0
    if p_u >= n:
        return 4.0 * (n - 1) / n * blhd / n
    # Ulysses smaller than machine count: Ring also crosses machines with
    # degree N / P_u.
    g = n / p_u
    return (2.0 * (g - 1) + 4.0 * (p_u - 1) / p_u * g) * blhd / n


def hierarchical_applicable(plan: SPPlan) -> bool:
    """Whether the hierarchical two-level a2a (DESIGN.md §8.2) applies to
    this plan: the Ulysses groups must span machines (ulysses-outer
    placement, N > 1) with more than one member per machine (P_u > N) and
    an exact machine factorisation (N | P_u) so u-blocks are machine-
    contiguous.  Degenerate cases fall back to the flat path."""
    n, p_u = plan.n_machines, plan.p_ulysses
    return plan.ulysses_inter and n > 1 and p_u > n and p_u % n == 0


def a2a_leg_volumes(plan: SPPlan, blhd: float, *, swift: bool,
                    hierarchical: bool = False) -> dict[str, float]:
    """Per-leg element volumes of the four Ulysses all-to-alls (Q, K, V,
    O), split by the boundary each leg crosses — the decomposition that
    replaces the old single-blob a2a term.

    Derivation (per-machine NIC convention of Appendix D, cross-checked
    against eq. 4/6 in tests/test_comm_model.py): each device holds
    BLHD/(N·M) elements per tensor, so a machine's share per tensor is
    BLHD/N.  The a2a moves chunk j of P_u to ulysses-peer j; with
    m_u = P_u/N group members per machine (swift, P_u >= N):

      flat a2a:     (P_u - m_u)/P_u of every chunk crosses machines
                    -> inter = 4·(P_u - m_u)/P_u · BLHD/N (== eq. 6),
                    (m_u - 1)/P_u stays on NVLink
                    -> intra = 4·(m_u - 1)/P_u · BLHD/N.
      hierarchical: the intra leg exchanges FULL dest-machine bundles
                    (every chunk traverses NVLink once)
                    -> intra = 4·(m_u - 1)/m_u · BLHD/N,
                    the inter leg moves exactly the same remote chunks
                    as flat (aggregated m_u per message)
                    -> inter = 4·(P_u - m_u)/P_u · BLHD/N (unchanged).

    The hierarchical win is therefore NOT in volume (it pays ~m_u× more
    NVLink traffic) but in inter-message count — g - 1 paced hops instead
    of P_u - 1 — which is a latency term, priced per-leg in
    ``attention_layer_latency``.
    """
    n, m = plan.n_machines, plan.m_per_machine
    p_u, p_r = plan.p_ulysses, plan.p_ring
    if p_u == 1:
        return {"a2a_intra": 0.0, "a2a_inter": 0.0}
    if not swift:
        # USP: Ulysses stays inside the machine (eq. 5's a2a term covers
        # the P_r < N spill-over case where Ulysses crosses too).
        u_intra = min(p_u, m)
        intra = 4.0 * (u_intra - 1) / u_intra * blhd / n if m > 1 else 0.0
        inter = 0.0
        if n > 1 and p_r < n:
            g = n / p_r
            inter = 4.0 * (g - 1) / g * blhd / n
        return {"a2a_intra": intra, "a2a_inter": inter}
    if n == 1:
        return {"a2a_intra": 4.0 * (p_u - 1) / p_u * blhd,
                "a2a_inter": 0.0}
    if p_u < n:
        # eq. 7 regime: one group member per machine cluster — the a2a is
        # purely inter with degree g = N/P_u; hierarchy cannot apply.
        g = n / p_u
        return {"a2a_intra": 0.0,
                "a2a_inter": 4.0 * (p_u - 1) / p_u * g * blhd / n}
    # group members per machine; kept continuous so the inter share
    # reduces to eq. 6's 4*(N-1)/N*BLHD/N even when N does not divide P_u
    # (eq. 6's even-distribution idealisation — the hierarchical branch,
    # which needs exact machine blocks, is gated on divisibility anyway)
    m_u = p_u / n
    inter = 4.0 * (p_u - m_u) / p_u * blhd / n
    if hierarchical and hierarchical_applicable(plan):
        intra = 4.0 * (m_u - 1) / m_u * blhd / n
    else:
        intra = 4.0 * (m_u - 1) / p_u * blhd / n
    return {"a2a_intra": intra, "a2a_inter": inter}


def ring_leg_volumes(plan: SPPlan, blhd: float, *, swift: bool
                     ) -> dict[str, float]:
    """Per-leg element volumes of the Ring circulation (K and V), split by
    boundary.  Total receive volume per machine is 2·(P_r - 1)·BLHD/N
    (each of M devices receives P_r - 1 KV chunks of BLHD/(N·M) each, K
    and V both); the inter share is the paper's eq. 4/6/7 ring term and
    the intra share is the complement, floored at zero for the P_r < N
    regime where re-entry makes the inter term exceed the single-pass
    total."""
    n = plan.n_machines
    p_u, p_r = plan.p_ulysses, plan.p_ring
    if p_r == 1:
        return {"ring_intra": 0.0, "ring_inter": 0.0}
    total = 2.0 * (p_r - 1) * blhd / n
    if n == 1:
        return {"ring_intra": total, "ring_inter": 0.0}
    if swift:
        # ring crosses machines only when Ulysses is too small to cover
        # them (eq. 7's first term, g = N / P_u machine clusters)
        inter = 2.0 * (n / p_u - 1) * blhd / n if p_u < n else 0.0
    else:
        if p_r >= n:
            inter = 2.0 * (n - 1) * blhd / n  # eq. 4
        else:
            inter = 2.0 * (p_r - 1) * (n / p_r) * blhd / n  # eq. 5 term
    return {"ring_intra": max(total - inter, 0.0), "ring_inter": inter}


def intra_volume(plan: SPPlan, blhd: float, *, swift: bool,
                 hierarchical: bool = False) -> float:
    """Intra-machine elements per GPU (not in the paper's appendix; derived
    the same way): the a2a's intra-machine share plus the Ring's.

    Bug history: this used to be ``2·(min(P_r, M) - 1)·BLHD/N`` for swift
    — via a self-cancelling ``/ max(r_intra, 1) * r_intra`` factor — which
    is correct for P_r <= M (ring entirely inside the machine) but
    undercounts the P_r > M regime: there the ring spans g_r = P_r·N/SP
    machine segments and the intra share is the eq.-7 complement
    2·(P_r - g_r)·BLHD/N, not 2·(M - 1)·BLHD/N.  Both regimes (and the
    flat-a2a intra share this blob used to drop entirely) now come from
    the per-leg decomposition; tests/test_comm_model.py pins the
    derivation against the eq. 4/6 limits at P_r = M and N = 1.
    """
    if plan.m_per_machine == 1:
        return 0.0
    legs = a2a_leg_volumes(plan, blhd, swift=swift,
                           hierarchical=hierarchical)
    rlegs = ring_leg_volumes(plan, blhd, swift=swift)
    return legs["a2a_intra"] + rlegs["ring_intra"]


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Two-level network + compute model for latency estimates.

    Defaults are NVIDIA H100 SXM data-sheet terms: intra = NVLink 4 at
    450 GB/s each way (900 GB/s both ways), inter = one
    400 Gb/s NDR InfiniBand port per GPU (DGX H100), compute = the dense
    bf16 tensor-core peak.  The latencies, ``mfu`` and the per-leg terms
    below are modelling assumptions, not measurements; the calibration
    fitter (core/calibration.py) replaces them from measured steps.
    """

    intra_bw: float = 4.5e11  # B/s NVLink per device, each way
    inter_bw: float = 5.0e10  # B/s inter-machine per device (400 Gb/s IB)
    intra_lat: float = 1e-6  # s per hop
    inter_lat: float = 1e-5  # s per hop
    flops: float = 989e12  # peak dense bf16 FLOP/s per H100 SXM
    mfu: float = 0.5  # assumed attention kernel efficiency
    bytes_per_elem: int = 2
    # Per-transfer-step issue gap when comm is scheduled BETWEEN ops (the
    # "xla" channel backend): each ring step / a2a stage pays one
    # dispatch+schedule window before its DMA can start.  The fused
    # kernel path ("pallas", DESIGN.md §8.1) issues the put from inside
    # the attention kernel and pays none of it.
    step_issue_overhead: float = 2e-6  # s per inter-op transfer step
    # Per-leg a2a terms (DESIGN.md §8.2).  The staged a2a's intra-machine
    # leg rides NVLink but with a different message shape than the ring
    # (full dest-machine bundles vs one KV chunk), so its achieved
    # bandwidth calibrates separately from intra_bw; inter_hop_lat is the
    # per-MESSAGE cost of an inter-machine a2a stage (NIC processing +
    # wire latency that does not pipeline across messages) — this is the
    # term the hierarchical path shrinks from P_u - 1 to N - 1 messages;
    # codec_bw is the on-device quantise+dequantise throughput of the
    # fp8 wire codec (comm/compress.py).
    a2a_intra_bw: float = 4.5e11  # B/s intra-machine a2a leg per device
    inter_hop_lat: float = 1e-5  # s per inter-machine a2a message
    codec_bw: float = 1.675e12  # B/s fp8 codec: 3.35 TB/s HBM, read + write


@dataclasses.dataclass(frozen=True)
class LayerWorkload:
    batch: int
    seq: int  # global sequence length
    heads: int
    head_dim: int

    @property
    def blhd(self) -> float:
        return float(self.batch * self.seq * self.heads * self.head_dim)

    def attention_flops(self) -> float:
        # 2 matmuls (QK^T and PV), 2*L*L*D each per head, bidirectional DiT.
        return 4.0 * self.batch * self.heads * self.seq * self.seq * self.head_dim


def attention_layer_latency(
    plan: SPPlan,
    wl: LayerWorkload,
    net: NetworkModel = NetworkModel(),
    *,
    swift: bool,
    overlap_inter: bool = False,
    overlap_intra: bool = True,
    one_sided: bool = False,
    fused_comm: bool = False,
    hierarchical: bool = False,
    wire_dtype: str | None = None,
) -> dict[str, float]:
    """Estimate one distributed attention layer's latency components.

    ``overlap_inter`` models Torus Attention: the inter-machine all-to-all
    is hidden behind compute up to the compute time.  Ring's intra-machine
    transfers are overlappable by construction (``overlap_intra``).

    ``one_sided`` models §4.4: two-sided libraries pay a sender/receiver
    rendezvous *per transfer step* (P_r - 1 ring steps + the a2a stages,
    Fig. 4); the one-sided design pays exactly two barriers per layer
    (Algorithm 1 lines 16/36), independent of step count.

    ``fused_comm`` models the Pallas channel backend (DESIGN.md §8.1):
    when the attention kernel issues its own puts, the per-step inter-op
    issue gap (``net.step_issue_overhead`` per ring step / a2a stage)
    disappears — the kernel-fused analogue of the paper's in-kernel
    NVSHMEM puts.

    ``hierarchical`` scores the two-level a2a (DESIGN.md §8.2) when
    :func:`hierarchical_applicable` holds for the plan (no-op otherwise);
    ``wire_dtype`` prices fp8 compression of the inter-machine a2a leg
    (halved wire bytes, plus a codec term).  The returned dict carries
    every leg separately — ``t_a2a_intra``/``t_a2a_inter``/
    ``t_ring_intra``/``t_ring_inter``/``t_codec`` — with the legacy
    ``t_inter``/``t_intra`` as their sums, so no single-blob a2a term
    remains in the scoring.
    """
    hier = hierarchical and hierarchical_applicable(plan)
    a2a = a2a_leg_volumes(plan, wl.blhd, swift=swift, hierarchical=hier)
    ring = ring_leg_volumes(plan, wl.blhd, swift=swift)
    b = net.bytes_per_elem
    compressed = wire_dtype is not None and a2a["a2a_inter"] > 0.0
    wire_b = 1 if compressed else b  # fp8 wire formats are 1 byte/elem

    # a2a message counts per layer: the flat staged path paces P_u - 1
    # messages on the Ulysses boundary; the hierarchical path splits them
    # into m_u - 1 fast-leg + N - 1 slow-leg messages.
    p_u, n = plan.p_ulysses, plan.n_machines
    if hier:
        a2a_inter_msgs = n - 1
        a2a_intra_msgs = p_u // n - 1
    elif plan.ulysses_inter and n > 1:
        a2a_inter_msgs = max(p_u - 1, 0)
        a2a_intra_msgs = 0
    else:
        a2a_inter_msgs = 0
        a2a_intra_msgs = max(p_u - 1, 0)

    t_a2a_inter = (a2a["a2a_inter"] * wire_b / net.inter_bw
                   + a2a_inter_msgs * net.inter_hop_lat)
    t_a2a_intra = (a2a["a2a_intra"] * b / net.a2a_intra_bw
                   + a2a_intra_msgs * net.intra_lat)
    t_ring_inter = ring["ring_inter"] * b / net.inter_bw
    t_ring_intra = ring["ring_intra"] * b / net.intra_bw
    # encode on the sender + decode on the receiver, priced against the
    # uncompressed payload (the codec reads/writes the full-width tensor)
    t_codec = (2.0 * a2a["a2a_inter"] * b / net.codec_bw) if compressed else 0.0

    inter_v = a2a["a2a_inter"] + ring["ring_inter"]
    intra_v = a2a["a2a_intra"] + ring["ring_intra"]
    t_inter = (t_a2a_inter + t_ring_inter
               + (plan.n_machines > 1) * net.inter_lat)
    t_intra = (t_a2a_intra + t_ring_intra
               + (plan.m_per_machine > 1) * net.intra_lat)
    t_comp = wl.attention_flops() / plan.sp_degree / (net.flops * net.mfu)
    ring_steps = max(plan.p_ring - 1, 0)
    a2a_stages = a2a_inter_msgs + a2a_intra_msgs
    if one_sided:
        t_sync = 2 * (net.inter_lat if plan.n_machines > 1 else net.intra_lat)
    else:
        inter_steps = (a2a_inter_msgs
                       + ring_steps * (not plan.ulysses_inter))
        intra_steps = (a2a_intra_msgs
                       + ring_steps * plan.ulysses_inter)
        t_sync = (inter_steps * net.inter_lat * (plan.n_machines > 1)
                  + intra_steps * net.intra_lat * (plan.m_per_machine > 1))
    t_issue = (0.0 if fused_comm
               else (ring_steps + a2a_stages) * net.step_issue_overhead)
    exposed_intra = 0.0 if overlap_intra else t_intra
    exposed_inter = max(0.0, t_inter - t_comp) if overlap_inter else t_inter
    total = t_comp + exposed_inter + exposed_intra + t_sync + t_issue + t_codec
    hideable = t_inter + t_intra
    return {
        "t_compute": t_comp,
        "t_inter": t_inter,
        "t_intra": t_intra,
        "t_a2a_inter": t_a2a_inter,
        "t_a2a_intra": t_a2a_intra,
        "t_ring_inter": t_ring_inter,
        "t_ring_intra": t_ring_intra,
        "t_codec": t_codec,
        "t_sync": t_sync,
        "t_issue": t_issue,
        "t_total": total,
        "t_exposed_inter": exposed_inter,
        "t_exposed_intra": exposed_intra,
        # fraction of the layer's comm hidden behind compute (1.0 = fully
        # overlapped / nothing to hide) — the modelled counterpart of the
        # measured per-leg overlap efficiency (DESIGN.md §12)
        "overlap_efficiency": (1.0 - (exposed_inter + exposed_intra)
                               / hideable) if hideable > 0 else 1.0,
        "inter_elems": inter_v,
        "intra_elems": intra_v,
        "hierarchical": float(hier),
    }


# ---------------------------------------------------------------------------
# hybrid parallelism (DESIGN.md §7): CFG + patch pipeline composed with SP
# ---------------------------------------------------------------------------

LATENT_CHANNELS = 64  # mirrors models/dit.py (velocity tensor channel dim)


def cfg_recombine_volume(wl: LayerWorkload) -> float:
    """Elements each device exchanges for the CFG recombine, per sampler
    step: one velocity tensor (B·L·C with B the per-branch batch) — the
    weighted psum over k branches is a reduction, so the per-device volume
    is independent of the guidance degree.  This is the ONLY cross-branch
    traffic of cfg parallelism — it is per *step*, not per layer, which is
    why the planner spends the slow boundary on it first."""
    return float(wl.batch * wl.seq * LATENT_CHANNELS)


def pipefusion_boundary_volume(wl: LayerWorkload, pp: int) -> float:
    """Elements each pipeline stage hands to its successor per sampler
    step: every patch's activations cross each stage boundary once, so the
    per-device total is B·L·hidden (hidden ≈ H·D) per step — independent
    of both layer count and patch count.  Compare with SP, which moves
    O(B·L·H·D) *per layer*."""
    if pp <= 1:
        return 0.0
    return float(wl.batch * wl.seq * wl.heads * wl.head_dim)


# step-level dict keys carrying each comm leg (DESIGN.md §8.2): the
# scheduler and the bench records see the same decomposition the layer
# model scores with — no single-blob a2a term anywhere downstream either
PER_LEG_KEYS = ("t_a2a_inter", "t_a2a_intra", "t_ring_inter",
                "t_ring_intra", "t_codec")


def _per_leg_step(lat: dict[str, float], mult: float) -> dict[str, float]:
    out = {f"{k}_step": mult * lat[k] for k in PER_LEG_KEYS}
    out["hierarchical"] = lat["hierarchical"]
    return out


def sp_step_latency(
    plan: SPPlan,
    wl: LayerWorkload,
    net: NetworkModel = NetworkModel(),
    *,
    n_layers: int,
    guided: bool = True,
    guidance_branches: int = 2,
    swift: bool = True,
    comm_backend: str = "xla",
    hierarchical: bool = False,
    wire_dtype: str | None = None,
) -> dict[str, float]:
    """Predicted per-sampler-step latency of pure SP serving: ``n_layers``
    distributed attention layers (Torus overlap + one-sided sync), times
    the k guidance branches when classifier-free guidance runs them
    sequentially."""
    lat = attention_layer_latency(
        plan, wl, net, swift=swift, overlap_inter=True, one_sided=True,
        fused_comm=comm_backend == "pallas",
        hierarchical=hierarchical, wire_dtype=wire_dtype)
    branches = guidance_branches if guided else 1
    mult = branches * n_layers
    return {
        "t_step": mult * lat["t_total"],
        "t_layer": lat["t_total"],
        "t_compute_step": mult * lat["t_compute"],
        "t_issue_step": mult * lat["t_issue"],
        "overlap_efficiency": lat["overlap_efficiency"],
        "branches": float(branches),
        "inter_elems_step": mult * lat["inter_elems"],
        **_per_leg_step(lat, mult),
    }


def hybrid_step_latency(
    hplan: HybridPlan,
    wl: LayerWorkload,
    net: NetworkModel = NetworkModel(),
    *,
    n_layers: int,
    guided: bool = True,
    guidance_branches: int = 2,
    num_patches: int | None = None,
    num_steps: int = 20,
    overlap_pp: bool = True,
    comm_backend: str = "xla",
    hierarchical: bool = False,
    wire_dtype: str | None = None,
) -> dict[str, float]:
    """Predicted per-sampler-step latency of the (cfg, pp, P_u, P_r) plan.

    Model: each pipeline stage runs n_layers/pp SP-distributed attention
    layers over the full sequence's worth of patches (patch attention is
    Q_patch × KV_full, so per-stage flops equal n_layers/pp full layers);
    cfg = 2 removes the sequential-guidance doubling at the cost of one
    velocity-sized recombine per step; stage hand-offs stream one patch at
    a time and overlap with compute (the NVSHMEM-style async schedule —
    ``overlap_pp=False`` models a blocking hand-off).  The pipeline fill
    bubble is amortised across the sampler's ``num_steps`` (PipeFusion
    pipelines across diffusion steps).

    The SP sub-plan keeps the paper's TAS/Torus placement on the residual
    sub-mesh; when that sub-mesh has one machine the swift/USP distinction
    is moot for inter traffic and the Ulysses a2a is accounted as
    intra-machine (swift=False branch of ``intra_volume``).
    """
    np_ = num_patches or max(hplan.pp, 1)
    sub = hplan.sp
    lat = attention_layer_latency(
        sub, wl, net, swift=sub.n_machines > 1,
        overlap_inter=True, one_sided=True,
        fused_comm=comm_backend == "pallas",
        hierarchical=hierarchical, wire_dtype=wire_dtype)
    branches = guidance_branches if (guided and hplan.cfg == 1) else 1
    t_layers = branches * (n_layers / hplan.pp) * lat["t_total"]

    b = net.bytes_per_elem
    pp_bw = net.inter_bw if hplan.pp_inter else net.intra_bw
    t_pp = pipefusion_boundary_volume(wl, hplan.pp) * b / pp_bw
    exposed_pp = max(0.0, t_pp - t_layers) if overlap_pp else t_pp
    cfg_bw = net.inter_bw if hplan.cfg_inter else net.intra_bw
    t_cfg = 0.0
    if guided and hplan.cfg >= 2:
        t_cfg = (cfg_recombine_volume(wl) * b / cfg_bw
                 + (net.inter_lat if hplan.cfg_inter else net.intra_lat))
    t_bubble = t_layers * (hplan.pp - 1) / (np_ * num_steps)
    total = t_layers + exposed_pp + t_cfg + t_bubble
    layer_mult = branches * (n_layers / hplan.pp)
    hideable = layer_mult * (lat["t_inter"] + lat["t_intra"]) + t_pp
    exposed = (layer_mult * (lat["t_exposed_inter"]
                             + lat["t_exposed_intra"]) + exposed_pp)
    return {
        "t_step": total,
        "t_layers": t_layers,
        "t_pp": t_pp,
        "t_cfg": t_cfg,
        "t_bubble": t_bubble,
        "t_compute_step": layer_mult * lat["t_compute"],
        "t_issue_step": layer_mult * lat["t_issue"],
        "overlap_efficiency": (1.0 - exposed / hideable
                               if hideable > 0 else 1.0),
        "branches": float(branches),
        "inter_elems_step": (branches * (n_layers / hplan.pp)
                             * lat["inter_elems"]
                             + (pipefusion_boundary_volume(wl, hplan.pp)
                                if hplan.pp_inter else 0.0)
                             + (cfg_recombine_volume(wl)
                                if guided and hplan.cfg_inter else 0.0)),
        **_per_leg_step(lat, layer_mult),
    }


# ---------------------------------------------------------------------------
# scheduler scoring API (DESIGN.md §9) + calibration loading
# ---------------------------------------------------------------------------

def plan_step_latency(
    hplan: HybridPlan,
    wl: LayerWorkload,
    net: NetworkModel = NetworkModel(),
    *,
    n_layers: int,
    guided: bool = True,
    guidance_branches: int = 2,
    num_patches: int | None = None,
    num_steps: int = 20,
    comm_backend: str | None = None,
) -> dict[str, float]:
    """Predicted per-sampler-step latency of ANY hybrid plan — the single
    entry point the request scheduler scores candidate plans through.

    Dispatches to ``sp_step_latency`` for degenerate (cfg=1, pp=1) plans
    and ``hybrid_step_latency`` otherwise; both return a dict whose
    ``t_step`` is the admission policy's scoring quantity.

    ``comm_backend`` overrides the plan's own backend annotation (None =
    use ``hplan.comm_backend``); "pallas" scores the kernel-fused
    schedule, which drops the per-step issue overhead — this is how the
    planner and the scheduler's plan cache prefer the fused path when it
    wins.

    ``hplan.hier_a2a`` / ``hplan.a2a_wire_dtype`` select the hierarchical
    two-level a2a and its fp8 wire compression (DESIGN.md §8.2); both
    thread down to ``attention_layer_latency``'s per-leg terms so flat and
    hierarchical candidates for the same (P_u, P_r) score differently.
    """
    cb = comm_backend if comm_backend is not None else hplan.comm_backend
    hier = hplan.hier_a2a
    wire = hplan.a2a_wire_dtype
    if hplan.cfg == 1 and hplan.pp == 1:
        return sp_step_latency(
            hplan.sp, wl, net, n_layers=n_layers, guided=guided,
            guidance_branches=guidance_branches,
            swift=hplan.sp.ulysses_inter, comm_backend=cb,
            hierarchical=hier, wire_dtype=wire)
    return hybrid_step_latency(
        hplan, wl, net, n_layers=n_layers, guided=guided,
        guidance_branches=guidance_branches, num_patches=num_patches,
        num_steps=num_steps, comm_backend=cb,
        hierarchical=hier, wire_dtype=wire)


# NetworkModel fields the calibration fitter treats as free parameters
# (core/calibration.py, scripts/calibrate_comm.py, sched/control.py's
# OnlineCalibrator).  flops and bytes_per_elem are hardware constants;
# step_issue_overhead is calibrated on the device (ROADMAP item), not from
# step-latency records, which cannot separate it from the hop latencies.
# The per-leg a2a parameters (DESIGN.md §8.2) join the fit: sweeps that
# never exercise the hierarchical path leave them unidentifiable and the
# fitter's damping holds their ratios at 1.0.
FIT_PARAMS = ("intra_bw", "inter_bw", "intra_lat", "inter_lat", "mfu",
              "a2a_intra_bw", "inter_hop_lat", "codec_bw")


def fit_param_ratios(net: NetworkModel,
                     ref: NetworkModel | None = None) -> dict[str, float]:
    """Per-parameter ratio of ``net`` over ``ref`` (nominal by default) —
    the drift measure the online recalibration loop thresholds on and the
    quantity the calibration regression tests pin."""
    ref = ref if ref is not None else NetworkModel()
    return {k: getattr(net, k) / getattr(ref, k) for k in FIT_PARAMS}


def network_model_from_dict(d: dict) -> NetworkModel:
    """NetworkModel with any subset of fields overridden; non-field keys
    (e.g. the fit report ``calibrate_comm.py`` attaches) are ignored."""
    fields = {f.name for f in dataclasses.fields(NetworkModel)}
    return dataclasses.replace(
        NetworkModel(), **{k: v for k, v in d.items() if k in fields})


def load_network_model(path: str | pathlib.Path) -> NetworkModel:
    """Load a calibration JSON written by ``scripts/calibrate_comm.py``
    (the ``--calibration`` flag of the benchmark sweeps)."""
    return network_model_from_dict(
        json.loads(pathlib.Path(path).read_text()))
