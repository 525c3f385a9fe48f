"""Topology-aware SP planner (paper §4.2).

Given a cluster of N machines × M devices (GPU: N hosts × M NVLink-joined
cards in the SP group) and an attention layer with H heads, SwiftFusion organises
the N·M devices into a 2-D logical mesh P_u × P_r with

    P_u = gcd(N·M, H)          (maximise Ulysses usage)
    P_r = N·M / P_u

and assigns the *Ulysses* group to span the slow (inter-machine) boundary
and the *Ring* group to stay inside the fast (intra-machine) network —
the inverse of USP's assignment.

For GQA models the Ulysses head-scatter must divide the number of *KV*
heads (otherwise KV heads would have to be replicated); the planner
therefore takes ``heads = gcd(H_q, H_kv)`` unless ``replicate_kv`` is set.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SPPlan:
    """A concrete SP decomposition of ``n_machines * m_per_machine`` devices."""

    n_machines: int  # N: pods (slow boundary)
    m_per_machine: int  # M: chips per pod in the SP group (fast network)
    p_ulysses: int  # P_u
    p_ring: int  # P_r
    ulysses_inter: bool  # True = SwiftFusion/TAS, False = USP baseline

    @property
    def sp_degree(self) -> int:
        return self.n_machines * self.m_per_machine

    @property
    def torus_degree(self) -> int:
        """N for Torus Attention (inter-machine Ulysses stages), §4.3.

        Torus applies when Ulysses spans machines; its stage count is the
        number of machines covered by the Ulysses group.
        """
        if not self.ulysses_inter:
            return 1
        return min(self.p_ulysses, self.n_machines)

    def validate(self) -> None:
        assert self.p_ulysses * self.p_ring == self.sp_degree, self
        assert self.p_ulysses >= 1 and self.p_ring >= 1, self


def plan(
    n_machines: int,
    m_per_machine: int,
    num_q_heads: int,
    num_kv_heads: int | None = None,
    *,
    swift: bool = True,
    replicate_kv: bool = False,
) -> SPPlan:
    """Compute (P_u, P_r) per §4.2: P_u = gcd(N*M, H), P_r = N*M / P_u."""
    sp = n_machines * m_per_machine
    if num_kv_heads is None:
        num_kv_heads = num_q_heads
    heads = num_q_heads if replicate_kv else math.gcd(num_q_heads, num_kv_heads)
    p_u = math.gcd(sp, heads)
    p = SPPlan(
        n_machines=n_machines,
        m_per_machine=m_per_machine,
        p_ulysses=p_u,
        p_ring=sp // p_u,
        ulysses_inter=swift,
    )
    p.validate()
    return p


def usp_plan(
    n_machines: int,
    m_per_machine: int,
    num_q_heads: int,
    num_kv_heads: int | None = None,
) -> SPPlan:
    """The USP baseline: same (P_u, P_r) factorisation but Ring spans the
    inter-machine boundary and Ulysses stays intra-machine (§2.2)."""
    p = plan(n_machines, m_per_machine, num_q_heads, num_kv_heads, swift=False)
    return p


# ---------------------------------------------------------------------------
# hybrid planning: (cfg, pp, P_u, P_r) over N machines × M chips
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HybridPlan:
    """A (cfg, pp, P_u, P_r) decomposition of N·M devices (DESIGN.md §7).

    The hybrid axes are ordered by how rarely they synchronise:

      cfg — classifier-free-guidance parallelism (xDiT, arXiv:2411.01738),
            generalised to guidance degree k (negative prompts /
            multi-conditioning stacks): the k branches are independent
            full forwards that recombine ONCE per sampler step (one
            psum-sized weighted sum of the velocity).  Cheapest axis;
            placed across the slow (inter-machine) boundary first.
      pp  — patch-level pipeline parallelism (PipeFusion): stages exchange
            one patch's activations per micro-step, once per layer-group
            rather than per layer.  Second-cheapest; also prefers the slow
            boundary.
      sp  — the remaining devices run the paper's topology-aware SP plan
            (Torus/TAS placement rules unchanged) on the residual
            (machines × chips) sub-mesh.
    """

    cfg: int  # 1 (sequential CFG) or k >= 2 (parallel guidance branches)
    pp: int  # pipeline stages
    sp: SPPlan  # SP factorisation of the remaining devices
    n_machines: int  # N of the full cluster
    m_per_machine: int  # M of the full cluster
    cfg_machines: int = 1  # machine-level factor consumed by cfg
    pp_machines: int = 1  # machine-level factor consumed by pp
    # Comm lowering the plan will execute with (DESIGN.md §8.1): "pallas"
    # scores the kernel-fused schedule (no per-step issue overhead) in
    # comm_model.plan_step_latency and selects the fused ring kernel via
    # SPConfig.comm_backend at execution time.
    comm_backend: str = "xla"
    # Hierarchical two-level a2a (DESIGN.md §8.2): decompose the Ulysses
    # all-to-alls into intra-machine exchange + staged inter-machine hops.
    # Only meaningful when comm_model.hierarchical_applicable(sp) holds —
    # the executor and the latency model both fall back to the flat path
    # otherwise.  a2a_wire_dtype optionally compresses the inter-machine
    # leg ("float8_e4m3fn"/"float8_e5m2"); None keeps the wire exact.
    hier_a2a: bool = False
    a2a_wire_dtype: str | None = None

    @property
    def total_devices(self) -> int:
        return self.cfg * self.pp * self.sp.sp_degree

    @property
    def cfg_inter(self) -> bool:
        """True when the CFG pair spans the inter-machine boundary."""
        return self.cfg_machines > 1

    @property
    def pp_inter(self) -> bool:
        """True when pipeline-stage hand-offs cross machines."""
        return self.pp_machines > 1

    def validate(self) -> None:
        assert self.cfg >= 1, self
        assert self.pp >= 1, self
        assert self.comm_backend in ("xla", "pallas"), self
        if self.a2a_wire_dtype is not None:
            from ..comm.compress import WIRE_DTYPES
            assert self.a2a_wire_dtype in WIRE_DTYPES, self
            assert self.hier_a2a, "wire compression rides the hier path only"
        self.sp.validate()
        assert self.total_devices == self.n_machines * self.m_per_machine, self


def _consume(n: int, m: int, degree: int) -> tuple[int, int, int]:
    """Factor ``degree`` devices out of (n machines × m chips), machines
    first (independent/cheap axes belong on the slow boundary).  Returns
    (n', m', machine_factor)."""
    from_n = math.gcd(n, degree)
    from_m = degree // from_n
    if m % from_m != 0:
        raise ValueError(
            f"cannot factor degree {degree} out of {n} machines x {m} chips")
    return n // from_n, m // from_m, from_n


def plan_hybrid(
    n_machines: int,
    m_per_machine: int,
    num_q_heads: int,
    num_kv_heads: int | None = None,
    *,
    cfg_parallel: bool = False,
    cfg_degree: int = 2,
    pp: int = 1,
    n_layers: int | None = None,
    swift: bool = True,
    replicate_kv: bool = False,
    comm_backend: str = "xla",
    hier_a2a: bool = False,
    a2a_wire_dtype: str | None = None,
) -> HybridPlan:
    """Plan (cfg, pp, P_u, P_r) for N machines × M chips.

    cfg and pp consume machine-level factors first (they synchronise the
    least, see HybridPlan); whatever remains is planned by the paper's §4.2
    rule, so the SP sub-mesh keeps the TAS placement (Ulysses/Torus across
    the surviving machine boundary, Ring inside the machine).
    ``cfg_degree`` is the guidance degree k consumed by the cfg axis when
    ``cfg_parallel`` (k = 2 is the classic cond/uncond pair).

    ``hier_a2a`` requests the hierarchical two-level a2a on the SP
    sub-plan; it is silently dropped (flat plan returned) when the
    residual sub-mesh's topology does not qualify, so callers can pass it
    unconditionally.
    """
    if cfg_parallel:
        assert cfg_degree >= 2, cfg_degree
    cfg = cfg_degree if cfg_parallel else 1
    total = n_machines * m_per_machine
    if total % (cfg * pp) != 0:
        raise ValueError(
            f"cfg*pp = {cfg * pp} does not divide {total} devices")
    if n_layers is not None and pp > 1 and n_layers % pp != 0:
        raise ValueError(f"pp = {pp} does not divide n_layers = {n_layers}")
    n, m = n_machines, m_per_machine
    n, m, cfg_mach = _consume(n, m, cfg)
    n, m, pp_mach = _consume(n, m, pp)
    sp = plan(n, m, num_q_heads, num_kv_heads, swift=swift,
              replicate_kv=replicate_kv)
    if hier_a2a:
        from .comm_model import hierarchical_applicable
        if not hierarchical_applicable(sp):
            hier_a2a, a2a_wire_dtype = False, None
    h = HybridPlan(
        cfg=cfg, pp=pp, sp=sp,
        n_machines=n_machines, m_per_machine=m_per_machine,
        cfg_machines=cfg_mach, pp_machines=pp_mach,
        comm_backend=comm_backend,
        hier_a2a=hier_a2a, a2a_wire_dtype=a2a_wire_dtype,
    )
    h.validate()
    return h


# ---------------------------------------------------------------------------
# per-shape plan selection (DESIGN.md §9): the scheduler's entry point
# ---------------------------------------------------------------------------

def candidate_hybrid_plans(
    n_machines: int,
    m_per_machine: int,
    num_q_heads: int,
    num_kv_heads: int | None = None,
    *,
    n_layers: int | None = None,
    cfg_degree: int = 2,
    max_pp: int = 4,
    swift: bool = True,
    replicate_kv: bool = False,
    comm_backend: str = "xla",
    a2a_wire_dtype: str | None = None,
) -> list[HybridPlan]:
    """Every feasible (cfg, pp) split of the cluster, deduplicated by the
    resulting (cfg, pp, P_u, P_r, hier) — the candidate set
    ``plan_for_shape`` and the scheduler's plan cache score per bucket.
    Each candidate's SP sub-plan keeps the §4.2 TAS/Torus placement; when
    the residual sub-mesh qualifies, a hierarchical-a2a variant of the
    same factorisation is emitted alongside the flat one (with
    ``a2a_wire_dtype`` compression when requested), so flat-vs-hier is a
    scored decision per topology, not a config toggle."""
    from .comm_model import hierarchical_applicable

    pps = [1]
    while pps[-1] * 2 <= max_pp:
        pps.append(pps[-1] * 2)
    seen, out = set(), []

    def add(h: HybridPlan) -> None:
        key = (h.cfg, h.pp, h.sp.p_ulysses, h.sp.p_ring,
               h.hier_a2a, h.a2a_wire_dtype)
        if key not in seen:
            seen.add(key)
            out.append(h)

    for cfg_parallel in (False, True):
        for pp in pps:
            try:
                h = plan_hybrid(
                    n_machines, m_per_machine, num_q_heads, num_kv_heads,
                    cfg_parallel=cfg_parallel, cfg_degree=cfg_degree, pp=pp,
                    n_layers=n_layers, swift=swift, replicate_kv=replicate_kv,
                    comm_backend=comm_backend)
            except ValueError:
                continue
            add(h)
            if hierarchical_applicable(h.sp):
                add(dataclasses.replace(h, hier_a2a=True))
                if a2a_wire_dtype is not None:
                    add(dataclasses.replace(
                        h, hier_a2a=True, a2a_wire_dtype=a2a_wire_dtype))
    return out


def plan_for_shape(
    n_machines: int,
    m_per_machine: int,
    num_q_heads: int,
    num_kv_heads: int | None = None,
    *,
    seq: int,
    batch: int = 1,
    head_dim: int,
    n_layers: int,
    net=None,
    guided: bool = True,
    guidance_branches: int = 2,
    num_steps: int = 20,
    candidates: list[HybridPlan] | None = None,
    cfg_degree: int = 2,
    max_pp: int = 4,
    swift: bool = True,
    comm_backend: str = "xla",
    a2a_wire_dtype: str | None = None,
) -> tuple[HybridPlan, dict]:
    """Select the (cfg, pp, P_u, P_r) plan with the lowest predicted step
    latency FOR A SPECIFIC WORKLOAD SHAPE (batch, seq) — the per-bucket
    planning entry the request scheduler uses: plan_hybrid is shape-blind
    (it factors devices), but which factorisation wins depends on the
    sequence length through the comm model.  Returns (plan, prediction).
    """
    from .comm_model import LayerWorkload, NetworkModel, plan_step_latency

    net = net or NetworkModel()
    cands = candidates if candidates is not None else candidate_hybrid_plans(
        n_machines, m_per_machine, num_q_heads, num_kv_heads,
        n_layers=n_layers, cfg_degree=cfg_degree, max_pp=max_pp, swift=swift,
        comm_backend=comm_backend, a2a_wire_dtype=a2a_wire_dtype)
    assert cands, "no feasible hybrid plan"
    wl = LayerWorkload(batch=batch, seq=seq, heads=num_q_heads,
                       head_dim=head_dim)
    best: tuple[HybridPlan, dict] | None = None
    for h in cands:
        pred = plan_step_latency(
            h, wl, net, n_layers=n_layers, guided=guided,
            guidance_branches=guidance_branches, num_steps=num_steps)
        if best is None or pred["t_step"] < best[1]["t_step"]:
            best = (h, pred)
    return best
