"""The port's one-sided comm layer on the CPU: the plain versions of the
put kernels K3 (remote_put) and K4 (landing_copy) deliver bitwise and set
their signal words, channel routes equal the reference's GroupLayout
tables, every backend of a put moves the same bytes, and the recorded
semaphore schedule of the fused ring path validates (and a wait before
its put does not).

Shapes and dtypes are those of tests/test_comm_backends.py (uneven
per-shard shapes, float32 and bfloat16).  The CUDA kernels themselves are
held to these plain versions on the card by tests/test_torch_kernels_cuda.py
and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from repro.core.collectives import GroupLayout as JLayout
from repro_torch import comm
from repro_torch.comm import kernel_backend as kb
from repro_torch.comm.channel import dest_table
from repro_torch.core import SPConfig
from repro_torch.core.collectives import GroupLayout
from repro_torch.core.ring import ring_attention
from repro_torch.core.torus import torus_attention
from repro_torch.launch import make_mesh

DTYPES = [torch.float32, torch.bfloat16]
UNEVEN_SHAPES = [(3, 5), (7, 3, 2), (1, 13)]  # tests/test_comm_backends.py
LAYOUTS = [(4, 2, True), (4, 2, False), (2, 4, True), (8, 2, True),
           (1, 8, True), (8, 1, True)]


def _ranks(seed, n, shape, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(dtype) for _ in range(n)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", UNEVEN_SHAPES)
def test_plain_remote_put_delivers_bitwise(dtype, shape):
    ranks, tensors = 16, 2
    src = [_ranks(r, tensors, shape, dtype) for r in range(ranks)]
    perm = [(r + 3) % ranks for r in range(ranks)]
    dst = [[torch.empty(shape, dtype=dtype) for _ in range(tensors)]
           for _ in range(ranks)]
    signal = torch.zeros(ranks * tensors, dtype=torch.int32)
    arrive = torch.zeros_like(signal)
    kb.remote_put(src, dst, perm, signal=signal, arrive=arrive, epoch=7)
    for r in range(ranks):
        for i in range(tensors):
            assert torch.equal(dst[perm[r]][i], src[r][i])
    assert torch.all(signal == 7) and torch.all(arrive == 0)
    assert kb.launch_count("remote_put") == 0  # CPU: plain version


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", UNEVEN_SHAPES)
def test_plain_landing_copy_delivers_bitwise(dtype, shape):
    ranks, tensors = 8, 3
    src = [_ranks(10 + r, tensors, shape, dtype) for r in range(ranks)]
    dst = [[torch.empty(shape, dtype=dtype) for _ in range(tensors)]
           for _ in range(ranks)]
    signal = torch.zeros(ranks * tensors, dtype=torch.int32)
    kb.landing_copy(src, dst, signal=signal, arrive=torch.zeros_like(signal),
                    epoch=5)
    for r in range(ranks):
        for i in range(tensors):
            assert torch.equal(dst[r][i], src[r][i])
    assert torch.all(signal == 5)


def test_put_kernels_reject_what_they_do_not_take():
    x = [[torch.zeros(3)], [torch.zeros(3)]]
    sig = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="permutation"):
        kb.remote_put(x, x, [0, 0], signal=sig, arrive=sig, epoch=1)
    with pytest.raises(ValueError, match="into"):
        kb.landing_copy(x, [[torch.zeros(4)], [torch.zeros(3)]], signal=sig,
                        arrive=sig, epoch=1)
    many = [[torch.zeros(1)] * 2 for _ in range(kb.MAX_ENTRIES)]
    with pytest.raises(ValueError, match="entries"):
        kb.landing_copy(many, many, signal=sig, arrive=sig, epoch=1)


def test_wrapper_mirrors_the_kernel_constants():
    """The wrapper's MAX_ENTRIES is the one csrc/one_sided.cu sizes its
    table by, and the heap's signal rows hold a full launch's words."""
    import pathlib
    import re
    src = (pathlib.Path(kb.__file__).resolve().parents[1] / "csrc"
           / "one_sided.cu").read_text()
    found = re.findall(r"constexpr int MAX_ENTRIES = (\d+);", src)
    assert found == [str(kb.MAX_ENTRIES)]
    assert kb.SIGNAL_WORDS >= kb.MAX_ENTRIES


@pytest.mark.parametrize("p_u,p_r,outer", LAYOUTS)
def test_routes_equal_reference_tables(p_u, p_r, outer):
    mine = GroupLayout(("pod", "model"), p_u, p_r, ulysses_outer=outer)
    ref = JLayout(("pod", "model"), p_u, p_r, ulysses_outer=outer)
    for shift in range(1, p_r + 1):
        assert mine.ring_perm(shift) == ref.ring_perm(shift)
        assert comm.ring_perm_of(mine, shift) == tuple(ref.ring_perm(shift))
    for k in range(p_u + 1):
        assert mine.ulysses_stage_perm(k) == ref.ulysses_stage_perm(k)
    for p in range(mine.size):
        assert mine.coords(p) == ref.coords(p)
        assert mine.rank(*mine.coords(p)) == p
    assert comm.shift_perm(p_u * p_r, 3) == tuple(
        (r, (r + 3) % (p_u * p_r)) for r in range(p_u * p_r))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", UNEVEN_SHAPES)
def test_every_lowering_moves_the_same_bytes(dtype, shape):
    """xla copies, the emulated put (transport + K4) and the direct put (K3)
    deliver rank s's tensors to rank perm[s], bitwise, and the kernel
    lowerings signal each (rank, tensor) with the put's epoch."""
    layout = GroupLayout(("model",), 4, 4, ulysses_outer=True)
    x = _ranks(1, 16, shape, dtype)
    y = _ranks(2, 16, shape, dtype)
    perm = layout.ulysses_stage_perm(3)
    dst = dest_table(perm, 16)
    heap = kb.heap_for(torch.device("cpu"))
    for backend, interpret, row in (("xla", True, None),
                                    ("pallas", True, "landing_copy"),
                                    ("pallas", False, "remote_put")):
        ch = comm.Channel(("model",), tuple(perm), backend=backend,
                          interpret=interpret)
        gx, gy = ch.put(x, y).wait()
        for s in range(16):
            assert torch.equal(gx[dst[s]], x[s]) and torch.equal(gy[dst[s]], y[s])
        if row is not None:
            assert torch.all(heap.words(row, 0, 32)[0] == heap.epoch)


def test_multi_axis_route_takes_the_landing_copy():
    """The reference's branch rule (pallas_backend.py:180): only a
    single-axis route with interpret=False takes the direct put."""
    heap = kb.heap_for(torch.device("cpu"))
    x = _ranks(3, 4, (2, 3), torch.float32)
    perm = tuple(comm.shift_perm(4))
    for axes, interpret, row in ((("pod", "model"), False, "landing_copy"),
                                 (("model",), True, "landing_copy"),
                                 (("model",), False, "remote_put")):
        heap.signals.zero_()
        comm.Channel(axes, perm, backend="pallas",
                     interpret=interpret).put(x).wait()
        other = "remote_put" if row == "landing_copy" else "landing_copy"
        assert torch.all(heap.words(row, 0, 4)[0] == heap.epoch)
        assert torch.all(heap.words(other, 0, 4)[0] == 0)


def test_staged_all_to_all_round_trip_is_exact():
    layout = GroupLayout(("pod", "model"), 4, 2, ulysses_outer=True)
    x = _ranks(4, 8, (2, 5, 8, 3), torch.float32)
    for backend in ("xla", "pallas"):
        got = comm.staged_all_to_all(x, layout, split_axis=2, backend=backend)
        for p in range(8):
            u, r = layout.coords(p)
            for j in range(4):  # chunk u of peer (j, r)
                src = layout.rank(j, r)
                assert torch.equal(got[p][j], x[src][:, :, 2 * u:2 * u + 2])
        back = comm.staged_ungroup(got, layout, concat_axis=2, backend=backend)
        assert all(torch.equal(b, x[p]) for p, b in enumerate(back))


def _fused_ring_trace():
    layout = GroupLayout(("pod", "model"), 2, 4, ulysses_outer=True)
    q = _ranks(5, 8, (1, 16, 2, 16), torch.float32)
    k = _ranks(6, 8, (1, 16, 2, 16), torch.float32)
    with comm.record("fused ring") as tr:
        ring_attention(q, k, k, layout, q_pos=None, k_pos_fn=None,
                       backend="pallas")
    return tr


def test_fused_ring_schedule_validates():
    tr = _fused_ring_trace()
    kinds = [e.kind for e in tr.sem_events]
    # P_r = 4: three fused puts, each put -> signal -> compute -> wait
    assert kinds == ["put", "signal", "compute", "wait"] * 3
    assert all(e.overlap for e in tr.sem_events if e.kind == "put")
    assert len(tr.events) == 3 and all(e.backend == "pallas" for e in tr.events)
    rep = comm.validate_semaphores(tr)
    assert rep.ok, rep.summary()
    assert (rep.puts, rep.waits) == (3, 3)


def test_validator_rejects_a_wait_before_its_put():
    tr = _fused_ring_trace()
    events = tr.sem_events
    first_put = next(i for i, e in enumerate(events) if e.kind == "put")
    wait = next(e for e in events if e.kind == "wait"
                and e.sem == events[first_put].sem)
    bad = comm.ScheduleTrace("bad", sem_events=[wait] + list(events))
    assert any("wait before put" in f
               for f in comm.validate_semaphores(bad).failures)
    # and a fused put waited with no compute in between is a blocking wait
    sem = events[first_put].sem
    blocking = comm.ScheduleTrace("blocking", sem_events=[
        e for e in events if e.sem == sem and e.kind != "compute"])
    assert any("blocking wait" in f
               for f in comm.validate_semaphores(blocking).failures)


@pytest.mark.parametrize("fused_pull_q", [False, True])
def test_torus_pull_hops_are_issued_a_stage_ahead(fused_pull_q):
    """Every Pull-Q / Pull-KV hop is put before the attention of the stage
    ahead of it, so a compute block lies between each hop's put and its
    wait (a hop waited right after its put would run between two compute
    stages); the Push-O hops follow the finalized O and cannot.  With
    ``fused_pull_q`` no compute runs during the Pull-Q stages (the one
    circulation needs every Q chunk), so only the Pull-KV hops overlap."""
    layout = GroupLayout(("pod", "model"), 4, 2, ulysses_outer=True)
    q = _ranks(7, 8, (1, 16, 4, 16), torch.float32)
    k = _ranks(8, 8, (1, 16, 4, 16), torch.float32)
    with comm.record("torus") as tr:
        torus_attention(q, k, k, layout, causal=True, backend="pallas",
                        fused_pull_q=fused_pull_q)
    events = tr.sem_events
    torus_puts = [i for i, e in enumerate(events)
                  if e.kind == "put" and e.stream == "torus"]
    assert len(torus_puts) == 2 * (4 - 1)
    for pi in torus_puts[4 - 1:] if fused_pull_q else torus_puts:
        wi = next(i for i, e in enumerate(events)
                  if e.kind == "wait" and e.sem == events[pi].sem)
        assert any(events[i].kind == "compute" for i in range(pi + 1, wi)), (
            f"{events[pi].channel}: no compute between its put and its wait")
    assert comm.validate_semaphores(tr).ok


def test_hierarchical_a2a_is_not_ported_yet():
    """The hierarchical all-to-all and its wire codec are ported now: the
    options configure, an unknown wire dtype is refused, and the layout
    engages the two-level factorisation only where the topology
    qualifies (tests/test_torch_hier.py holds the path itself)."""
    from repro_torch.core.strategy import resolve_layout

    SPConfig(hier_a2a=True, a2a_wire_dtype="float8_e4m3fn")
    with pytest.raises(AssertionError):
        SPConfig(hier_a2a=True, a2a_wire_dtype="int4")
    mesh = make_mesh((2, 4), ("pod", "model"), device="cpu")
    for hier, want in ((True, 2), (False, 1)):
        cfg = SPConfig(strategy="ulysses", sp_axes=("pod", "model"),
                       hier_a2a=hier)
        assert resolve_layout(cfg, mesh, 8, 8).u_groups == want


def test_mesh_axis_sizes():
    mesh = make_mesh((2, 8), ("pod", "model"), device="cpu")
    assert mesh.shape == {"pod": 2, "model": 8} and mesh.size == 16
    assert mesh.axes_size(("pod", "model")) == 16
    assert mesh.axes_size(("model",)) == 8
    with pytest.raises(ValueError):
        make_mesh((2,), ("pod", "model"), device="cpu")
