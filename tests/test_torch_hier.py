"""The port's hierarchical all-to-all and its fp8 wire codec on the CPU,
against the reference.

* Codec: ``quantize`` / ``dequantize`` / ``ef_encode`` are bitwise the
  reference's (payload bytes, scale, residual) on the same float32 and
  bfloat16 arrays, for both wire dtypes; plus the cases of
  tests/test_compress.py.
* Exchange: on the reference's ``_hier_layout()`` (P_u 4, P_r 1,
  u_groups 2 over (pod 2, model 2); tests/multidevice/test_comm_stream.py)
  ``hier_all_to_all`` is bitwise the flat exchange and the reference's own
  hierarchical output on the same arrays (8 fake devices, one subprocess
  for the file), its inverse restores the input exactly, and the fp8 wire
  engages and stays within the reference's 0.08.  The fp8 outputs and
  error-feedback residuals carry the reference's fp8 payloads, but not
  its scales bit for bit: under ``jax.jit`` XLA turns the codec's
  ``amax / fmax`` into ``amax * (1 / fmax)``, one float32 rounding away
  (the port divides, as the reference's eager codec does; replacing the
  division by that product makes the two agree bitwise).  They are held
  to ``SCALE_ULP`` relative (outputs) and to that share of the bundle's
  absmax (residuals).
* Slices, attention (hier on vs off at the reference's 1e-5), and the
  recorded schedule: channels, routes, ``validate`` and its negative
  control.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import compress as j_compress
from repro_torch import comm
from repro_torch.comm import compress
from repro_torch.comm import stream as t_stream
from repro_torch.core import SPConfig, sp_attention
from repro_torch.core.collectives import (
    GroupLayout,
    SlicedLayout,
    monolithic_all_to_all,
    ungroup_all_to_all,
)
from repro_torch.launch import make_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
SP_AXES = ("pod", "model")
WIRES = list(compress.WIRE_DTYPES)
FP8_TOL = 0.08  # test_comm_stream.py::test_hier_a2a_fp8_wire_close_to_exact
ATTN_TOL = 1e-5  # test_comm_stream.py::test_hier_attention_matches_flat_end_to_end
# two float32 ulps: the scale is one rounding off, its product one more
SCALE_ULP = 2.0 ** -22
BACKENDS = ["xla", "pallas"]


def _hier_layout():
    return GroupLayout(SP_AXES, 4, 1, ulysses_outer=True, u_groups=2)


def _flat_layout():
    return GroupLayout(SP_AXES, 4, 1, ulysses_outer=True)


def _x(seed=0, shape=(2, 32, 8, 4)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ranks(x: np.ndarray, n=4, axis=1):
    """A global array sharded over the SP axes, as a rank list."""
    return [torch.from_numpy(c.copy()) for c in np.split(x, n, axis=axis)]


def _global(ranks, axis=2):
    """A rank list as the reference's out_spec P(None, None, SP_AXES)."""
    return np.concatenate([r.float().numpy() for r in ranks], axis=axis)


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

def _codec_inputs():
    rng = np.random.default_rng(3)
    normal = rng.standard_normal((64, 96)).astype(np.float32)
    heavy = (rng.standard_t(2, (64, 96)) * 10).astype(np.float32)
    return {"normal": normal, "heavy": heavy}


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("kind", ["normal", "heavy"])
def test_codec_is_bitwise_the_reference(kind, wire, dtype):
    x = _codec_inputs()[kind]
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    # both packages round float32 to bfloat16 the same way
    assert np.array_equal(tx.float().numpy(), np.asarray(jx, np.float32))
    err = (np.random.default_rng(4).standard_normal(x.shape) * 1e-3
           ).astype(np.float32)

    tw, ts = compress.quantize(tx, wire)
    jw, js = j_compress.quantize(jx, wire)
    assert tw.dtype == getattr(torch, wire) and ts.dtype == torch.float32
    assert np.array_equal(_bytes(tw), np.asarray(jw).view(np.uint8))
    assert ts.item() == float(js)
    back = compress.dequantize(tw, ts, tx.dtype)
    jback = j_compress.dequantize(jw, js, jx.dtype)
    assert np.array_equal(back.float().numpy(), np.asarray(jback, np.float32))

    tw, ts, te = compress.ef_encode(tx, torch.from_numpy(err), wire)
    jw, js, je = j_compress.ef_encode(jx, jnp.asarray(err), wire)
    assert np.array_equal(_bytes(tw), np.asarray(jw).view(np.uint8))
    assert ts.item() == float(js)
    assert np.array_equal(te.numpy(), np.asarray(je))


def test_codec_constants_and_unknown_dtype():
    assert compress.WIRE_DTYPES == j_compress.WIRE_DTYPES
    for wire in WIRES:
        assert compress.has_wire_dtype(wire)
        assert float(torch.finfo(getattr(torch, wire)).max) == float(
            jnp.finfo(getattr(jnp, wire)).max)
    assert not compress.has_wire_dtype("int4")
    with pytest.raises(ValueError):
        compress.quantize(torch.zeros(2), "int4")
    # an all-zero payload (a padding chunk) stays exactly representable
    w, s = compress.quantize(torch.zeros(8), "float8_e4m3fn")
    assert torch.equal(compress.dequantize(w, s, torch.float32),
                       torch.zeros(8))


@pytest.mark.parametrize("wire", WIRES)
def test_quantize_roundtrip_relative_error_bounded(wire):
    """tests/test_compress.py: e4m3 has a 3-bit mantissa (~6% step), e5m2
    2 bits (~12%)."""
    x = torch.from_numpy(_x(1, (4, 64)))
    w, scale = compress.quantize(x, wire)
    y = compress.dequantize(w, scale, torch.float32)
    tol = 0.08 if wire == "float8_e4m3fn" else 0.15
    assert float((y - x).abs().max()) <= tol * float(x.abs().max())


def test_quantize_scale_tracks_absmax():
    x = torch.tensor([[1e-3, -2e-3], [5e-4, 1.5e-3]])
    _, scale = compress.quantize(x, "float8_e4m3fn")
    fmax = float(torch.finfo(torch.float8_e4m3fn).max)
    assert np.isclose(scale.item(), 2e-3 / fmax, rtol=1e-6)


def test_error_feedback_reduces_accumulated_drift():
    """tests/test_compress.py: with error feedback the accumulated error of
    a repeatedly quantised sum stays near one step; without it the bias
    compounds."""
    x = torch.from_numpy(_x(2, (256,)))

    def run(steps, with_ef):
        acc = torch.zeros_like(x)
        err = compress.zero_feedback(x)
        for _ in range(steps):
            if with_ef:
                w, s, err = compress.ef_encode(x, err, "float8_e4m3fn")
            else:
                w, s = compress.quantize(x, "float8_e4m3fn")
            acc = acc + compress.dequantize(w, s, torch.float32)
        return acc

    target = x * 50
    drift_ef = float((run(50, True) - target).abs().max())
    drift_raw = float((run(50, False) - target).abs().max())
    assert drift_ef < drift_raw / 5
    assert drift_ef < 0.5


def test_ef_encode_error_state_is_residual():
    x = torch.from_numpy(_x(5, (32,)))
    w, s, err = compress.ef_encode(x, compress.zero_feedback(x),
                                   "float8_e4m3fn")
    resid = x - compress.dequantize(w, s, torch.float32)
    torch.testing.assert_close(err, resid, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the reference's hierarchical exchange, 8 fake devices, one subprocess
# ---------------------------------------------------------------------------

_JAX_HIER = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.comm import hier_all_to_all, hier_ungroup
from repro.core.collectives import GroupLayout
d = np.load({inputs!r})
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
SP = ("pod", "model")
layout = GroupLayout(SP, 4, 1, ulysses_outer=True, u_groups=2)
xs, st = P(None, SP, None, None), P(None, None, SP, None, None)

def smap(f, ins, outs):
    return jax.jit(shard_map(f, mesh=mesh, in_specs=ins, out_specs=outs,
                             check_vma=False))

out = {{}}
for backend in ("xla", "pallas"):
    out["exact/" + backend] = smap(lambda x: hier_all_to_all(
        x, layout, split_axis=2, backend=backend), (xs,), st)(d["x"])
for wire in {wires!r}:
    out["fp8/" + wire] = smap(lambda x: hier_all_to_all(
        x, layout, split_axis=2, wire_dtype=wire), (xs,), st)(d["x"])
    o, (e,) = smap(lambda x, e: hier_all_to_all(
        x, layout, split_axis=2, wire_dtype=wire, err=(e,)),
        (xs, st), (st, (st,)))(d["x"], d["err"])
    out["ef/" + wire], out["ef_err/" + wire] = o, e
    out["inv/" + wire] = smap(lambda s: hier_ungroup(
        s, layout, concat_axis=2, wire_dtype=wire), (st,), xs)(d["stacked"])
np.savez({outputs!r}, **{{k: np.asarray(v) for k, v in out.items()}})
"""


@pytest.fixture(scope="module")
def jax_hier(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_hier")
    x = _x(0)
    err = (_x(7, (2, 2, 32, 2, 4)) * 1e-2).astype(np.float32)
    stacked = _x(8, (4, 2, 32, 2, 4))
    np.savez(tmp / "in.npz", x=x, err=err, stacked=stacked)
    code = _JAX_HIER.format(inputs=str(tmp / "in.npz"),
                            outputs=str(tmp / "out.npz"), wires=WIRES)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(x=x, err=err, stacked=stacked, **np.load(tmp / "out.npz"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_hier_a2a_is_bitwise_the_flat_exchange_and_the_reference(
        backend, jax_hier):
    x = _ranks(jax_hier["x"])
    hier = monolithic_all_to_all(x, _hier_layout(), split_axis=2,
                                 backend=backend)
    flat = monolithic_all_to_all(x, _flat_layout(), split_axis=2)
    for h, f in zip(hier, flat):
        assert torch.equal(h, f)
    assert np.array_equal(_global(hier), jax_hier[f"exact/{backend}"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_hier_roundtrip_is_the_identity(backend):
    layout = _hier_layout()
    x = _ranks(_x(9))
    stacked = monolithic_all_to_all(x, layout, split_axis=2, backend=backend)
    back = ungroup_all_to_all(stacked, layout, concat_axis=2,
                              backend=backend)
    for b, want in zip(back, x):
        torch.testing.assert_close(b, want, rtol=0, atol=0)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("wire", WIRES)
def test_fp8_wire_engages_and_matches_the_reference(wire, backend, jax_hier):
    """Each rank quantises its own bundle with its own absmax scale: a
    scale over the whole rank list would move every value by far more
    than ``SCALE_ULP``."""
    x = _ranks(jax_hier["x"])
    got = _global(monolithic_all_to_all(x, _hier_layout(), split_axis=2,
                                        backend=backend, wire_dtype=wire))
    exact = jax_hier["exact/xla"]
    assert not np.array_equal(got, exact), "fp8 wire did not engage"
    np.testing.assert_allclose(got, exact, rtol=FP8_TOL, atol=FP8_TOL)
    np.testing.assert_allclose(got, jax_hier[f"fp8/{wire}"],
                               rtol=SCALE_ULP, atol=0)


@pytest.mark.parametrize("wire", WIRES)
def test_error_feedback_residuals_match_the_reference(wire, jax_hier):
    x = _ranks(jax_hier["x"])
    err = [(e,) for e in _ranks(jax_hier["err"], axis=2)]
    out, new_err = t_stream.hier_all_to_all(
        x, _hier_layout(), split_axis=2, wire_dtype=wire, err=err)
    np.testing.assert_allclose(_global(out), jax_hier[f"ef/{wire}"],
                               rtol=SCALE_ULP, atol=0)
    assert [len(e) for e in new_err] == [1] * 4  # g - 1 buffers per rank
    bound = SCALE_ULP * float(np.abs(jax_hier["x"]).max() + 1)
    np.testing.assert_allclose(_global([e for (e,) in new_err]),
                               jax_hier[f"ef_err/{wire}"], rtol=0,
                               atol=bound)


@pytest.mark.parametrize("wire", WIRES)
def test_hier_ungroup_with_fp8_matches_the_reference(wire, jax_hier):
    stacked = _ranks(jax_hier["stacked"], axis=2)
    got = t_stream.hier_ungroup(stacked, _hier_layout(), concat_axis=2,
                                wire_dtype=wire)
    np.testing.assert_allclose(
        np.concatenate([g.numpy() for g in got], axis=1),
        jax_hier[f"inv/{wire}"], rtol=SCALE_ULP, atol=0)


# ---------------------------------------------------------------------------
# slices, attention, schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_hier_exchange_keeps_every_chunk_in_its_slice(backend):
    """On a mesh with a data axis the rank list holds both slices; one put
    covers both, every route stays inside its slice, and each slice gets
    exactly its own exchange."""
    sliced = SlicedLayout(_hier_layout(), 2)
    xs = [_x(10 + s) for s in range(2)]
    ranks = [r for x in xs for r in _ranks(x)]
    with comm.record("sliced") as tr:
        got = monolithic_all_to_all(ranks, sliced, split_axis=2,
                                    backend=backend)
    for e in tr.events:
        assert all(s // 4 == d // 4 for s, d in e.perm), e.perm
    for s, x in enumerate(xs):
        alone = monolithic_all_to_all(_ranks(x), _flat_layout(),
                                      split_axis=2)
        for g, a in zip(got[4 * s:4 * s + 4], alone):
            assert torch.equal(g, a)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    rep = comm.validate(tr, mesh, require_overlap=False)
    assert rep.ok, rep.summary()
    # the route check refuses a perm that leaves its slice
    bad = dataclasses.replace(tr.events[0], perm=tuple(
        (s, (d + 4) % 8) for s, d in tr.events[0].perm))
    rep = comm.validate(comm.ScheduleTrace("bad", events=[bad]), mesh,
                        require_overlap=False)
    assert any("leave their batch slice" in f for f in rep.failures)


def _attn_inputs(heads):
    rng = np.random.default_rng(11)
    return [torch.from_numpy(rng.standard_normal((2, 32, heads, 16)).astype(
        np.float32)) for _ in range(3)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("strategy,heads", [("ulysses", 8), ("swift", 4),
                                            ("swift_torus", 4)])
def test_attention_with_hier_a2a_matches_flat(strategy, heads, backend):
    """On mesh (pod 2, model 4): ulysses plans P_u 8 (g 2, m_u 4), swift
    and swift_torus P_u 4 x P_r 2 (g 2, m_u 2)."""
    mesh = make_mesh((2, 4), ("pod", "model"), device="cpu")
    base = SPConfig(strategy=strategy, sp_axes=SP_AXES, batch_axes=None,
                    comm_backend=backend)
    q, k, v = _attn_inputs(heads)

    def run(cfg):
        with comm.record(strategy) as tr:
            out = sp_attention(q, k, v, cfg=cfg, mesh=mesh, causal=True)
        return out, [e for e in tr.events if e.stream.startswith("hier")]

    flat, flat_puts = run(base)
    hier, hier_puts = run(dataclasses.replace(base, hier_a2a=True))
    assert not flat_puts and hier_puts  # the two-level path ran
    torch.testing.assert_close(hier, flat, rtol=0, atol=ATTN_TOL)


def test_hier_schedule_channels_routes_and_overlap():
    """tests/multidevice/test_comm_stream.py's trace gate: two tensors
    through the transform (as Q/K/V go through gather_qkv), one intra and
    one inter stage each; the fast leg never crosses the pod boundary,
    the slow leg does and declares its overlap, and ``validate`` admits
    it."""
    layout = _hier_layout()
    xs = [_ranks(_x(s)) for s in (12, 13)]
    with comm.record("hier") as tr:
        for x in xs:
            monolithic_all_to_all(x, layout, split_axis=2)
    chans = [e.channel for e in tr.events]
    assert chans == ["hier.a2a.intra1", "hier.a2a.inter1"] * 2, chans
    intra_e, inter_e = tr.events[:2]
    assert intra_e.perm == tuple(layout.ulysses_intra_stage_perm(1))
    assert inter_e.perm == tuple(layout.ulysses_inter_stage_perm(1))
    for s, d in intra_e.perm:
        assert s // 2 == d // 2, intra_e.perm
    assert any(s // 2 != d // 2 for s, d in inter_e.perm)
    assert all(e.overlaps for e in tr.events if "inter" in e.channel)
    mesh = make_mesh((2, 2), SP_AXES, device="cpu")
    rep = comm.validate(tr, mesh)
    assert rep.ok, rep.summary()
    assert any(ch.startswith("hier.a2a.inter") for ch in rep.overlapped)


def test_validate_refuses_a_put_waited_before_any_compute(monkeypatch):
    """Negative control: the inter hop waited right after its put (before
    the diagonal bundle is placed) has nothing to run beside."""
    real = t_stream.inter_hop

    def waited_at_once(*args, **kw):
        fut = real(*args, **kw)
        fut.wait()
        return fut

    monkeypatch.setattr(t_stream, "inter_hop", waited_at_once)
    with comm.record("hier") as tr:
        monolithic_all_to_all(_ranks(_x(14)), _hier_layout(), split_axis=2)
    rep = comm.validate(tr, make_mesh((2, 2), SP_AXES, device="cpu"))
    assert not rep.ok
    assert any("hier.a2a.inter1" in f and "no compute" in f
               for f in rep.failures), rep.failures
