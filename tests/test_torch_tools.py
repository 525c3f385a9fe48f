"""The port's offline tools: launch/calibrate.py (the counterpart of
scripts/calibrate_comm.py), launch/roofline.py, launch/report.py,
launch/dryrun.py (the step's FLOPs, bytes and puts counted on the meta
device over a mesh of virtual ranks) and serving/sampler.py's
toy_vae_decode, each against the reference or a count made by hand."""
import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import calibration as j_cal
from repro.core import comm_model as j_cm
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import InputShape
from repro_torch.core import SPConfig, resolve_layout
from repro_torch.core import calibration as t_cal
from repro_torch.core import comm_model as t_cm
from repro_torch.launch import calibrate as t_calib
from repro_torch.launch import dryrun as dr
from repro_torch.launch import report as t_report
from repro_torch.launch import roofline as t_rl
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import dit as t_dit

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "data" / "BENCH_hybrid_sweep.calibration_fixture.json"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: one intra-op thread each under the run's workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref_script():
    spec = importlib.util.spec_from_file_location(
        "calibrate_comm", REPO / "scripts" / "calibrate_comm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_fit(ref_script):
    return ref_script.fit(ref_script.load_records([FIXTURE]))


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def test_calibration_fit_equals_reference_from_the_same_start(ref_script):
    recs = t_calib.load_records([FIXTURE])
    assert recs == ref_script.load_records([FIXTURE]) and len(recs) == 30
    fields = dataclasses.asdict(j_cm.NetworkModel())
    jnet, jrep = j_cal.fit(recs, ref_script.predict_us,
                           start=j_cm.NetworkModel(**fields))
    tnet, trep = t_cal.fit(recs, t_calib.predict_us,
                           start=t_cm.NetworkModel(**fields))
    for k in t_calib.FIT_PARAMS:
        assert getattr(tnet, k) == getattr(jnet, k), k
    assert trep.rms_rel_error == jrep.rms_rel_error
    assert t_calib.FIT_PARAMS == ref_script.FIT_PARAMS
    for rec in recs:
        assert t_calib.predict_us(rec, tnet) == ref_script.predict_us(
            rec, jnet)


def test_calibration_from_h100_nominal_lands_on_the_reference_fit(ref_fit):
    """From the port's H100 nominal model the fit lands on the reference's
    absolute values of what the records identify: inter_bw, and the
    effective compute rate flops · mfu (``flops`` is a hardware constant,
    not fitted: 989e12 here, 197e12 there)."""
    jnet, _ = ref_fit
    recs = t_calib.load_records([FIXTURE])
    tnet, report = t_calib.fit(recs)
    assert tnet.flops == 989e12
    assert tnet.inter_bw == pytest.approx(jnet.inter_bw, rel=0.05)
    assert tnet.flops * tnet.mfu == pytest.approx(jnet.flops * jnet.mfu,
                                                  rel=0.05)
    assert report["rms_rel_error"] < 0.02
    for rec in recs:
        assert t_calib.predict_us(rec, tnet) == pytest.approx(
            rec["measured_step_us"], rel=0.05), rec["name"]


def test_calibration_cli(tmp_path, capsys):
    out = tmp_path / "fit.json"
    assert t_calib.main([str(FIXTURE), "--out", str(out)]) == 0
    d = json.loads(out.read_text())
    assert set(t_calib.FIT_PARAMS) <= set(d) and d["fit"]["n_records"] == 30
    empty = tmp_path / "none.json"
    empty.write_text(json.dumps({"records": [{"name": "x"}]}))
    assert t_calib.main([str(empty)]) == 1


def test_calibration_of_degree1_records_fits_mfu_only():
    """Records of one card (one machine of one device, unguided): no wire
    term, so the fit moves mfu alone and reproduces the steps."""
    net0 = t_cm.NetworkModel()
    recs = []
    for b, seq in ((2, 4096), (1, 1024), (1, 4096)):
        rec = {"name": f"b{b}s{seq}", "n_machines": 1, "m_per_machine": 1,
               "guided": False,
               "workload": {"batch": b, "seq": seq, "heads": 24,
                            "head_dim": 128, "n_layers": 96},
               "plan": {"cfg": 1, "pp": 1, "p_ulysses": 1, "p_ring": 1,
                        "num_patches": None}}
        rec["measured_step_us"] = t_calib.predict_us(
            rec, dataclasses.replace(net0, mfu=0.2))
        recs.append(rec)
    net, report = t_calib.fit(recs)
    assert net.mfu == pytest.approx(0.2, rel=1e-3)
    for k in ("intra_bw", "inter_bw", "a2a_intra_bw"):
        assert getattr(net, k) == pytest.approx(getattr(net0, k), rel=1e-3)
    assert report["rms_rel_error"] < 1e-3


# ---------------------------------------------------------------------------
# toy VAE decode
# ---------------------------------------------------------------------------

def test_toy_vae_decode_equals_reference_with_its_weight():
    import jax
    import jax.numpy as jnp

    from repro.serving.sampler import toy_vae_decode as j_decode
    from repro_torch.serving import toy_vae_decode as t_decode

    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, 24, 64)).astype(np.float32)
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(42), (64, 12),
                                     jnp.float32))
    ref = np.asarray(j_decode(jnp.asarray(lat)))
    mine = t_decode(torch.from_numpy(lat), weight=torch.from_numpy(w))
    assert mine.shape == ref.shape == (2, 96, 3)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the port's own weight: drawn from a generator seeded 42, fixed
    own = t_decode(torch.from_numpy(lat))
    assert own.shape == ref.shape and torch.equal(
        own, t_decode(torch.from_numpy(lat)))
    assert not torch.equal(own, mine)


# ---------------------------------------------------------------------------
# roofline and report
# ---------------------------------------------------------------------------

def test_roofline_uses_the_h100_terms_of_the_network_model():
    net = t_cm.NetworkModel()
    assert (t_rl.PEAK_FLOPS, t_rl.INTRA_BW, t_rl.INTER_BW) == (
        net.flops, net.intra_bw, net.inter_bw)
    r = t_rl.analyze_from_terms(flops=989e12, byts=3.35e12, coll_bytes=5.5e11,
                                coll_inter=1e11, chips=4, model_flops=2e15)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(4.5e11 / 4.5e11 + 1e11 / 5e10)
    assert r.bottleneck == "collective"
    assert r.useful_ratio == pytest.approx(2e15 / (4 * 989e12))


def _rows():
    from repro.launch import roofline as j_rl

    rows = []
    for i, (arch, shape, mesh) in enumerate([
            ("qwen2-1.5b", "train_4k", "pod"),
            ("qwen2-1.5b", "prefill_32k", "pod"),
            ("flux-12b", "flux_3072", "pod"),
            ("flux-12b", "flux_3072", "multipod")]):
        terms = dict(flops=1e15 * (i + 1), byts=3e12 / (i + 1),
                     coll_bytes=2e10 * i, coll_inter=5e9 * i,
                     chips=256 * (1 + (mesh == "multipod")),
                     model_flops=7e17)
        rows.append({"arch": arch, "shape": shape, "mesh": mesh,
                     "strategy": "swift_torus", "count_s": 12.5 + i,
                     "memory": {"total_bytes": 2**33 * (i + 1)},
                     "roofline": j_rl.analyze_from_terms(**terms).as_dict()})
    return rows


def test_report_tables_equal_reference():
    from repro.launch import report as j_report

    mine = _rows()
    ref = [dict(r, compile_s=r["count_s"]) for r in mine]
    for mesh in ("pod", "multipod"):
        assert t_report.roofline_table(mine, mesh=mesh) == \
            j_report.roofline_table(ref, mesh=mesh)
    assert t_report.dryrun_table(mine) == j_report.dryrun_table(
        ref).replace(" compile |", " count |")


def test_report_renders_null_memory_as_a_dash(tmp_path, capsys):
    rows = _rows()
    rows[0]["memory"]["total_bytes"] = None
    for i, r in enumerate(rows):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    t_report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "### Dry-run matrix" in out and "### Roofline (pod)" in out
    assert "| qwen2-1.5b | train_4k | swift_torus | — |" in out
    assert "| 12.5s | — |" in out


# ---------------------------------------------------------------------------
# dry-run counts
# ---------------------------------------------------------------------------

def _linear_flops(cfg, tokens: int) -> int:
    """A layer's projections and MLP: 2 · tokens · d_in · d_out each."""
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, ff = cfg.resolved_head_dim, cfg.d_ff
    proj = 2 * tokens * d * (hq + 2 * hkv) * hd + 2 * tokens * hq * hd * d
    mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    return proj + mats * 2 * tokens * d * ff


def _attn_flops(cfg, b: int, l: int) -> int:
    """The plain attention's two products over the whole score square
    (masked, not skipped), every query head (K/V repeated for GQA)."""
    return 4 * b * cfg.n_heads * l * l * cfg.resolved_head_dim


def _dense_flops(cfg, b: int, l: int, train: bool) -> int:
    t = b * l
    head = 2 * t * cfg.d_model * cfg.vocab  # tied or not: one product
    layer = _linear_flops(cfg, t)
    attn = _attn_flops(cfg, b, l)
    if not train:
        return cfg.n_layers * (layer + attn) + head
    # remat "full": the forward; the forward again in the backward, up to
    # the last product whose inputs the backward needs (checkpoint's early
    # stop: the layer's last product, the MLP's down-projection, is not
    # run again); the backward: 2 products per linear product, 5 per
    # attention product pair (K1b's plain version forms S again)
    down = 2 * t * cfg.d_ff * cfg.d_model
    return (cfg.n_layers * (4 * layer - down + (1 + 1 + 2.5) * attn)
            + 3 * head)


def _dit_flops(cfg, b: int, t: int) -> int:
    d, c = cfg.d_model, t_dit.LATENT_CHANNELS
    l = t + t_dit.COND_TOKENS
    embed = (2 * b * t * c * d + 2 * b * t_dit.COND_TOKENS * d * d
             + 2 * b * t_dit.TIME_EMB * d + 2 * b * d * d)
    layer = _linear_flops(cfg, b * l) + 2 * b * d * 6 * d
    final = 2 * b * d * 2 * d + 2 * b * l * d * c
    return embed + cfg.n_layers * (layer + _attn_flops(cfg, b, l)) + final


def _count(cfg, shape, mesh, strategy="swift_torus"):
    sp = dr.sp_config_for(shape, mesh, strategy)
    fn, args, sizes = dr.build_step(cfg, shape, mesh, sp)
    return dr.count_step(fn, args, mesh), sizes


@pytest.mark.parametrize("kind", ["training", "prefill"])
def test_dense_flops_equal_a_count_by_hand(kind):
    cfg = get_reduced("qwen2-1.5b")
    b, l = 4, 64
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    c, sizes = _count(cfg, InputShape("t", l, b, kind), mesh)
    assert c.flops == _dense_flops(cfg, b, l, kind == "training")
    # the degree-1 step (one device, attention "full") does the same work
    one, _ = _count(cfg, InputShape("t", l, b, kind),
                    make_mesh((1, 1), ("data", "model"), "meta"))
    assert one.flops == c.flops and one.put_bytes == 0
    assert c.put_bytes > 0 and c.bytes > c.flops / 100
    n_params = sum(p.numel() for p in dr.tree_leaves(
        dr.get_model(cfg).init(cfg, None, "meta")))
    assert sizes["params"] == 2 * n_params  # bf16
    assert sizes["moments"] == (8 * n_params if kind == "training" else 0)
    assert sizes["batch"] == 2 * 4 * b * l  # tokens and labels, int32


def test_dit_prefill_flops_equal_a_count_by_hand():
    cfg = get_reduced("flux-12b")
    mesh = make_mesh((2, 4), ("pod", "model"), "meta")
    shape = InputShape("t", 64, 2, "prefill")
    sp = SPConfig(strategy="swift_torus", sp_axes=("pod", "model"),
                  batch_axes=None)
    fn, args, _ = dr.build_step(cfg, shape, mesh, sp)
    c = dr.count_step(fn, args, mesh)
    assert c.flops == _dit_flops(cfg, 2, 64)


@pytest.mark.parametrize("strategy", ["swift_torus", "swift"])
@pytest.mark.parametrize("shape", [(2, 4), (2, 2)])
def test_dit_put_bytes_equal_the_comm_model(strategy, shape):
    """The puts of one DiT layer under SP over (pod, model), per rank,
    against core/comm_model.py's volumes for the layout's plan.  The
    model's "per GPU" volumes are per machine (its BLHD/N is a machine's
    share): a rank moves 1/M of them.  swift_torus runs one intra-pod
    ring per stage over a head slice (Algorithm 1), 2·P_u - 1 of them,
    so its ring leg is (2·P_u - 1)/P_u of the model's one circulation."""
    cfg = dataclasses.replace(get_reduced("flux-12b"), n_layers=1)
    n, m = shape
    mesh = make_mesh(shape, ("pod", "model"), "meta")
    sp = SPConfig(strategy=strategy, sp_axes=("pod", "model"),
                  batch_axes=None)
    fn, args, _ = dr.build_step(cfg, InputShape("t", 64, 1, "prefill"),
                                mesh, sp)
    c = dr.count_step(fn, args, mesh)
    layout = resolve_layout(sp, mesh, cfg.n_heads, cfg.n_kv_heads)
    plan = t_cm.SPPlan(n_machines=n, m_per_machine=m,
                       p_ulysses=layout.p_ulysses, p_ring=layout.p_ring,
                       ulysses_inter=layout.ulysses_outer)
    blhd = (64 + t_dit.COND_TOKENS) * cfg.n_heads * cfg.resolved_head_dim
    legs = t_cm.a2a_leg_volumes(plan, blhd, swift=True)
    ring = t_cm.ring_leg_volumes(plan, blhd, swift=True)
    circ = (2 * plan.p_ulysses - 1) / plan.p_ulysses \
        if strategy == "swift_torus" else 1.0
    per_rank = lambda elems: elems * 2 / m  # bf16
    inter = c.put_inter / mesh.size
    intra = (c.put_bytes - c.put_inter) / mesh.size
    assert inter == per_rank(t_cm.swift_inter_volume(plan, blhd))
    assert intra == pytest.approx(per_rank(
        legs["a2a_intra"] + circ * ring["ring_intra"]), rel=1e-12)
    if strategy == "swift" or plan.p_ring == 1:
        assert intra == per_rank(t_cm.intra_volume(plan, blhd, swift=True))


def test_counts_are_linear_in_depth():
    base = get_reduced("qwen2-1.5b")
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    shape = InputShape("t", 32, 2, "training")
    counts = [_count(dr._depth_variant(base, n), shape, mesh)[0]
              for n in (0, 1, 2, 3)]
    for key in ("flops", "bytes", "put_bytes"):
        v = [getattr(c, key) for c in counts]
        assert v[1] > v[0] and v[2] - v[1] == v[1] - v[0] == v[3] - v[2], key


def test_lower_pair_extrapolates_what_it_would_count_directly():
    cfg = dataclasses.replace(get_reduced("qwen2-1.5b"), n_layers=4)
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    shape = InputShape("t", 32, 2, "training")
    kw = dict(cfg=cfg, shape=shape)
    direct = dr.lower_pair("qwen2-1.5b", "t", mesh, "swift_torus", **kw)
    ext = dr.lower_pair("qwen2-1.5b", "t", mesh, "swift_torus",
                        direct_s=0.0, **kw)
    assert direct["depth"] == "direct"
    assert ext["depth"] == "extrapolated from 0 and 1 layers"
    assert direct["cost"] == ext["cost"]
    for k in ("flops_per_device", "collective_bytes", "bottleneck"):
        assert direct["roofline"][k] == ext["roofline"][k]
    assert direct["memory"]["temp_bytes"] > 0
    assert ext["memory"]["temp_bytes"] is None and ext["notes"]
    assert direct["memory"]["argument_bytes"] == \
        ext["memory"]["argument_bytes"]
    assert direct["cost"]["flops"] == _dense_flops(cfg, 2, 32, True) / 4
    assert direct["roofline"]["model_flops"] == dr.model_flops(cfg, shape)


def test_dryrun_cli_reports_what_cannot_run(tmp_path, capsys, monkeypatch):
    """A pair that raises prints FAIL with its reason, and the summary
    counts it (a pair made to fail: every family now counts)."""
    def refuse(arch, *args, **kw):
        raise NotImplementedError(f"{arch} cannot be counted")

    monkeypatch.setattr(dr, "lower_pair", refuse)
    rc = dr.main(["--arch", "rwkv6-1.6b", "--shape", "train_4k",
                  "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert ("FAIL rwkv6-1.6b_train_4k_pod_swift_torus: NotImplementedError: "
            "rwkv6-1.6b cannot be counted" in out)
    assert "dry-run complete: 0 ok, 1 failed" in out


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "qwen2-moe-a2.7b"])
def test_training_pairs_of_the_state_families_count(arch):
    """A training pair of the families that once could not train over a
    mesh counts on a small one: FLOPs, bytes and put bytes (the token
    shifts and state passes of rwkv6, the expert exchange of the MoE at
    EP 2) per rank, directly and as the two-point extrapolation (the
    FLOPs and put bytes linear in depth)."""
    cfg = dataclasses.replace(get_reduced(arch), n_layers=2)
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    shape = InputShape("t", 32, 2, "training")
    res = dr.lower_pair(arch, "t", mesh, "swift_torus", cfg=cfg, shape=shape)
    ext = dr.lower_pair(arch, "t", mesh, "swift_torus", cfg=cfg, shape=shape,
                        direct_s=0.0)
    assert res["depth"] == "direct"
    assert res["cost"]["flops"] > 0 and res["cost"]["bytes accessed"] > 0
    assert res["roofline"]["collective_bytes"] > 0
    assert ext["cost"]["flops"] == res["cost"]["flops"]
    assert (ext["roofline"]["collective_bytes"]
            == res["roofline"]["collective_bytes"])
    # a few hundred bytes of per-step terms do not scale with depth
    assert abs(ext["cost"]["bytes accessed"] / res["cost"]["bytes accessed"]
               - 1) < 1e-4
