"""The port's serving launcher (src/repro_torch/launch/serve.py) in
process on the CPU, at the reduced configs: its printed request and
scheduler lines, the metrics JSONL it writes, and the AR branch.  The
reference's launcher prints the same lines (src/repro/launch/serve.py)."""
import re

import pytest

from repro_torch.launch import serve
from repro_torch.serving.metrics import read_jsonl


def test_serve_dit_mixed_queue_with_metrics(tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    assert serve.main(["--arch", "flux-12b", "--reduced", "--device", "cpu",
                       "--mixed", "--steps", "2", "--requests", "4",
                       "--metrics", str(path)]) == 0
    out = capsys.readouterr().out
    reqs = re.findall(r"^request (\d+): latents \((\d+), 64\) latency", out,
                      re.M)
    # --seq 64 cycled as (seq, seq / 2, 2 seq)
    assert [(int(r), int(n)) for r, n in reqs] == [(0, 64), (1, 32),
                                                    (2, 128), (3, 64)]
    sched = re.search(r"^scheduler: (\d+) batches over (\d+) bucket shapes "
                      r"\((\d+) traces, (\d+) step-cache hits\)", out, re.M)
    assert sched is not None
    batches, shapes, traces, hits = map(int, sched.groups())
    assert shapes == 3 and traces + hits == batches
    assert "graphs: none captured (eager steps)" in out
    records = read_jsonl(path)
    names = {r.name for r in records}
    assert {"engine.request_done", "plan_cache.step_miss",
            "engine.t_step_s"} <= names
    assert sum(r.name == "engine.request_done" for r in records) == 4
    assert f"metrics: wrote {path}" in out


def test_serve_rwkv6_decode(capsys):
    assert serve.main(["--arch", "rwkv6-1.6b", "--reduced", "--device",
                       "cpu", "--requests", "3"]) == 0
    out = capsys.readouterr().out
    toks = re.findall(r"^request (\d+): -> \[([\d, ]+)\]$", out, re.M)
    assert [int(r) for r, _ in toks] == [0, 1, 2]
    assert all(len(t.split(",")) == 8 for _, t in toks)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen2-moe-a2.7b",
                                  "arctic-480b"])
@pytest.mark.parametrize("mesh", ["host", "pod"])
def test_serve_hybrid_and_moe_decode(capsys, arch, mesh):
    """The hybrid and MoE LMs serve through the AR branch, on one rank and
    on --mesh pod (KV caches over 16 ranks, experts over model 8)."""
    assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--mesh", mesh, "--seq", "32", "--requests", "3"]) == 0
    out = capsys.readouterr().out
    toks = re.findall(r"^request (\d+): -> \[([\d, ]+)\]$", out, re.M)
    assert [int(r) for r, _ in toks] == [0, 1, 2]
    assert all(len(t.split(",")) == 8 for _, t in toks)


def test_serve_pod_mesh_profiles_on_the_kernel_path(tmp_path, capsys):
    path = tmp_path / "p.jsonl"
    assert serve.main(["--arch", "flux-12b", "--reduced", "--device", "cpu",
                       "--mesh", "pod", "--seq", "32", "--steps", "2",
                       "--requests", "2", "--profile", str(path)]) == 0
    spans = [r for r in read_jsonl(path) if r.kind == "span"]
    legs = [r for r in spans if r.name == "comm.leg"]
    assert legs and all(r.tags["backend"] == "pallas" for r in legs)
    assert "trace_report" in capsys.readouterr().out


def test_serve_refuses_what_it_cannot_serve():
    with pytest.raises(NotImplementedError, match="ROADMAP F7"):
        serve.main(["--arch", "whisper-tiny", "--reduced", "--device",
                    "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "flux-12b", "--metrics", "a", "--profile", "b",
                    "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "rwkv6-1.6b", "--reduced", "--device", "cpu",
                    "--mesh", "pod"])


def test_serve_layers_cuts_depth(capsys, monkeypatch):
    """--layers N serves the config's first N layers at its widths."""
    seen = []
    real = serve.init_lm

    def spy(cfg, *args, **kw):
        seen.append((cfg.n_layers, cfg.d_model))
        return real(cfg, *args, **kw)

    monkeypatch.setattr(serve, "init_lm", spy)
    assert serve.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                       "cpu", "--requests", "2", "--layers", "1"]) == 0
    assert seen == [(1, 128)]
    assert "request 1: ->" in capsys.readouterr().out
