"""The port's four examples (``src/repro_torch/examples``), each run through
its ``main`` on the CPU at a shrunk config."""
import dataclasses
import math

import pytest
import torch

from repro_torch.examples import generate_text, quickstart, serve_dit, train_lm


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: one intra-op thread each under the run's workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_quickstart_every_strategy_matches_the_oracle(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert set(out["errors"]) == set(quickstart.STRATEGIES)
    for strategy, err in out["errors"].items():
        assert err <= 1e-4 * out["max_ref"], strategy
    assert out["plans"] == {"qwen2-1.5b": (2, 16), "arctic-480b": (8, 4),
                            "flux-12b": (8, 4)}
    text = capsys.readouterr().out
    assert "swift_torus  max|Δ| vs oracle" in text and "P_r=16" in text


def test_serve_dit_serves_both_parts(monkeypatch, capsys):
    base = serve_dit.model_config
    monkeypatch.setattr(serve_dit, "model_config", lambda: dataclasses.replace(
        base(), d_model=128, head_dim=16, d_ff=256))
    out = serve_dit.main(["--device", "cpu"])
    assert sorted(out["results"]) == [0, 1, 2, 3, 4, 5, 100, 101, 200, 201]
    assert all(out["finite"].values()) and len(out["finite"]) == 10
    for rid, r in out["results"].items():
        assert r.latents.shape == (
            serve_dit.SIZES[rid % 3] if rid < 6 else
            256 if rid < 200 else 64, 64)
    assert out["preemptions"] >= 1 and out["refits"] >= 1
    text = capsys.readouterr().out
    assert "hybrid plan: cfg=2 pp=2" in text and "control loop:" in text


def test_generate_text_serves_every_prompt(monkeypatch, capsys):
    base = generate_text.model_config
    monkeypatch.setattr(generate_text, "model_config",
                        lambda: dataclasses.replace(base(), n_layers=1))
    out = generate_text.main(["--device", "cpu"])
    tokens = out["tokens"]
    assert sorted(tokens) == sorted(generate_text.PROMPTS)
    assert all(len(t) == generate_text.NEW_TOKENS for t in tokens.values())
    vocab = generate_text.model_config().vocab
    assert all(0 <= x < vocab for t in tokens.values() for x in t)
    assert "KV cache sequence-sharded over (pod × model) = 4 ways" in \
        capsys.readouterr().out


def test_train_lm_takes_steps(monkeypatch, capsys):
    base = train_lm.model_config
    monkeypatch.setattr(train_lm, "model_config", lambda: dataclasses.replace(
        base(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512))
    out = train_lm.main(["--device", "cpu", "--steps", "3", "--seq", "32",
                         "--batch", "2", "--log-every", "1"])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 3 and all(map(math.isfinite, losses))
    assert len(out["step_seconds"]) == 3
    assert "loss " in capsys.readouterr().out
