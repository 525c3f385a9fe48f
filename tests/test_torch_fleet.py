"""The port's fleet tier (``repro_torch/serving/fleet.py``, a verbatim copy
pinned in tests/test_torch_copies.py) and its CLI
(``repro_torch/launch/fleet.py``).

Every case of tests/test_fleet.py runs here against the port: its source is
compiled with the reference's imports pointed at ``repro_torch`` and its
test functions are collected from this module.  Beyond those, both
packages' ``run_fleet`` give equal stats for every policy, with and
without an injected failure or drain, on replicas built by hand from one
``NetworkModel``'s fields (``Replica.sim`` builds its plan cache with each
package's own nominal model: TPU terms in the reference, H100 terms in the
port)."""
import dataclasses
import json
import pathlib

import pytest

from repro.core import comm_model as j_cm
from repro.serving import fleet as j_fleet
from repro.serving import metrics as j_met
from repro.serving import sched as j_sched
from repro_torch.core import comm_model as t_cm
from repro_torch.launch import fleet as t_cli
from repro_torch.serving import fleet as t_fleet
from repro_torch.serving import metrics as t_met
from repro_torch.serving import sched as t_sched

TESTS = pathlib.Path(__file__).resolve().parent
_REF_TESTS = TESTS / "test_fleet.py"


def _port_cases() -> dict:
    src = _REF_TESTS.read_text()
    for mod in ("fleet", "metrics"):
        old = f"from repro.serving.{mod} import"
        assert src.count(old) == 1, old
        src = src.replace(old, f"from repro_torch.serving.{mod} import")
    assert "repro." not in src.replace("repro_torch.", "")
    ns = {"__name__": __name__, "__file__": str(_REF_TESTS)}
    exec(compile(src, str(_REF_TESTS), "exec"), ns)
    return {k: v for k, v in ns.items() if k.startswith("test_")}


_CASES = _port_cases()
globals().update(_CASES)


def test_every_reference_case_runs_on_the_port():
    import test_fleet

    ref = {k for k in vars(test_fleet) if k.startswith("test_")}
    assert ref and ref == set(_CASES)
    assert test_fleet.FleetRouter is j_fleet.FleetRouter
    assert _CASES["test_run_fleet_is_deterministic"].__globals__[
        "FleetRouter"] is t_fleet.FleetRouter


def _replicas(fleet, sched, met, cm, fields, n=2):
    """``Replica.sim``'s stack on the paper testbed flavour, with the plan
    cache's NetworkModel built from ``fields``."""
    reps = []
    for k in range(n):
        tracker = met.RecordingTracker()
        cache = sched.PlanCache(n_machines=2, m_per_machine=4, heads=24,
                                head_dim=64, n_layers=42, num_steps=20, dp=2,
                                net=cm.NetworkModel(**fields),
                                tracker=tracker)
        cfg = sched.SchedConfig(max_batch=4, dp=2, starvation_age=1.0,
                                default_slack=10.0, defer_slack=0.02)
        fc = sched.ArrivalForecaster(idle_age=2.0, tracker=tracker)
        reps.append(fleet.Replica(f"r{k}", sched.RequestScheduler(
            cache, cfg, forecaster=fc, tracker=tracker)))
    return reps


def _run(fleet, sched, met, cm, fields, policy, event):
    reqs = [fleet.FleetRequest(**dataclasses.asdict(r))
            for r in t_cli.default_stream(120, 7)]
    router = fleet.FleetRouter(_replicas(fleet, sched, met, cm, fields),
                               policy=policy)
    failure = (fleet.FailureEvent(at=0.35, rid="r0", kind=event,
                                  revive_after=0.25) if event else None)
    stats = fleet.run_fleet(reqs, router, failure=failure)
    assert stats["served"] == 120
    return stats


@pytest.mark.parametrize("event", [None, "fail", "drain"])
@pytest.mark.parametrize("policy", list(t_fleet.POLICIES))
def test_run_fleet_equals_reference(policy, event):
    assert t_fleet.POLICIES == j_fleet.POLICIES
    fields = dataclasses.asdict(t_cm.NetworkModel())  # H100 terms, to both
    mine = _run(t_fleet, t_sched, t_met, t_cm, fields, policy, event)
    ref = _run(j_fleet, j_sched, j_met, j_cm, fields, policy, event)
    assert mine == ref


def test_fleet_cli_traces_validate(tmp_path, capsys):
    t_cli.main(["--replicas", "2", "--policy", "sla", "--fail", "r0@0.35",
                "--trace-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "fleet: 2 replicas, policy=sla, 120 requests, fail=r0@0.35" in out
    assert "  served         120" in out.splitlines()
    files = sorted(tmp_path.glob("*.jsonl"))
    assert [f.name for f in files] == ["replica-r0.jsonl", "replica-r1.jsonl",
                                       "router.jsonl"]
    n = 0
    for f in files:
        for line in f.read_text().splitlines():
            assert t_met.validate_record(json.loads(line)) == [], (f, line)
            n += 1
        assert t_met.read_jsonl(f)  # round-trips
    assert n > 100
