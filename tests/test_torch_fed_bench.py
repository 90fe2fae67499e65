"""The federated runtime's entry points on the CPU: ``launch/fed.py``'s
runtime flags (runner, scheduler, participation, rank policy, DP, gate,
faults, a crash and ``--checkpoint``/``--resume``), ``fed_bench``'s three
arms at smoke size, and ``federated_finetune``'s tiny profile; the
multi-device names raise naming ``ROADMAP.md`` Queue 1 item 9."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import fed_bench  # noqa: E402
from repro_torch.core.runtime import ServerCrash  # noqa: E402
from repro_torch.examples import federated_finetune  # noqa: E402
from repro_torch.launch import fed as tfed  # noqa: E402

SMALL = ["--device", "cpu", "--clients", "8", "--sample", "3", "--layers",
         "1", "--d-model", "32", "--local-steps", "1"]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test (the suite runs files on parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flags", [
    ["--runner", "cohort", "--scheduler", "partial"],
    ["--runner", "cohort", "--scheduler", "async", "--codec", "int8"],
    ["--participation", "0.5", "--rank-policy", "resource", "--heter"],
    ["--dp-clip", "1.0", "--dp-epsilon", "8", "--validation", "full",
     "--min-clients", "2"],
    ["--fault-drop", "0.2", "--fault-corrupt", "0.2", "--fault-duplicate",
     "0.2", "--fault-nan", "0.1", "--fault-scale", "0.1", "--fault-slow",
     "0.1", "--runner", "cohort"],
])
def test_launcher_runtime_flags(flags, tmp_path):
    out = tmp_path / "hist.json"
    hist = tfed.main(SMALL + ["--rounds", "2", "--out", str(out)] + flags)
    assert len(hist) == 2
    assert [r["round"] for r in json.loads(out.read_text())] == [0, 1]


def test_launcher_checkpoint_crash_and_resume(tmp_path):
    ck = str(tmp_path / "fed.ckpt")
    full = tfed.main(SMALL + ["--rounds", "3", "--runner", "cohort"])
    with pytest.raises(ServerCrash):
        tfed.main(SMALL + ["--rounds", "3", "--runner", "cohort",
                           "--crash-at", "1:mid_round", "--checkpoint", ck])
    hist = tfed.main(SMALL + ["--rounds", "3", "--runner", "cohort",
                              "--checkpoint", ck, "--resume"])

    def strip(r):
        d = dataclasses.asdict(r)
        for k in ("wall_secs", "finalize_secs", "sim_secs", "resumes"):
            d.pop(k)
        return d

    assert [strip(r) for r in hist] == [strip(r) for r in full]
    assert [r.resumes for r in hist] == [0, 1, 0]


def test_launcher_refuses_sharded_cohort():
    """Ported since the multi-device slice: ``--runner sharded_cohort``
    with ``--method florist_sharded`` runs, in one process (a one-rank
    mesh) and on a gloo world of 2, and gives the cohort runner's FLoRIST
    round."""
    sharded = SMALL + ["--rounds", "1", "--runner", "sharded_cohort",
                       "--method", "florist_sharded"]
    want = tfed.main(SMALL + ["--rounds", "1", "--runner", "cohort"])
    for got in (tfed.main(sharded), tfed.main(sharded + ["--world", "2"])):
        assert got[0].eval_loss == pytest.approx(want[0].eval_loss, abs=1e-5)
        assert got[0].upload_bytes == want[0].upload_bytes
        assert got[0].download_rank == want[0].download_rank


def test_fed_bench_runner_arm_and_dp_curve(tmp_path):
    out = tmp_path / "fed.json"
    rep = fed_bench.main(["--smoke", "--device", "cpu", "--iters", "1",
                          "--clients", "8", "--sample", "4", "--local-steps",
                          "2", "--json", str(out)])
    assert {(r["runner"], r["scheduler"]) for r in rep["results"]} == {
        (a, b) for a in ("sequential", "cohort") for b in ("sync", "async")}
    assert rep["speedup_cohort_vs_sequential"] > 0
    assert [p["epsilon"] for p in rep["dp_axis"]["curve"]] == [None, 8.0, 2.0, 0.5]
    assert json.loads(out.read_text())["config"]["backend"] == "cpu"


def test_fed_bench_faults_arm():
    rep = fed_bench.main(["--faults", "--device", "cpu", "--iters", "1",
                          "--clients", "8", "--sample", "4", "--local-steps",
                          "2"])
    assert {r["arm"] for r in rep["results"]} == {"off", "hardened"}
    assert rep["poison_caught"] <= rep["poison_injected"] or \
        rep["poison_injected"] == 0
    assert 0.0 <= rep["poison_quarantine_recall"] <= 1.0


def test_fed_bench_scale_arm_reports_sharded_as_skipped():
    """The scale arm's ``sharded_cohort`` rows are real since the
    multi-device slice: a one-rank mesh here and a gloo world of 2."""
    rep = fed_bench.scale_axis(torch.device("cpu"), 1, lambda *_: None,
                               clients=48, participants=6, world_size=2)
    rows = [(r["runner"], r.get("world", 1)) for r in rep["results"]]
    assert rows == [("sequential", 1), ("cohort", 1), ("sharded_cohort", 1),
                    ("sharded_cohort", 2)]
    assert all(r["ms_per_round"] > 0 for r in rep["results"])
    assert [r["peak_live_clients"] for r in rep["results"][2:]] == [8, 8]
    assert rep["results"][3]["backend"] == "gloo"
    assert rep["peak_live_clients"] == 8


def test_federated_finetune_tiny_profile(tmp_path):
    ck = str(tmp_path / "ft.ckpt")
    tr = federated_finetune.main(["--device", "cpu", "--rounds", "2",
                                  "--local-steps", "1", "--runner", "cohort",
                                  "--heter", "--codec", "bf16",
                                  "--checkpoint", ck])
    assert len(tr.history) == 2 and tr.history[-1].upload_bytes > 0
    again = federated_finetune.main(["--device", "cpu", "--rounds", "2",
                                     "--local-steps", "1", "--runner",
                                     "cohort", "--heter", "--codec", "bf16",
                                     "--checkpoint", ck, "--resume"])
    assert [r.eval_loss for r in again.history] == \
        [r.eval_loss for r in tr.history]


@pytest.mark.parametrize("flags", [["--runner", "sharded_cohort"],
                                   ["--method", "florist_sharded"]])
def test_federated_finetune_refuses_multi_device(flags):
    """Both flags run since the multi-device slice, on a gloo world of 2
    and in one process, to the cohort / florist run's losses."""
    base = ["--device", "cpu", "--rounds", "1", "--local-steps", "1"]
    want = federated_finetune.main(base + ["--runner", "cohort"])
    one = federated_finetune.main(base + flags)
    two = federated_finetune.main(base + flags + ["--world", "2"])
    for got in (one, two):
        assert got.history[0].eval_loss == pytest.approx(
            want.history[0].eval_loss, abs=2e-4)
    r0, r1 = two.ranks_by_rank[0], two.ranks_by_rank[1]
    assert r0["ranks"] == r1["ranks"] == one.global_state.ranks
    assert [(h.eval_loss, h.upload_bytes) for h in r0["history"]] == \
        [(h.eval_loss, h.upload_bytes) for h in r1["history"]]
