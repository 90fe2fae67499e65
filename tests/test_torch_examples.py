"""The port's examples and bench harness on the CPU at small flags
(``repro_torch.examples.quickstart`` / ``threshold_sweep`` /
``serve_federated``, ``repro_torch.benchmarks.run``), and the engine on
``decode_impl="streamed"``.

``serve_federated`` must serve every request, and after the first swap
both adapter versions must be in flight in one batch, on every
``--decode-impl``; ``threshold_sweep``'s kept ranks stay within Σ r_k;
``quickstart`` prints the kept ranks of every layer.  ``--mesh`` raises
``NotImplementedError`` naming its ``ROADMAP.md`` item; an unknown
``decode_impl`` or ``--only`` tag raises ``ValueError``; the harness runs
``kernels`` like every other module and reports a module that fails
without stopping the others.
"""
import sys
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.llama3p2_1b import SMOKE  # noqa: E402
from repro_torch.examples import quickstart, serve_federated, threshold_sweep  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs files on parallel workers,
    and a full torch thread pool on each of them oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_prints_ranks_a_layer(capsys):
    tr = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(tr.history) == quickstart.ROUNDS
    for path, ranks in tr.global_state.ranks.items():
        assert len(ranks) == tr.cfg.num_layers
        assert all(1 <= r <= 4 * 8 for r in ranks)
        assert f"  {'/'.join(map(str, path))}: {ranks}" in out
    assert "measured on the wire" in out


def test_threshold_sweep_ranks_within_the_stack():
    out = threshold_sweep.main(["--device", "cpu", "--rounds", "1",
                                "--taus", "0.7,0.99"])
    totals = []
    for tau, tr in out:
        r_sum = sum(tr.aggregator.client_ranks)
        ranks = [p for ps in tr.global_state.ranks.values() for p in ps]
        assert r_sum == 5 * 8 and all(1 <= p <= r_sum for p in ranks)
        assert tr.history[-1].global_rank_total == sum(ranks) <= r_sum * len(ranks)
        totals.append(sum(ranks))
    assert totals[0] <= totals[1]                # τ 0.7 keeps no more than 0.99


@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_serve_federated_serves_every_request_across_a_swap(impl, capsys):
    out = serve_federated.main(["--device", "cpu", "--decode-impl", impl])
    rounds, per_round = 2, 2
    assert len(out["outputs"]) == rounds * per_round
    assert all(len(t) == 12 for t in out["outputs"].values())
    assert sorted(set(out["served_by"].values())) == [1, 2]
    assert out["in_flight"][0] == [1] and out["in_flight"][1] == [1, 2]
    assert out["launches"] == {"ring_decode": 0, "bgmv": 0}   # CPU: plain
    assert "serving-kernel launches per engine step" in \
        capsys.readouterr().out.splitlines()[-1]


def test_serve_federated_refuses_streamed_and_mesh(capsys):
    """``--decode-impl streamed`` serves; ``--mesh 2`` serves too since the
    multi-device slice (a gloo world of 2 on the CPU), every rank emitting
    the mesh-less engine's tokens; a mesh that does not divide the heads
    raises."""
    out = serve_federated.main(["--device", "cpu", "--decode-impl", "streamed"])
    assert len(out["outputs"]) == 4
    assert all(len(t) == 12 for t in out["outputs"].values())
    assert out["in_flight"][1] == [1, 2]
    assert out["engine"].decode_impl == "streamed"
    mesh = serve_federated.main(["--device", "cpu", "--mesh", "2",
                                 "--decode-impl", "streamed"])
    assert mesh["ranks_agree"] and mesh["outputs"] == out["outputs"]
    assert mesh["in_flight"] == out["in_flight"]
    assert mesh["all_reduces"] > 0 and "engine" not in mesh
    with pytest.raises(Exception, match="does not divide"):
        serve_federated.main(["--device", "cpu", "--mesh", "3"])


def test_engine_streamed_raises_naming_its_slice():
    """The engine takes ``decode_impl="streamed"`` and gives
    the dense route's greedy tokens; an unknown impl raises."""
    cfg = SMOKE.replace(num_layers=1, vocab_size=64)
    params = T.init(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="unknown decode_impl"):
        ServeEngine(cfg, params, decode_impl="ring", device="cpu")
    toks = {}
    for impl in ("dense", "kernel", "streamed"):
        eng = ServeEngine(cfg, params, decode_impl=impl, device="cpu")
        eng.submit([1, 2, 3])
        toks[impl] = eng.run()[1]
        assert len(toks[impl]) == 32
    assert toks["streamed"] == toks["dense"] == toks["kernel"]


def test_harness_prints_reference_rows_and_refuses_kernels(monkeypatch, capsys):
    """Rows of a figure module; ``--only kernels`` runs the kernel bench's
    module (a stub here, ``test_torch_kernel_bench.py`` runs
    the real one); an unknown tag is refused."""
    from repro_torch.benchmarks import run
    run.main(["--only", "fig6", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert sorted(ln.split(",")[0] for ln in lines[1:]) == [
        "fig6/summary", "fig6/wk", "fig6/wo", "fig6/wq", "fig6/wv"]
    assert all(ln.count(",") >= 2 for ln in lines[1:])
    assert dict(run.MODULES)["kernels"] == "repro_torch.benchmarks.kernel_bench"
    fake = types.ModuleType("fake_kernels")
    fake.run = lambda device=None: [{"name": f"kernel/x/{device}", "derived": "y"}]
    monkeypatch.setitem(sys.modules, "fake_kernels", fake)
    monkeypatch.setattr(run, "MODULES", [("kernels", "fake_kernels")])
    run.main(["--only", "kernels", "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[1] == "kernel/x/cpu,,y"
    with pytest.raises(ValueError, match="kernels"):
        run.main(["--only", "kernelz", "--device", "cpu"])


def test_harness_skips_kernels_without_failing(monkeypatch, capsys):
    """A module that raises is reported on stderr and in the exit status;
    the modules after it still run."""
    from repro_torch.benchmarks import run
    bad = types.ModuleType("bad_bench")

    def boom(device=None):
        raise RuntimeError("no card")

    bad.run = boom
    fake = types.ModuleType("fake_bench")
    fake.run = lambda device=None: [{"name": f"fake/{device}", "derived": "x"}]
    monkeypatch.setitem(sys.modules, "bad_bench", bad)
    monkeypatch.setitem(sys.modules, "fake_bench", fake)
    monkeypatch.setattr(run, "MODULES", [("kernels", "bad_bench"),
                                         ("fake", "fake_bench")])
    with pytest.raises(SystemExit) as exc:
        run.main(["--device", "cpu"])
    out = capsys.readouterr()
    assert exc.value.code == 1
    assert out.out.splitlines() == ["name,us_per_call,derived", "fake/cpu,,x"]
    assert "FAILED benchmarks: ['kernels']" in out.err and "no card" in out.err
