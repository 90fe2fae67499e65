"""Port parity of the aggregation bench (``benchmarks/agg_bench.py`` and
``repro_torch.benchmarks.agg_bench``): the same client trees from numpy
``default_rng(0)``, the port's four routes (loop / batched × ``svd`` /
``gram``) agreeing with each other and with the reference's FLoRIST
aggregator (kept ranks equal, every layer's B·A within 1e-5 of max |ΔW|,
ΔW the fp64 sum Σ w_k B_k A_k), and the report's keys equal to the
reference's, config keys included."""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks import agg_bench as jbench  # noqa: E402
from repro.core.aggregators import make_aggregator as jmake  # noqa: E402
from repro_torch.benchmarks import agg_bench as tbench  # noqa: E402
from repro_torch.core.aggregators import make_aggregator  # noqa: E402

SHAPE = dict(layers=3, leaves=3, m=64, n=48)     # the smoke shape, 3 layers


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs files on parallel workers,
    and a full torch thread pool on each of them oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _product(res, name):
    leaf = res.global_adapters[name]
    return np.asarray(torch.as_tensor(leaf["B"]).double()
                      @ torch.as_tensor(leaf["A"]).double())


def test_clients_are_the_reference_s():
    ours = tbench.make_clients(np.random.default_rng(0), **SHAPE)
    ref = jbench.make_clients(np.random.default_rng(0), **SHAPE)
    assert ours[1] == ref[1]
    for t, jt in zip(ours[0], ref[0]):
        for name in jt:
            for k in ("A", "B", "scale"):
                np.testing.assert_array_equal(t[name][k], jt[name][k])


def test_routes_agree_with_each_other_and_the_reference():
    trees, w = tbench.make_clients(np.random.default_rng(0), **SHAPE)
    paths = sorted(trees[0])
    dw = {p: sum(wk * t[p]["B"].astype(np.float64) @ t[p]["A"].astype(np.float64)
                 for wk, t in zip(w, trees)) for p in paths}
    jagg = jmake("florist", tau=0.9)
    jres = jagg.aggregate(trees, w)
    jprod = {p: np.asarray(jres.global_adapters[p]["B"], np.float64)
             @ np.asarray(jres.global_adapters[p]["A"], np.float64) for p in paths}
    arriving = tbench.arriving(trees, torch.device("cpu"))
    for pipeline, svd_method in tbench.ROUTES:
        agg = make_aggregator("florist", tau=0.9, svd_method=svd_method,
                              pipeline=pipeline)
        agg.begin_round()
        for t, wk in zip(arriving, w):
            agg.add_client(t, wk)
        res = agg.finalize()
        route = (pipeline, svd_method)
        assert res.ranks == {(p,): [int(x) for x in jres.ranks[(p,)]]
                             for p in paths}, route
        for p in paths:
            err = np.abs(_product(res, p) - jprod[p]).max()
            assert err <= 1e-5 * np.abs(dw[p]).max(), (route, p, err)


def test_report_keys_are_the_reference_s(tmp_path, monkeypatch, capsys):
    ours = tbench.main(["--smoke", "--layers", "1", "--iters", "1",
                        "--device", "cpu", "--json", str(tmp_path / "t.json")])
    assert json.loads((tmp_path / "t.json").read_text()) == ours
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == ours
    monkeypatch.setattr(sys, "argv", ["agg_bench.py", "--smoke", "--layers", "1",
                                      "--iters", "1", "--json",
                                      str(tmp_path / "j.json")])
    jbench.main()
    ref = json.loads((tmp_path / "j.json").read_text())
    assert set(ours) == set(ref)
    assert set(ours["config"]) == set(ref["config"])
    assert {k: v for k, v in ours["config"].items() if k != "backend"} == \
        {k: v for k, v in ref["config"].items() if k != "backend"}
    assert ours["config"]["backend"] == "cpu" == jax.default_backend()
    assert [set(r) for r in ours["results"]] == [set(r) for r in ref["results"]]
    assert [(r["pipeline"], r["svd_method"]) for r in ours["results"]] == \
        [(r["pipeline"], r["svd_method"]) for r in ref["results"]]
    assert all(r["ms_per_round"] > 0 for r in ours["results"])
