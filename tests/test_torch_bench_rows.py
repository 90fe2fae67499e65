"""Row parity of the paper-table and figure modules: each module's ``run()``
in both packages (``benchmarks/table2_accuracy_efficiency.py``,
``fig2_spectrum.py``, ``fig5_rank_vs_tau.py``, ``fig6_layerwise_rank.py``,
``fig7_tau_vs_quality.py`` and their ``repro_torch.benchmarks``
counterparts), with both packages' ``bench_fed`` replaced by one stub that
returns a fixed history and global state built from numpy.  The rows must
be identical, name for name and string for string.

Two stubs: "ordered" (FLoRIST the most download-efficient, total rank
rising with τ) and "shuffled" (a baseline wins, the rank falls somewhere
along τ), so both values of ``most_efficient``'s ``florist_wins`` and of
``monotone_nondecreasing`` are held; ``best_tau`` falls on a number and on
``"auto"``.  The stub also records the keywords each module passed, which
must be the reference's.
"""
import importlib
import types
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

MODULES = ("table2_accuracy_efficiency", "fig2_spectrum", "fig5_rank_vs_tau",
           "fig6_layerwise_rank", "fig7_tau_vs_quality")
PATHS = [("blocks", 0, "attn", p) for p in ("wq", "wk", "wv", "wo")]
TAUS = (0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 1.0, "auto")
LAYERS = 4


def make_stub(kind, calls):
    """A ``bench_fed`` that returns ``(history, trainer)`` from numpy, seeded
    by its arguments; ``calls`` collects the keywords."""
    def bench_fed(method, **kw):
        calls.append((method, kw))
        heter = kw.get("heterogeneous", False)
        tau = kw.get("tau", 0.9)
        seed = zlib.crc32(f"{kind}/{method}/{heter}/{tau}".encode())
        rng = np.random.default_rng(seed)
        if kind == "ordered":
            rank = 10 + 10 * TAUS.index(tau)
            down = 5.0 if method == "florist" else 50.0 + 10 * rng.random()
            acc = 0.5 if tau == 0.9 else 0.1 * rng.random()
        else:
            rank = int(rng.integers(1, 200))
            down = 5.0 if method == "flora" else 50.0 + 10 * rng.random()
            acc = 0.9 if tau == "auto" else 0.1 * rng.random()
        hist = [types.SimpleNamespace(
            eval_loss=float(5 + rng.random()), eval_acc=float(acc),
            download_rank=float(down), global_rank_total=int(rank))
            for _ in range(kw.get("rounds", 1) or 1)]
        stack = 40 if heter else 24
        ranks = {p: [int(x) for x in rng.integers(1, stack + 1, LAYERS)]
                 for p in PATHS}
        spectra = {p: [np.sort(rng.gamma(0.5, size=stack)).astype(
            np.float32)[::-1] * 10.0 ** -rng.integers(0, 4)
                       for _ in range(LAYERS)] for p in PATHS}
        gs = types.SimpleNamespace(ranks=ranks, spectra=spectra)
        return hist, types.SimpleNamespace(global_state=gs)
    return bench_fed


def rows_of(package, name, kind, monkeypatch):
    mod = importlib.import_module(f"{package}.{name}")
    calls = []
    monkeypatch.setattr(mod, "bench_fed", make_stub(kind, calls))
    return mod.run(), calls


@pytest.mark.parametrize("kind", ["ordered", "shuffled"])
@pytest.mark.parametrize("name", MODULES)
def test_module_rows_match_reference(name, kind, monkeypatch):
    ref, ref_calls = rows_of("benchmarks", name, kind, monkeypatch)
    ours, calls = rows_of("repro_torch.benchmarks", name, kind, monkeypatch)
    assert [r["name"] for r in ours] == [r["name"] for r in ref]
    assert ours == ref
    assert calls == ref_calls
    flags = " ".join(r["derived"] for r in ours)
    if name == "table2_accuracy_efficiency":
        assert f"florist_wins={kind == 'ordered'}" in flags
        assert len(ours) == 12
    if name == "fig5_rank_vs_tau":
        assert ours[-1]["derived"] == str(kind == "ordered")
    if name == "fig7_tau_vs_quality":
        assert ours[-1]["derived"] == ("0.9" if kind == "ordered" else "auto")


def test_table2_takes_its_arms_and_passes_bench_keywords(monkeypatch):
    from repro_torch.benchmarks import table2_accuracy_efficiency as t2
    calls = []
    monkeypatch.setattr(t2, "bench_fed", make_stub("ordered", calls))
    rows = t2.run(arms=(True,), rounds=2, device="cpu", batch_size=4)
    assert [r["name"] for r in rows] == [
        f"table2/heter/{m}" for m in t2.METHODS] + ["table2/heter/most_efficient"]
    assert calls == [(m, dict(heterogeneous=True, rounds=2, device="cpu",
                              batch_size=4)) for m in t2.METHODS]


def test_timeit_returns_the_median_of_its_timed_calls():
    from repro_torch.benchmarks.common import timeit
    calls = []
    us = timeit(lambda x: calls.append(x), 7, warmup=2, iters=5)
    assert calls == [7] * 7 and 0 < us < 1e6
