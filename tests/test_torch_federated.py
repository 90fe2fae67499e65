"""Port parity of the federated round: ``FloristAggregator`` (stacked and
delta streams), the measured transport, the trainer's round loop and the
``launch.fed`` entry point, against ``repro.core`` on the same inputs.

Client updates are drawn with numpy from a seed; the round test carries
the reference trainer's ``params`` and ``A_init_full`` into the port's
trainer (``repro_torch.convert``) and runs the same two rounds: the data,
the client sample and the batch schedule are numpy in both packages, so
they match bit for bit.  Kept ranks and byte counts are compared exactly,
spectra at 1e-5 relative to the largest singular value, ``B_g A_g``
products at 1e-5 relative, and the rounds' ``eval_loss`` within 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.common.config import FedConfig as JFedConfig  # noqa: E402
from repro.common.config import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.common.config import ModelConfig as JModelConfig  # noqa: E402
from repro.common.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.core.aggregators import AggResult as JAggResult  # noqa: E402
from repro.core.aggregators import FloristAggregator as JFlorist  # noqa: E402
from repro.core.federated import FederatedTrainer as JTrainer  # noqa: E402
from repro.core.runtime.transport import Transport as JTransport  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.peft import lora as jlora  # noqa: E402
from repro_torch.common.config import (FedConfig, LoRAConfig,  # noqa: E402
                                       ModelConfig, OptimConfig)
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core.aggregators import (AggResult, FloristAggregator,  # noqa: E402
                                          make_aggregator)
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.core.runtime import (Transport, ValidationGate,  # noqa: E402
                                      make_codec, make_runner, make_scheduler)
from repro_torch.core.runtime.schedulers import ClientTask  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import fed as tfed  # noqa: E402
from repro_torch.peft import lora as tlora  # noqa: E402

LEAVES = {"wq": (32, 32), "wk": (32, 16), "wo": (32, 32)}   # name: (n_in, m_out)
L = 2


def _client(rng, r, scale=2.0):
    """One client update in the reference layout (numpy leaves)."""
    return {"blocks": {0: {"attn": {name: {
        "A": (rng.normal(size=(L, r, n)) * 0.1).astype(np.float32),
        "B": (rng.normal(size=(L, m, r)) * 0.1).astype(np.float32),
        "scale": np.full((L,), scale, np.float32)}
        for name, (n, m) in LEAVES.items()}}}}


def _ours(tree):
    """The port's view of an arriving update: A/B as decoded numpy, the
    ``scale`` header as a tensor."""
    return {"blocks": {0: {"attn": {name: {
        "A": leaf["A"], "B": leaf["B"], "scale": torch.from_numpy(leaf["scale"])}
        for name, leaf in tree["blocks"][0]["attn"].items()}}}}


def _rel(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _check_agg(res, jres):
    assert set(res.ranks) == set(jres.ranks)
    for path, ranks in jres.ranks.items():
        assert res.ranks[path] == list(ranks), path
        for s, js in zip(res.spectra[path], jres.spectra[path]):
            _rel(s, js)
        leaf = res.global_adapters
        jleaf = jres.global_adapters
        for k in path:
            leaf, jleaf = leaf[k], jleaf[k]
        prod = torch.einsum("lmr,lrn->lmn", leaf["B"], leaf["A"]).numpy()
        _rel(prod, np.einsum("lmr,lrn->lmn", np.asarray(jleaf["B"]),
                             np.asarray(jleaf["A"])))
        np.testing.assert_array_equal(leaf["scale"].numpy(), np.ones(L))


@pytest.mark.parametrize("stream,flush,method", [
    ("stacked", 64, "svd"), ("stacked", 2, "gram"), ("delta", 64, "svd"),
    ("delta", 2, "gram"), ("auto", 2, "svd")])
def test_florist_aggregator_matches_reference(stream, flush, method):
    rng = np.random.default_rng(len(stream) + flush)
    ranks = (4, 8, 4, 16, 12)
    clients = [_client(rng, r, scale=8.0 / r) for r in ranks]
    w = rng.dirichlet(np.ones(len(ranks)))
    j = JFlorist(tau=0.9, svd_method=method, stream=stream, flush_every=flush)
    t = FloristAggregator(tau=0.9, svd_method=method, stream=stream,
                          flush_every=flush)
    jres = j.aggregate([jax.tree.map(jnp.asarray, c) for c in clients], w)
    res = t.aggregate([_ours(c) for c in clients], w)
    _check_agg(res, jres)
    assert t.round_upload_params == j.round_upload_params
    assert t.peak_pending_blocks == j.peak_pending_blocks
    # "auto" switches to the delta stream once Σr exceeds min(m, n) = 16
    assert (t._state[("blocks", 0, "attn", "wk")]["M"] is not None) == \
        (stream != "stacked")


def test_transport_bytes_match_reference():
    rng = np.random.default_rng(5)
    tree = _client(rng, 8)
    jtree = jax.tree.map(jnp.asarray, tree)
    jagg, agg = JFlorist(), FloristAggregator()
    jdec, jbytes = JTransport("fp32").client_to_server(jtree, jagg)
    dec, nbytes = Transport("fp32").client_to_server(_ours(tree), agg)
    assert nbytes == jbytes == sum(4 * (a["A"].size + a["B"].size)
                                   for a in tree["blocks"][0]["attn"].values())
    for name in LEAVES:
        for k in ("A", "B"):
            np.testing.assert_array_equal(dec["blocks"][0]["attn"][name][k],
                                          tree["blocks"][0]["attn"][name][k])
    # a downlink of ragged per-layer ranks: zero padding never travels
    ranks = {("blocks", 0, "attn", n): [3, 8] for n in LEAVES}
    jr = JAggResult("florist", jtree, None, ranks, {})
    r = AggResult("florist", adapters_from_numpy(tree, "cpu"), ranks, {})
    jdown, jb = JTransport("fp32").server_to_clients(jr, jagg, 3)
    down, b = Transport("fp32").server_to_clients(r, agg, 3)
    assert b == jb
    for name in LEAVES:
        for k in ("A", "B"):
            np.testing.assert_array_equal(down["blocks"][0]["attn"][name][k],
                                          np.asarray(jdown["blocks"][0]["attn"][name][k]))


def test_synthetic_data_is_bit_identical():
    jc = jsyn.make_federated_data(num_clients=5, seq_len=24, vocab=300, seed=3)
    tc = tsyn.make_federated_data(num_clients=5, seq_len=24, vocab=300, seed=3)
    for a, b in zip(jc, tc):
        assert a.num_samples == b.num_samples
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.loss_mask, b.loss_mask)
    je, te = jsyn.make_eval_data(16, 24, 300), tsyn.make_eval_data(16, 24, 300)
    for k in je:
        np.testing.assert_array_equal(je[k], te[k])


QUICK = dict(name="quickstart-tiny", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=256, dtype="float32")


@pytest.mark.parametrize("heter,svd", [(False, "svd"), (True, "gram")])
def test_two_rounds_match_reference(heter, svd):
    """Two quickstart-sized rounds (examples/quickstart.py's setup; the
    heterogeneous case on the Gram route) with the reference's params and
    shared A init carried across."""
    fedkw = dict(num_clients=10, clients_per_round=4, method="florist",
                 tau=0.9, homogeneous_rank=8, heterogeneous=heter,
                 rank_distribution=((4, 4), (8, 6)), seed=0)
    kw = dict(batch_size=8, local_steps=4, seq_len=32, svd_method=svd)
    jt = JTrainer(JModelConfig(**QUICK), JFedConfig(**fedkw),
                  JLoRAConfig(rank=8, alpha=8.0), JOptimConfig(lr=3e-3), **kw)
    tt = FederatedTrainer(ModelConfig(**QUICK), FedConfig(**fedkw),
                          LoRAConfig(rank=8, alpha=8.0), OptimConfig(lr=3e-3),
                          device="cpu", **kw)
    tt.params = params_from_numpy(jax.device_get(jt.params), "cpu")
    tt.A_init_full = adapters_from_numpy(jax.device_get(jt.A_init_full), "cpu")
    for rnd in range(2):
        jrec, rec = jt.run_round(rnd), tt.run_round(rnd)
        assert jt.global_state.ranks == tt.global_state.ranks
        for k in ("upload_params", "download_params", "upload_bytes",
                  "download_bytes", "global_rank_total", "download_rank"):
            assert getattr(rec, k) == getattr(jrec, k), k
        assert rec.eval_loss == pytest.approx(jrec.eval_loss, abs=1e-4)
        assert rec.eval_acc == pytest.approx(jrec.eval_acc, abs=1e-6)


def test_rank_matching_merge_and_counts():
    rng = np.random.default_rng(1)
    tree = _client(rng, 6)
    jtree = jax.tree.map(jnp.asarray, tree)
    for rank in (3, 6, 9):
        want = jlora.match_rank(jtree, rank)
        host = tlora.match_rank(tree, rank)             # numpy stays numpy
        dev = tlora.match_rank(adapters_from_numpy(tree, "cpu"), rank)
        for name in LEAVES:
            for k in ("A", "B"):
                w = np.asarray(want["blocks"][0]["attn"][name][k])
                h = host["blocks"][0]["attn"][name][k]
                assert isinstance(h, np.ndarray)
                np.testing.assert_array_equal(h, w)
                np.testing.assert_array_equal(
                    dev["blocks"][0]["attn"][name][k].numpy(), w)
    assert tlora.adapter_num_params(tree) == jlora.adapter_num_params(jtree)
    params = {"blocks": ({"attn": {name: rng.normal(size=(L, n, m)).astype(
        np.float32) for name, (n, m) in LEAVES.items()}},)}
    jm = jlora.merge_lora(jax.tree.map(jnp.asarray, params), jtree)
    tm = tlora.merge_lora(params_from_numpy(params, "cpu"), tree)
    for name in LEAVES:
        _rel(tm["blocks"][0]["attn"][name].numpy(),
             jm["blocks"][0]["attn"][name])


def test_validation_gate_screen():
    rng = np.random.default_rng(2)
    agg = FloristAggregator()
    gate = ValidationGate("screen", min_clients=2)
    gate.begin_round(agg)
    task = ClientTask(0, 4, 1, 0.5)
    assert gate.submit(task, _ours(_client(rng, 4)), 0.5, rank=4)
    assert not gate.submit(task, _ours(_client(rng, 4)), 0.5, rank=4)  # duplicate
    bad = _ours(_client(rng, 4))
    bad["blocks"][0]["attn"]["wq"]["B"][0, 0, 0] = np.nan
    assert not gate.submit(ClientTask(1, 4, 1, 0.5), bad, 0.5, rank=4)
    assert not gate.submit(ClientTask(2, 4, 1, 0.5), _ours(_client(rng, 8)),
                           0.5, rank=4)                                  # rank
    stats = gate.finish()
    assert (stats.accepted, stats.rejected_duplicate, stats.rejected_nonfinite,
            stats.rejected_shape, stats.quorum_met) == (1, 1, 1, 1, False)
    assert agg.num_clients == 1


def test_unported_names_raise_not_implemented():
    for make in (lambda: make_aggregator("fedit"), lambda: make_runner("cohort"),
                 lambda: make_scheduler("async"), lambda: make_codec("bf16"),
                 lambda: ValidationGate("full"),
                 lambda: FloristAggregator(pipeline="loop")):
        with pytest.raises(NotImplementedError, match="not ported"):
            make()


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The trainer and the launcher run on CUDA by default and raise
    without it; ``device="cpu"`` / ``--device cpu`` run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(**{**QUICK, "num_layers": 1})
    fed = FedConfig(num_clients=4, clients_per_round=2, seed=0)
    args = ["--rounds", "1", "--clients", "4", "--sample", "2", "--layers", "1",
            "--d-model", "32", "--local-steps", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedTrainer(cfg, fed, LoRAConfig(), OptimConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfed.main(args)
    out = tmp_path / "hist.json"
    hist = tfed.main(args + ["--device", "cpu", "--out", str(out)])
    assert len(hist) == 1 and np.isfinite(hist[0].eval_loss) and out.exists()


def test_runner_step_log_and_round_timings():
    """``SequentialRunner(record_steps=True)`` logs every train step of the
    round with its client, and the record times the server's finalize."""
    from repro_torch.core.runtime import SequentialRunner
    runner = SequentialRunner(record_steps=True)
    tt = FederatedTrainer(ModelConfig(**{**QUICK, "num_layers": 1}),
                          FedConfig(num_clients=6, clients_per_round=3, seed=1),
                          LoRAConfig(rank=4, alpha=4.0), OptimConfig(),
                          batch_size=4, local_steps=2, seq_len=16,
                          runner=runner, device="cpu")
    rec = tt.run_round(0)
    log = runner.step_log()
    assert len(log) == 3 * 2 and all(e["ms"] > 0 for e in log)
    assert [e["step"] for e in log] == [0, 1] * 3
    assert 0 < rec.finalize_secs < rec.wall_secs


def test_costs_match_reference():
    """The round's parameter counts and MB figures, through the registry's
    cost model, equal the reference's."""
    from repro.core import costs as jcosts
    from repro_torch.core import costs as tcosts
    rng = np.random.default_rng(4)
    trees = [_client(rng, r) for r in (4, 8)]
    assert tcosts.upload_params("florist", trees) == jcosts.upload_params(
        "florist", [jax.tree.map(jnp.asarray, t) for t in trees])
    ranks = {("blocks", 0, "attn", n): [3, 5] for n in LEAVES}
    dims = {("blocks", 0, "attn", n): (L, nn, m) for n, (nn, m) in LEAVES.items()}
    jr = JAggResult("florist", None, None, ranks, {})
    tr = AggResult("florist", {}, ranks, {})
    assert tcosts.download_params("florist", tr, dims, 3, [4, 8]) == \
        jcosts.download_params("florist", jr, dims, 3, [4, 8])
    assert tcosts.mb(123456) == jcosts.mb(123456)
    assert tcosts.wire_mb(1 << 20) == jcosts.wire_mb(1 << 20) == 1.0
