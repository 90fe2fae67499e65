"""Two federated rounds of each of the paper's five methods (FLoRIST, FedIT,
FFA-LoRA, FLoRA, FlexLoRA) through the port's ``FederatedTrainer`` against
the reference trainer, on the quickstart-tiny config over the ``bf16``
wire (the paper's 2-byte accounting).

The reference trainer's ``params`` and ``A_init_full`` are carried into the
port's trainer after construction (``repro_torch.convert``); the data, the
client sample and the batch schedule are numpy in both packages.  Round 2
is where the methods' client semantics show: FFA's frozen A, FLoRA's merge
into the base and re-init, FlexLoRA's per-client cuts.  Kept ranks, counts
and wire bytes are compared exactly, ``eval_loss`` within 1e-4, and
FLoRA's merged base weights within 1e-5 of max(1, |W|).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.common.config import FedConfig as JFedConfig  # noqa: E402
from repro.common.config import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.common.config import ModelConfig as JModelConfig  # noqa: E402
from repro.common.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.core.federated import FederatedTrainer as JTrainer  # noqa: E402
from repro_torch.common.config import (FedConfig, LoRAConfig,  # noqa: E402
                                       ModelConfig, OptimConfig)
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core.aggregators import adapter_leaf_paths, get_path  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402

QUICK = dict(name="quickstart-tiny", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=256, dtype="float32")

CASES = [(m, False) for m in ("florist", "fedit", "ffa", "flora", "flexlora")] \
    + [("fedit", True), ("flexlora", True)]


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("method,heter", CASES,
                         ids=[f"{m}-{'het' if h else 'hom'}" for m, h in CASES])
def test_two_rounds_of_each_method_match_reference(method, heter):
    fedkw = dict(num_clients=10, clients_per_round=4, method=method, tau=0.9,
                 homogeneous_rank=8, heterogeneous=heter,
                 rank_distribution=((4, 4), (8, 6)), zero_padding=heter,
                 seed=1)
    kw = dict(batch_size=8, local_steps=3, seq_len=32, transport="bf16")
    jt = JTrainer(JModelConfig(**QUICK), JFedConfig(**fedkw),
                  JLoRAConfig(rank=8, alpha=8.0), JOptimConfig(lr=3e-3), **kw)
    tt = FederatedTrainer(ModelConfig(**QUICK), FedConfig(**fedkw),
                          LoRAConfig(rank=8, alpha=8.0), OptimConfig(lr=3e-3),
                          device="cpu", **kw)
    tt.params = params_from_numpy(jax.device_get(jt.params), "cpu")
    # the FFA aggregator is handed this overwritten init at each round
    tt.A_init_full = adapters_from_numpy(jax.device_get(jt.A_init_full), "cpu")
    base = {p: get_path(tt.params, p).clone() for p in
            [("blocks", 0, "attn", n) for n in ("wq", "wk", "wv", "wo")]}
    for rnd in range(2):
        jrec, rec = jt.run_round(rnd), tt.run_round(rnd)
        assert tt.global_state.ranks == {
            p: [int(v) for v in r] for p, r in jt.global_state.ranks.items()}
        for k in ("upload_params", "download_params", "upload_bytes",
                  "download_bytes", "global_rank_total", "download_rank"):
            assert getattr(rec, k) == getattr(jrec, k), k
        assert rec.upload_bytes == 2 * rec.upload_params
        assert rec.download_bytes == 2 * rec.download_params
        assert rec.eval_loss == pytest.approx(jrec.eval_loss, abs=1e-4)
        assert np.isfinite(rec.eval_loss)
        gs, jgs = tt.global_state, jt.global_state
        assert gs.merge_into_base == jgs.merge_into_base == (method == "flora")
        assert (gs.per_client is None) == (jgs.per_client is None) == \
            (method != "flexlora")
        for p in base:                       # FLoRA alone moves the base
            w = get_path(tt.params, p)
            _close(w.numpy(), np.asarray(get_path(jt.params, p)))
            assert torch.equal(w, base[p]) == (method != "flora")
        if method == "ffa":                  # A frozen at the init, bit for bit
            for path in adapter_leaf_paths(gs.global_adapters):
                np.testing.assert_array_equal(
                    np.asarray(get_path(gs.global_adapters, path)["A"]),
                    get_path(tt.A_init_full, path)["A"].numpy())
        if method == "flora":                # clients restart at B = 0
            init = tt._client_init(0)
            for path in adapter_leaf_paths(init):
                assert not np.asarray(get_path(init, path)["B"]).any()


@pytest.mark.parametrize("method", ["flora", "florist"])
def test_degraded_round_does_not_merge_twice(method):
    """A round that misses its quorum keeps the previous global state and
    evaluates it as the last good round did: FLoRA's stack is already in
    the base (merging it again would move the loss), FLoRIST's broadcast
    is merged once."""
    tt = FederatedTrainer(ModelConfig(**QUICK),
                          FedConfig(num_clients=6, clients_per_round=3,
                                    method=method, homogeneous_rank=4, seed=2),
                          LoRAConfig(rank=4, alpha=4.0), OptimConfig(lr=3e-2),
                          batch_size=4, local_steps=2, seq_len=16, device="cpu")
    good = tt.run_round(0)
    base = {k: v for k, v in tt.params.items()}
    tt.gate.min_clients = 99                     # no round reaches it now
    bad = tt.run_round(1)
    assert good.quorum_met and not bad.quorum_met
    assert bad.eval_loss == pytest.approx(good.eval_loss, abs=1e-6)
    assert all(tt.params[k] is v for k, v in base.items())
