"""Port parity of client-level DP on the wire against ``repro.core.privacy``
and the reference transport's DP stage.  The clip (σ 0) equals the
reference's within 1e-6; the noise, drawn from a ``torch.Generator`` (not
``jax.random``'s stream, so its values differ by design), has std σ·C
within 5%, a key unique to each (round, client) and reproducible, and is
applied once per upload however many retries the wire needs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import privacy as jpriv  # noqa: E402
from repro.core.runtime import Transport as JTransport  # noqa: E402
from repro_torch.common.config import (FedConfig, LoRAConfig,  # noqa: E402
                                       ModelConfig, OptimConfig)
from repro_torch.core import privacy as priv  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.core.runtime import FaultPlan, Transport, ValidationGate  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test (the suite runs files on parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, L=2, m=24, n=16, r=4, scale=1.0):
    return {"blocks": {0: {"attn": {name: {
        "A": (scale * rng.normal(size=(L, r, n))).astype(np.float32),
        "B": (scale * rng.normal(size=(L, m, r))).astype(np.float32),
        "scale": np.full((L,), 2.0, np.float32)} for name in ("wq", "wv")}}}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree, np.float32)]


@pytest.mark.parametrize("clip", [0.05, 0.5, 100.0])
def test_clip_at_sigma_zero_equals_reference(clip):
    rng = np.random.default_rng(3)
    init, trained = _tree(rng), _tree(rng)
    got, _ = Transport("fp32", dp_clip=clip).client_to_server(
        trained, None, init_adapters=init, rnd=2, client_id=5)
    want, _ = JTransport("fp32", dp_clip=clip).client_to_server(
        trained, None, init_adapters=init, rnd=2, client_id=5)
    for g, w in zip(_leaves(got), _leaves(jax.device_get(want))):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    delta = priv.tree_sub({"t": torch.as_tensor(_leaves(got)[0])},
                          {"t": torch.as_tensor(_leaves(init)[0])})
    assert float(priv.global_l2(delta)) <= clip * (1 + 1e-6)


def test_clip_update_and_calibration_equal_reference():
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}
    got, n = priv.clip_update({k: torch.from_numpy(v) for k, v in tree.items()}, 0.7)
    want, jn = jpriv.clip_update(jax.tree.map(jnp.asarray, tree), 0.7)
    assert float(n) == pytest.approx(float(jn), rel=1e-6)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
    for eps in (0.5, 1.0, 8.0):
        assert priv.noise_multiplier_for_epsilon(eps) == \
            jpriv.noise_multiplier_for_epsilon(eps)


@pytest.mark.parametrize("sigma,clip", [(1.0, 1.0), (0.6, 0.25)])
def test_local_noise_std_is_sigma_times_clip(sigma, clip):
    zero = {"x": torch.zeros(400, 250), "scale": torch.ones(4)}
    noisy = priv.local_gaussian_noise(zero, sigma, clip,
                                      priv.noise_generator(0, 1, 2, "cpu"))
    assert float(noisy["x"].std()) == pytest.approx(sigma * clip, rel=0.05)
    assert abs(float(noisy["x"].mean())) < 0.05 * sigma * clip
    assert torch.equal(noisy["scale"], zero["scale"])          # never noised
    central = priv.add_gaussian_noise(zero, sigma, clip, 4,
                                      priv.noise_generator(0, 1, 2, "cpu"))
    assert float(central["x"].std()) == pytest.approx(sigma * clip / 4, rel=0.05)


def test_noise_keys_unique_per_round_and_client_and_reproducible():
    seeds = {priv.noise_seed(7, r, k) for r in range(40) for k in range(200)}
    assert len(seeds) == 40 * 200
    assert priv.noise_seed(7, 3, 4) != priv.noise_seed(8, 3, 4)
    rng = np.random.default_rng(5)
    init, trained = _tree(rng), _tree(rng)
    t = Transport("fp32", dp_clip=1.0, dp_sigma=0.8, dp_seed=7)
    a, _ = t.client_to_server(trained, None, init_adapters=init, rnd=1, client_id=3)
    b, _ = t.client_to_server(trained, None, init_adapters=init, rnd=1, client_id=3)
    c, _ = t.client_to_server(trained, None, init_adapters=init, rnd=1, client_id=4)
    d, _ = t.client_to_server(trained, None, init_adapters=init, rnd=2, client_id=3)
    la, lb, lc, ld = (_leaves(x) for x in (a, b, c, d))
    assert all(np.array_equal(x, y) for x, y in zip(la, lb))
    assert not np.array_equal(la[0], lc[0]) and not np.array_equal(la[0], ld[0])


def test_dp_applied_once_across_retries(monkeypatch):
    """A client whose first two uploads arrive corrupted: the DP stage runs
    once, and the delivered tree equals the clean wire's."""
    calls = {"clip": 0, "noise": 0}
    clip, noise = priv.clip_update, priv.local_gaussian_noise

    def counting_clip(*a, **k):
        calls["clip"] += 1
        return clip(*a, **k)

    def counting_noise(*a, **k):
        calls["noise"] += 1
        return noise(*a, **k)

    monkeypatch.setattr(priv, "clip_update", counting_clip)
    monkeypatch.setattr(priv, "local_gaussian_noise", counting_noise)
    plan = FaultPlan(seed=0, corrupt=1.0, max_bad_attempts=2)
    client = next(k for k in range(50)
                  if plan.client_fault(0, k).n_bad == 2)
    rng = np.random.default_rng(6)
    init, trained = _tree(rng), _tree(rng)
    t = Transport("bf16", dp_clip=1.0, dp_sigma=0.5, fault_plan=plan)
    got, nbytes = t.client_to_server(trained, None, init_adapters=init, rnd=0,
                                     client_id=client)
    assert calls == {"clip": 1, "noise": 1}
    assert t.stats.retries == 2 and t.stats.attempts == 3
    clean, cbytes = Transport("bf16", dp_clip=1.0, dp_sigma=0.5).client_to_server(
        trained, None, init_adapters=init, rnd=0, client_id=client)
    assert nbytes == 3 * cbytes
    assert all(np.array_equal(x, y) for x, y in zip(_leaves(got), _leaves(clean)))


def test_dp_needs_the_round_init():
    with pytest.raises(ValueError, match="init adapters"):
        Transport("fp32", dp_clip=1.0).client_to_server(
            _tree(np.random.default_rng(0)), None)


def test_honest_dp_clients_pass_the_full_gate():
    cfg = ModelConfig(name="dp-tiny", family="dense", num_layers=1, d_model=32,
                      num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
                      vocab_size=64, dtype="float32")
    tr = FederatedTrainer(cfg, FedConfig(num_clients=8, clients_per_round=4,
                                         homogeneous_rank=4, seed=0),
                          LoRAConfig(rank=4, alpha=4.0), OptimConfig(lr=3e-3),
                          batch_size=2, local_steps=1, seq_len=8,
                          dp_clip=1.0, dp_sigma=0.7, runner="cohort",
                          validation=ValidationGate("full"), device="cpu")
    hist = tr.run(2)
    assert all(r.quarantined == 0 and r.rejected == 0 and r.quorum_met
               for r in hist)
    assert all(np.isfinite(r.eval_loss) for r in hist)
