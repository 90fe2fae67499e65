"""Port parity of the federated runtime's pure parts against
``repro.core.runtime``: the four schedulers and the two rank policies plan
exactly the reference's rounds (five rounds each, from the same numpy
seeds), the ``int8`` codec's bytes equal the reference's bit for bit, the
checkpoint module writes the reference's npz keys and round-trips the
state blobs, every aggregator's ``state_dict`` restores a mid-round
accumulator exactly, and the trainer's ``state_dict`` has the reference's
keys."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import io as jckpt  # noqa: E402
from repro.common.config import FedConfig as JFedConfig  # noqa: E402
from repro.core.aggregators import make_aggregator as jmake_aggregator  # noqa: E402
from repro.core.runtime import make_codec as jmake_codec  # noqa: E402
from repro.core.runtime import make_rank_policy as jmake_rank_policy  # noqa: E402
from repro.core.runtime import make_scheduler as jmake_scheduler  # noqa: E402
from repro.core.runtime.transport import AdapterPayload as JPayload  # noqa: E402
from repro_torch.checkpoint import io as ckpt  # noqa: E402
from repro_torch.common.config import (FedConfig, LoRAConfig,  # noqa: E402
                                       ModelConfig, OptimConfig)
from repro_torch.core.aggregators import make_aggregator  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.core.runtime import (make_codec, make_rank_policy,  # noqa: E402
                                      make_scheduler)
from repro_torch.core.runtime.transport import AdapterPayload  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test (the suite runs files on parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass
class _Data:
    num_samples: int


class _Ctx:
    """The round context a scheduler reads: the trainer's numpy rng, the
    federated config, the clients' sample counts and ranks."""

    def __init__(self, fed):
        self.fed = fed
        self.rng = np.random.default_rng(fed.seed)
        self.clients = [_Data(int(n)) for n in
                        np.random.default_rng(7).integers(5, 60, fed.num_clients)]
        self.client_ranks = fed.client_ranks()
        self.local_steps = 4

    def _client_init(self, k, rank=None):
        return {"client": k}


def _plan_rows(plan):
    return (plan.round, plan.downloads,
            [(t.client_id, t.rank, t.steps, t.weight, t.staleness,
              None if t.init_adapters is None else t.init_adapters["client"])
             for t in plan.tasks])


SCHEDULERS = [("sync", {}), ("partial", {}),
              ("partial", {"drop_rate": 0.6, "straggler_rate": 0.7}),
              ("async", {}), ("async", {"max_delay": 5, "buffer_size": 6}),
              ("sampled", {"fraction": 0.3}),
              ("sampled", {"fraction": 0.25, "drop_rate": 0.3,
                           "straggler_rate": 0.4})]


@pytest.mark.parametrize("policy,pkw", [("static", {}), ("resource", {}),
                                        ("resource", {"warmup": 3})])
@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULERS)])
def test_scheduler_plans_equal_reference(name, kw, policy, pkw):
    """Five rounds of plans, rank policy applied: clients, ranks, step
    budgets, weights, staleness, snapshots and downlink counts equal."""
    fed = JFedConfig(num_clients=20, clients_per_round=5, heterogeneous=True,
                     rank_distribution=((4, 6), (8, 6), (16, 4), (32, 4)),
                     seed=3)
    jctx, ctx = _Ctx(fed), _Ctx(fed)
    js, ts = jmake_scheduler(name, **kw), make_scheduler(name, **kw)
    jp, tp = jmake_rank_policy(policy, **pkw), make_rank_policy(policy, **pkw)
    for rnd in range(5):
        jplan, plan = js.plan(rnd, jctx), ts.plan(rnd, ctx)
        jp.assign(rnd, jplan, jctx)
        tp.assign(rnd, plan, ctx)
        assert _plan_rows(plan) == _plan_rows(jplan)
        if policy == "resource":
            assert all(t.rank & (t.rank - 1) == 0 for t in plan.tasks)
    assert jctx.rng.bit_generator.state == ctx.rng.bit_generator.state


def test_async_pool_state_round_trips():
    """The async scheduler's in-flight pool survives ``state_dict`` /
    ``load_state_dict`` into a fresh scheduler: the next plans are equal."""
    fed = JFedConfig(num_clients=12, clients_per_round=4, seed=5)
    a, ctx = make_scheduler("async", max_delay=4), _Ctx(fed)
    for rnd in range(3):
        a.plan(rnd, ctx)
    b = make_scheduler("async", max_delay=4)
    b.load_state_dict(ckpt.to_host(a.state_dict()), "cpu")
    state = ctx.rng.bit_generator.state
    want = [_plan_rows(a.plan(r, ctx)) for r in (3, 4)]
    ctx.rng.bit_generator.state = state
    assert [_plan_rows(b.plan(r, ctx)) for r in (3, 4)] == want


def test_make_scheduler_and_policy_refuse_unknown_names():
    with pytest.raises(ValueError, match="registered"):
        make_scheduler("lottery")
    with pytest.raises(ValueError, match="registered"):
        make_rank_policy("greedy")


@pytest.mark.parametrize("shape,scale", [((3, 5, 7), 1.0), ((16, 9), 1e-3),
                                         ((4,), 300.0), ((2, 0), 1.0)])
def test_int8_bytes_equal_reference(shape, scale):
    rng = np.random.default_rng(11)
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    if a.size:
        a.reshape(-1)[0] = 0.0
    enc, jenc = make_codec("int8").encode(a), jmake_codec("int8").encode(a)
    assert enc.data == jenc.data and enc.meta == jenc.meta
    assert enc.num_bytes == jenc.num_bytes == a.size + 4
    np.testing.assert_array_equal(make_codec("int8").decode(enc),
                                  jmake_codec("int8").decode(jenc))


def test_int8_payload_bytes_equal_reference():
    """A whole adapter tree packed with the int8 codec, whole-array and
    ragged per-layer blocks: the same blocks, bytes and decoded tree."""
    rng = np.random.default_rng(2)
    tree = {"blocks": {0: {"attn": {n: {
        "A": rng.normal(size=(2, 6, 32)).astype(np.float32),
        "B": rng.normal(size=(2, m, 6)).astype(np.float32),
        "scale": np.ones((2,), np.float32)} for n, m in (("wq", 32), ("wv", 8))}}}}
    ranks = {("blocks", 0, "attn", "wq"): [3, 6], ("blocks", 0, "attn", "wv"): [1, 2]}
    for rk in (None, ranks):
        p = AdapterPayload.pack(tree, make_codec("int8"), ranks=rk)
        jp = JPayload.pack(tree, jmake_codec("int8"), ranks=rk)
        assert p.num_bytes == jp.num_bytes
        for path, by_name in jp.blocks.items():
            for name, encs in by_name.items():
                got = p.blocks[path][name]
                assert [(e.data, e.shape, e.meta, e.crc) for e in got] == \
                    [(e.data, e.shape, e.meta, e.crc) for e in encs]
        out = p.unpack_into(tree, make_codec("int8"))
        jout = jp.unpack_into(tree, jmake_codec("int8"))
        for path in ranks:
            for name in ("A", "B"):
                np.testing.assert_array_equal(
                    out["blocks"][0]["attn"][path[-1]][name],
                    np.asarray(jout["blocks"][0]["attn"][path[-1]][name]))


def test_npz_keys_equal_reference_and_restore(tmp_path):
    """``save`` writes the reference's key strings; ``restore`` reads a
    reference checkpoint into a torch tree (bf16 leaves exact)."""
    rng = np.random.default_rng(4)
    tree = {"blocks": ({"attn": {"wq": rng.normal(size=(2, 4, 4)).astype(np.float32)}},
                       {"mlp": {"w_up": rng.normal(size=(3, 5)).astype(np.float32)}}),
            "embed": rng.normal(size=(7, 4)).astype(np.float32)}
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref.npz")
    ttree = {"blocks": tuple({k: {n: torch.from_numpy(v) for n, v in d.items()}
                              for k, d in blk.items()} for blk in tree["blocks"]),
             "embed": torch.from_numpy(tree["embed"]).bfloat16()}
    ckpt.save(ours, ttree, step=5)
    jckpt.save(ref, jax.tree.map(np.asarray, tree), step=5)
    assert sorted(np.load(ours).files) == sorted(np.load(ref).files)
    assert ckpt.restore_step(ours) == jckpt.restore_step(ref) == 5
    back = ckpt.restore(ref, ttree)
    np.testing.assert_array_equal(back["blocks"][0]["attn"]["wq"].numpy(),
                                  tree["blocks"][0]["attn"]["wq"])
    again = ckpt.restore(ours, ttree)
    assert again["embed"].dtype == torch.bfloat16
    assert torch.equal(again["embed"], ttree["embed"])
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_state_blob_round_trips_types_and_bits(tmp_path):
    state = {("a", 0): torch.randn(3, 4, dtype=torch.bfloat16),
             "np": np.arange(6.0).reshape(2, 3), "set": {1, 2},
             "list": [torch.ones(2), None, "x"], "tuple": (torch.zeros(1),)}
    path = str(tmp_path / "blob")
    ckpt.save_state(path, ckpt.to_host(state))
    back = ckpt.to_device(ckpt.restore_state(path), "cpu")
    assert torch.equal(back[("a", 0)], state[("a", 0)])
    assert back[("a", 0)].dtype == torch.bfloat16
    assert isinstance(back["np"], np.ndarray) and back["set"] == {1, 2}
    assert isinstance(back["tuple"], tuple) and back["list"][2] == "x"


def _rand_tree(rng, L=2, m=32, n=24, r=4):
    return {"blk": {"A": rng.normal(size=(L, r, n)).astype(np.float32),
                    "B": rng.normal(size=(L, m, r)).astype(np.float32),
                    "scale": np.ones((L,), np.float32)}}


def _equal_trees(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(torch.as_tensor(a)), np.asarray(torch.as_tensor(b)))


@pytest.mark.parametrize("method", ["fedit", "ffa", "flora", "flexlora",
                                    "florist"])
def test_aggregator_state_roundtrip_mid_round(method, tmp_path):
    """Two clients folded, the accumulators saved through the atomic
    pickle and restored into a fresh aggregator, two more folded into
    both: the finalized results are equal bit for bit, and the state's
    keys are the reference's."""
    rng = np.random.default_rng(30)
    clients = [_rand_tree(rng) for _ in range(4)]
    kw = {"tau": 0.9} if method == "florist" else {}
    a_init = {"blk": {"A": torch.from_numpy(clients[0]["blk"]["A"]),
                      "B": torch.zeros(2, 32, 4), "scale": torch.ones(2)}}

    def mk():
        agg = make_aggregator(method, **kw)
        if method == "ffa":
            agg.A_init = a_init
        agg.begin_round()
        return agg

    agg1 = mk()
    for c in clients[:2]:
        agg1.add_client(c, 0.25, rank=4)
    blob = str(tmp_path / "agg.state")
    ckpt.save_state(blob, agg1.state_dict())
    jagg = jmake_aggregator(method, **kw)
    assert set(agg1.state_dict()) == set(jagg.state_dict())
    agg2 = mk()
    agg2.load_state_dict(ckpt.restore_state(blob), "cpu")
    for agg in (agg1, agg2):
        for c in clients[2:]:
            agg.add_client(c, 0.25, rank=4)
    r1, r2 = agg1.finalize(), agg2.finalize()
    assert r1.ranks == r2.ranks
    assert (r1.global_adapters is None) == (r2.global_adapters is None)
    if r1.global_adapters is not None:
        assert _equal_trees(r1.global_adapters, r2.global_adapters)
    for t1, t2 in zip(r1.per_client or [], r2.per_client or []):
        assert _equal_trees(t1, t2)


TINY = dict(name="rt-tiny", family="dense", num_layers=1, d_model=32,
            num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64,
            dtype="float32")


def test_trainer_state_dict_keys_equal_reference():
    """The port's trainer state has the reference's keys, its global state
    and record fields included (the record adds ``finalize_secs``)."""
    from repro.common.config import LoRAConfig as JLoRAConfig
    from repro.common.config import ModelConfig as JModelConfig
    from repro.common.config import OptimConfig as JOptimConfig
    from repro.core.federated import FederatedTrainer as JTrainer
    fedkw = dict(num_clients=4, clients_per_round=2, homogeneous_rank=4, seed=0)
    kw = dict(batch_size=2, local_steps=1, seq_len=8)
    jt = JTrainer(JModelConfig(**TINY), JFedConfig(**fedkw),
                  JLoRAConfig(rank=4, alpha=4.0), JOptimConfig(), **kw)
    tt = FederatedTrainer(ModelConfig(**TINY), FedConfig(**fedkw),
                          LoRAConfig(rank=4, alpha=4.0), OptimConfig(),
                          device="cpu", **kw)
    jt.run_round(0)
    tt.run_round(0)
    js, ts = jt.state_dict(1), tt.state_dict(1)
    assert set(ts) == set(js)
    assert set(ts["global_state"]) == set(js["global_state"])
    assert set(ts["aggregator"]) == set(js["aggregator"])
    assert set(ts["history"][0]) == set(js["history"][0]) | {"finalize_secs"}
    assert ts["rng"] == js["rng"]
