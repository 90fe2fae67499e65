"""Port parity of fault injection and the hardened wire against
``repro.core.runtime``: the fault plan's decisions, poisoned trees and
corrupted bytes equal the reference's exactly; the transport's retries,
backoff and dead clients, and the ``full`` gate's quarantines and
renormalized weights, equal the reference's on the same inputs; a faulty
round's counters equal the reference trainer's; and a run killed at every
crash point resumes from its checkpoint to a bit-identical history on the
CPU (the async pool and the cohort runner included)."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.runtime import FaultPlan as JFaultPlan  # noqa: E402
from repro.core.runtime import Transport as JTransport  # noqa: E402
from repro.core.runtime import ValidationGate as JGate  # noqa: E402
from repro.core.runtime import make_codec as jmake_codec  # noqa: E402
from repro.core.runtime.transport import AdapterPayload as JPayload  # noqa: E402
from repro_torch.common.config import (FedConfig, LoRAConfig,  # noqa: E402
                                       ModelConfig, OptimConfig)
from repro_torch.core.aggregators import (adapter_leaf_paths, fold_scale,  # noqa: E402
                                          get_path)
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.core.runtime import (CRASH_POINTS, DeadClientError,  # noqa: E402
                                      FaultPlan, ServerCrash, Transport,
                                      ValidationGate, make_codec)
from repro_torch.core.runtime.transport import AdapterPayload  # noqa: E402

RATES = dict(drop=0.1, duplicate=0.15, corrupt=0.2, nan=0.1, scale=0.15,
             slow=0.1)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test (the suite runs files on parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, L=2, m=16, n=12, r=4, b_scale=1.0):
    return {"blk": {"A": rng.normal(size=(L, r, n)).astype(np.float32),
                    "B": (b_scale * rng.normal(size=(L, m, r))).astype(np.float32),
                    "scale": np.ones((L,), np.float32)}}


def test_fault_decisions_equal_reference():
    for seed in (0, 3):
        plan, jplan = FaultPlan(seed=seed, **RATES), JFaultPlan(seed=seed, **RATES)
        for rnd in range(6):
            for k in range(20):
                assert dataclasses.astuple(plan.client_fault(rnd, k)) == \
                    dataclasses.astuple(jplan.client_fault(rnd, k))
                for att in range(4):
                    assert plan.is_corrupt(rnd, k, att) == jplan.is_corrupt(rnd, k, att)


@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8"])
def test_corrupted_bytes_equal_reference(codec):
    rng = np.random.default_rng(5)
    tree = _tree(rng)
    plan, jplan = FaultPlan(seed=2, corrupt=1.0), JFaultPlan(seed=2, corrupt=1.0)
    for rnd, k, att in ((0, 1, 0), (1, 3, 2), (4, 0, 1)):
        p = plan.corrupt_payload(AdapterPayload.pack(tree, make_codec(codec)),
                                 rnd, k, att)
        jp = jplan.corrupt_payload(JPayload.pack(tree, jmake_codec(codec)),
                                   rnd, k, att)
        for path, by_name in jp.blocks.items():
            for name, encs in by_name.items():
                assert [e.data for e in p.blocks[path][name]] == \
                    [e.data for e in encs]


@pytest.mark.parametrize("kind", ["nan", "scale"])
def test_poison_equals_reference(kind):
    rng = np.random.default_rng(8)
    tree, init = _tree(rng), _tree(rng)
    plan = FaultPlan(seed=1, **{kind: 1.0})
    jplan = JFaultPlan(seed=1, **{kind: 1.0})
    for rnd, k in ((0, 0), (2, 5)):
        got = plan.poison({"blk": {n: torch.from_numpy(v) for n, v in
                                   tree["blk"].items()}}, init, rnd, k)
        want = jax.device_get(jplan.poison(tree, init, rnd, k))
        for name in ("A", "B"):
            np.testing.assert_array_equal(np.asarray(got["blk"][name]),
                                          np.asarray(want["blk"][name]))


def test_transport_retries_and_dead_clients_equal_reference():
    """The same uploads through both transports under one corrupting plan:
    bytes, attempts, retries, checksum failures, dead clients, backoff and
    the simulated clock equal."""
    rng = np.random.default_rng(9)
    tree = _tree(rng)
    kw = dict(max_retries=3, backoff_base=0.1, backoff_jitter=0.5)
    plan = FaultPlan(seed=4, corrupt=0.7, max_bad_attempts=6)
    jplan = JFaultPlan(seed=4, corrupt=0.7, max_bad_attempts=6)
    t = Transport("int8", fault_plan=plan, **kw)
    jt = JTransport("int8", fault_plan=jplan, **kw)
    for k in range(12):
        outs = []
        for tr in (t, jt):
            try:
                _, nbytes = tr.client_to_server(tree, None, rnd=1, client_id=k)
                outs.append(nbytes)
            except Exception as e:   # DeadClientError of either package
                outs.append(type(e).__name__)
        assert outs[0] == outs[1]
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(jt.stats)
    assert t.stats.dead_clients > 0 and t.stats.retries > 0
    assert plan.clock.now == jplan.clock.now


def test_dead_client_error_after_every_attempt():
    tree = _tree(np.random.default_rng(1))
    t = Transport("fp32", fault_plan=FaultPlan(seed=0, corrupt=1.0,
                                               max_bad_attempts=100),
                  max_retries=2)
    with pytest.raises(DeadClientError, match="3 failed upload attempts"):
        t.client_to_server(tree, None, rnd=0, client_id=0)


class _RecAgg:
    def __init__(self):
        self.calls = []

    def add_client(self, update, weight, rank=None):
        self.calls.append((update, float(weight), rank))


@pytest.mark.parametrize("outliers", [0, 1, 2])
def test_full_gate_quarantines_and_weights_equal_reference(outliers):
    """Honest deltas, ``outliers`` 50x deltas, a NaN and a duplicate: the
    same updates fold, with weights within 1e-6, and the counters equal."""
    rng = np.random.default_rng(20 + outliers)
    init = _tree(rng)
    ups = []
    for i in range(7):
        d = _tree(rng, b_scale=0.1)
        f = 50.0 if i < outliers else 1.0
        ups.append({"blk": {n: (init["blk"][n] + f * 0.01 * d["blk"][n]
                                if n != "scale" else init["blk"][n])
                            for n in ("A", "B", "scale")}})
    ups[5]["blk"]["B"][0, 0, 0] = np.nan
    weights = list(np.random.default_rng(1).uniform(0.05, 0.3, 7))
    results = []
    for gate_cls in (ValidationGate, JGate):
        agg, gate = _RecAgg(), gate_cls("full", min_clients=2)
        gate.begin_round(agg)
        tasks = [object() for _ in ups]
        for task, u, w in zip(tasks, ups, weights):
            gate.submit(task, u, w, rank=4, init_adapters=init)
        gate.submit(tasks[1], ups[1], weights[1], rank=4, init_adapters=init)
        st = gate.finish()
        results.append(([id(u) for u, _, _ in agg.calls],
                        [w for _, w, _ in agg.calls],
                        (st.accepted, st.quarantined, st.rejected_nonfinite,
                         st.rejected_duplicate, st.quorum_met)))
    (ids, w, st), (jids, jw, jst) = results
    assert ids == jids and st == jst
    assert st[1] == outliers
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-6)


QUICK = dict(name="quickstart-tiny", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=256, dtype="float32")


def test_faulty_rounds_equal_reference_trainer():
    """Two rounds under drop, corrupt, duplicate, NaN and scale faults with
    the ``full`` gate and the int8 wire, the reference's params carried in:
    every counter and wire byte count equal, eval loss within 1e-4."""
    from repro.common.config import FedConfig as JFedConfig
    from repro.common.config import LoRAConfig as JLoRAConfig
    from repro.common.config import ModelConfig as JModelConfig
    from repro.common.config import OptimConfig as JOptimConfig
    from repro.core.federated import FederatedTrainer as JTrainer
    from repro_torch.convert import adapters_from_numpy, params_from_numpy
    rates = dict(drop=0.15, corrupt=0.2, duplicate=0.15, nan=0.15, scale=0.15)
    fedkw = dict(num_clients=10, clients_per_round=6, homogeneous_rank=8,
                 tau=0.9, seed=0)
    kw = dict(batch_size=4, local_steps=2, seq_len=16, transport="int8")
    jt = JTrainer(JModelConfig(**QUICK), JFedConfig(**fedkw),
                  JLoRAConfig(rank=8, alpha=8.0), JOptimConfig(lr=3e-3),
                  faults=JFaultPlan(seed=2, **rates),
                  validation=JGate("full"), **kw)
    tt = FederatedTrainer(ModelConfig(**QUICK), FedConfig(**fedkw),
                          LoRAConfig(rank=8, alpha=8.0), OptimConfig(lr=3e-3),
                          faults=FaultPlan(seed=2, **rates),
                          validation=ValidationGate("full"), device="cpu", **kw)
    tt.params = params_from_numpy(jax.device_get(jt.params), "cpu")
    tt.A_init_full = adapters_from_numpy(jax.device_get(jt.A_init_full), "cpu")
    for rnd in range(2):
        jrec, rec = jt.run_round(rnd), tt.run_round(rnd)
        for k in ("retries", "dead_clients", "rejected", "quarantined",
                  "quorum_met", "upload_bytes", "download_bytes",
                  "upload_params", "download_params", "sim_secs"):
            assert getattr(rec, k) == getattr(jrec, k), k
        assert rec.eval_loss == pytest.approx(jrec.eval_loss, abs=1e-4)
    assert any(r.retries for r in tt.history)
    assert any(r.rejected for r in tt.history)


CFG = ModelConfig(name="ft-tiny", family="dense", num_layers=2, d_model=32,
                  num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
                  vocab_size=128, dtype="float32")


def _trainer(**kw):
    fed = FedConfig(num_clients=10, clients_per_round=4, tau=0.9,
                    homogeneous_rank=4, seed=0)
    kw.setdefault("local_steps", 1)
    return FederatedTrainer(CFG, fed, LoRAConfig(rank=4, alpha=4.0),
                            OptimConfig(lr=3e-3), batch_size=4, seq_len=16,
                            device="cpu", **kw)


def _strip(rec):
    d = dataclasses.asdict(rec)
    for k in ("wall_secs", "finalize_secs", "sim_secs", "resumes"):
        d.pop(k)
    return d


def _products(tree):
    out = {}
    for path in adapter_leaf_paths(tree):
        B, A = fold_scale(get_path(tree, path))
        out[path] = (B.double() @ A.double()).numpy()
    return out


def _resume_bit_exact(tmp_path, crash_round, point, rounds=3, **kw):
    ref_tr = _trainer(**kw)
    ref = ref_tr.run(rounds)
    ck = os.path.join(str(tmp_path), "fed.ckpt")
    plan = FaultPlan(seed=0, crashes=((crash_round, point),))
    t1 = _trainer(faults=plan, **kw)
    with pytest.raises(ServerCrash):
        t1.run(rounds, checkpoint=ck, checkpoint_every=1)
    t2 = _trainer(faults=plan.without_crashes(), **kw)
    hist = t2.run(rounds, checkpoint=ck, checkpoint_every=1, resume=True)
    assert [_strip(r) for r in hist] == [_strip(r) for r in ref]
    assert any(r.resumes for r in hist) or crash_round == 0
    pr = _products(ref_tr.global_state.global_adapters)
    pt = _products(t2.global_state.global_adapters)
    for path in pr:
        np.testing.assert_array_equal(pr[path], pt[path])
    return t2


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_crash_resume_bit_exact_sequential(tmp_path, point):
    _resume_bit_exact(tmp_path, 1, point)


def test_crash_resume_bit_exact_cohort(tmp_path):
    _resume_bit_exact(tmp_path, 1, "mid_round", runner="cohort")


def test_crash_resume_round_zero_before_any_checkpoint(tmp_path):
    _resume_bit_exact(tmp_path, 0, "mid_round", rounds=2)


def test_crash_resume_restores_async_pool(tmp_path):
    t2 = _resume_bit_exact(tmp_path, 1, "post_round", scheduler="async",
                           runner="cohort")
    assert t2.scheduler._in_flight


def test_resume_skips_completed_rounds(tmp_path):
    ck = os.path.join(str(tmp_path), "fed.ckpt")
    t1 = _trainer()
    t1.run(2, checkpoint=ck)
    runs = []
    t2 = _trainer()
    orig = t2.run_round
    t2.run_round = lambda rnd: runs.append(rnd) or orig(rnd)
    hist = t2.run(2, checkpoint=ck, resume=True)
    assert runs == [] and len(hist) == 2
    assert [_strip(r) for r in hist] == [_strip(r) for r in t1.history]
