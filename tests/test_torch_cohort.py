"""The cohort runner against the reference's, and the client axis under it.

``ops.lora_matmul`` with a cohort leaf (A (C, r, din), B (C, dout, r),
scale (C,)) on the CPU, and its gradients (dx, dA, dB and a ``ds`` that
sums over each client's rows only), against a per-client loop of the
2-D op within 1e-5; ``lora_proj``'s plain cohort delta likewise; one
``make_cohort_train_step`` against each client's own ``make_train_step``
(per-client clipping and moments); the port's ``cohort`` runner against
the reference's ``cohort`` runner (``jax.vmap`` of a ``lax.scan``), the
reference's params and shared A init carried in, homogeneous and
heterogeneous ranks: eval loss within 1e-4 and the global ΔW within 5e-4
of max(1, |ΔW|) (the reference's own tolerance)."""
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
from repro_torch.core.aggregators import (adapter_leaf_paths, fold_scale,  # noqa: E402
                                          get_path)
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.core.runtime import (CohortRunner, ShardedCohortRunner,  # noqa: E402
                                      make_runner)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim.adamw import adamw_init, tree_map  # noqa: E402
from repro_torch.peft.lora import lora_proj  # noqa: E402
from repro_torch.train.step import make_cohort_train_step, make_train_step  # noqa: E402

QUICK = dict(name="quickstart-tiny", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=256, dtype="float32")


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test (the suite runs files on parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("C,rows,din,dout,r", [(4, 24, 32, 16, 4),
                                                (3, 7, 20, 12, 5),
                                                (1, 10, 16, 16, 2)])
def test_client_axis_lora_matmul_and_grads_match_per_client_loop(C, rows, din,
                                                                 dout, r):
    rng = np.random.default_rng(C * 100 + rows)
    x = torch.tensor(rng.normal(size=(C * rows, din)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(din, dout)) / din ** 0.5, dtype=torch.float32)
    a = torch.tensor(rng.normal(size=(C, r, din)) * 0.3, dtype=torch.float32,
                     requires_grad=True)
    b = torch.tensor(rng.normal(size=(C, dout, r)) * 0.3, dtype=torch.float32,
                     requires_grad=True)
    s = torch.tensor(rng.uniform(0.5, 2.0, size=C), dtype=torch.float32,
                     requires_grad=True)
    g = torch.tensor(rng.normal(size=(C * rows, dout)), dtype=torch.float32)
    y = ops.lora_matmul(x, w, a, b, s)
    grads = torch.autograd.grad(y, (x, a, b, s), g)
    xs = x.detach().reshape(C, rows, din)
    ys, gx, ga, gb, gs = [], [], [], [], []
    for c in range(C):
        xc, ac, bc, sc = (t.detach().clone().requires_grad_(True)
                          for t in (xs[c], a[c], b[c], s[c]))
        yc = ops.lora_matmul(xc, w, ac, bc, sc)
        d = torch.autograd.grad(yc, (xc, ac, bc, sc), g.reshape(C, rows, dout)[c])
        ys.append(yc.detach())
        for lst, v in zip((gx, ga, gb, gs), d):
            lst.append(v)
    _close(y.detach(), torch.cat(ys), 1e-5)
    _close(grads[0], torch.cat(gx), 1e-5)
    _close(grads[1], torch.stack(ga), 1e-5)
    _close(grads[2], torch.stack(gb), 1e-5)
    _close(grads[3], torch.stack(gs), 1e-5)       # each client's rows only
    assert grads[3].shape == (C,)


def test_lora_proj_plain_cohort_delta_matches_per_client():
    rng = np.random.default_rng(2)
    C, B, S, din, dout, r = 3, 2, 5, 16, 12, 4
    x = torch.tensor(rng.normal(size=(C * B, S, din)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(din, dout)), dtype=torch.float32)
    leaf = {"A": torch.tensor(rng.normal(size=(C, r, din)), dtype=torch.float32),
            "B": torch.tensor(rng.normal(size=(C, dout, r)), dtype=torch.float32),
            "scale": torch.tensor([0.5, 1.0, 2.0])}
    for use_kernel in (False, True):
        got = lora_proj(x, w, leaf, use_kernel)
        want = torch.cat([lora_proj(x[c * B:(c + 1) * B], w,
                                    {k: v[c] for k, v in leaf.items()})
                          for c in range(C)])
        _close(got, want, 1e-5)


@pytest.mark.parametrize("b_only", [False, True])
def test_cohort_step_matches_each_clients_own_step(b_only):
    """Three clients (one with a zero mask: an inert padding replica) in
    one cohort step against each client's own train step, three steps, a
    learning rate large enough that the per-client clip bites."""
    cfg = ModelConfig(**{**QUICK, "num_layers": 1})
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    params = T.init(cfg, 0, "cpu")
    gen = torch.Generator().manual_seed(0)
    opt = OptimConfig(lr=1e-2, grad_clip=0.05)
    trees = []
    for c in range(3):
        t = init_lora(params, ("wq", "wv"), 4, 4.0, gen)
        t = tree_map(lambda v: v + 0.05 * torch.randn(v.shape, generator=gen)
                     if v.dim() == 3 else v, t)
        trees.append(t)
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, 256, (3, 3, 2, 12)))
    mask = torch.ones(3, 3, 2, 12)
    mask[2] = 0.0                                        # the inert replica
    mask[1, :, 1, 6:] = 0.0                              # a ragged row
    cohort = make_cohort_train_step(cfg, opt, loss_chunk=8, use_kernels=True,
                                    b_only=b_only)
    single = make_train_step(cfg, opt, loss_chunk=8, use_kernels=True,
                             b_only=b_only)
    stacked = tree_map(lambda *xs: torch.stack(xs), *trees)
    st = adamw_init(stacked)
    for i in range(3):
        stacked, st, m = cohort(params, stacked, st,
                                {"tokens": toks[:, i], "loss_mask": mask[:, i]})
    assert m["loss"].shape == (3,) and float(m["loss"][2]) == 0.0
    for c in range(3):
        ad, so = trees[c], adamw_init(trees[c])
        for i in range(3):
            ad, so, _ = single(params, ad, so, {"tokens": toks[c, i],
                                                "loss_mask": mask[c, i]})
        got = tree_map(lambda v: v[c], stacked)
        for p in adapter_leaf_paths(ad):
            for n in ("A", "B", "scale"):
                _close(get_path(got, p)[n].detach(), get_path(ad, p)[n].detach(),
                       1e-5)
    frozen = tree_map(lambda v: v[2], stacked)
    for p in adapter_leaf_paths(frozen):
        assert torch.equal(get_path(frozen, p)["A"], get_path(trees[2], p)["A"])


def _products(tree):
    out = {}
    for path in adapter_leaf_paths(tree):
        B, A = fold_scale(get_path(tree, path))
        out[path] = np.asarray(torch.as_tensor(B).double()
                               @ torch.as_tensor(A).double())
    return out


@pytest.mark.parametrize("heter", [False, True], ids=["hom", "het"])
def test_cohort_runner_matches_reference_cohort(heter):
    fedkw = dict(num_clients=10, clients_per_round=5, method="florist",
                 tau=0.9, homogeneous_rank=8, heterogeneous=heter,
                 rank_distribution=((4, 5), (8, 5)), seed=2)
    kw = dict(batch_size=4, local_steps=3, seq_len=16, runner="cohort")
    jt = JTrainer(JModelConfig(**QUICK), JFedConfig(**fedkw),
                  JLoRAConfig(rank=8, alpha=8.0), JOptimConfig(lr=3e-3), **kw)
    runner = CohortRunner(record_steps=True)
    tt = FederatedTrainer(ModelConfig(**QUICK), FedConfig(**fedkw),
                          LoRAConfig(rank=8, alpha=8.0), OptimConfig(lr=3e-3),
                          device="cpu", **{**kw, "runner": runner})
    tt.params = params_from_numpy(jax.device_get(jt.params), "cpu")
    tt.A_init_full = adapters_from_numpy(jax.device_get(jt.A_init_full), "cpu")
    for rnd in range(2):
        jrec, rec = jt.run_round(rnd), tt.run_round(rnd)
        assert tt.global_state.ranks == {
            p: [int(v) for v in r] for p, r in jt.global_state.ranks.items()}
        for k in ("upload_bytes", "download_bytes", "upload_params"):
            assert getattr(rec, k) == getattr(jrec, k), k
        assert rec.eval_loss == pytest.approx(jrec.eval_loss, abs=1e-4)
        want = _products(jax.device_get(jt.global_state.global_adapters))
        got = _products(tt.global_state.global_adapters)
        for p in want:
            _close(got[p], want[p], 5e-4)
    # one cohort step a local step and (rank, steps) cohort
    cohorts = 2 if heter else 1
    log = runner.step_log()
    assert len(log) <= 2 * cohorts * 3 and len(log) % 3 == 0
    assert runner.peak_live_clients in (4, 8)


def test_cohort_runner_delivers_in_plan_order_with_snapshots():
    """Plan-order delivery, the async snapshot as the task's init, and the
    power-of-two padding recorded in ``peak_live_clients``."""
    cfg = ModelConfig(**{**QUICK, "num_layers": 1})
    tr = FederatedTrainer(cfg, FedConfig(num_clients=12, clients_per_round=6,
                                         heterogeneous=True,
                                         rank_distribution=((4, 6), (8, 6)),
                                         seed=0),
                          LoRAConfig(rank=8, alpha=8.0), OptimConfig(),
                          batch_size=4, local_steps=1, seq_len=8,
                          runner="cohort", scheduler="async", device="cpu")
    plan = tr.scheduler.plan(0, tr)
    got = []
    tr.runner.run(tr, plan, lambda t, ad, init: got.append((t, init)))
    assert [t.client_id for t, _ in got] == [t.client_id for t in plan.tasks]
    assert all(init is t.init_adapters for t, init in got)
    sizes = {}
    for t in plan.tasks:
        sizes[t.rank] = sizes.get(t.rank, 0) + 1
    assert tr.runner.peak_live_clients == max(1 << (n - 1).bit_length()
                                              for n in sizes.values())


@pytest.mark.parametrize("runner", ["sequential", "cohort", "sharded_cohort"])
def test_runners_deliver_one_form(runner):
    """Both runners hand ``deliver`` the same form: A and B as float32
    numpy (one host copy a block), ``scale`` a tensor on the trainer's
    device; and the same trained values."""
    cfg = ModelConfig(**{**QUICK, "num_layers": 1})
    trees = {}
    for name in ("sequential", runner):
        tr = FederatedTrainer(cfg, FedConfig(num_clients=6, clients_per_round=3,
                                             seed=0),
                              LoRAConfig(rank=4, alpha=4.0), OptimConfig(),
                              batch_size=2, local_steps=2, seq_len=8,
                              runner=name, device="cpu")
        plan = tr.scheduler.plan(0, tr)
        got = []
        tr.runner.run(tr, plan, lambda t, ad, init: got.append(ad))
        trees[name] = got
    for tree, ref in zip(trees[runner], trees["sequential"]):
        for path in adapter_leaf_paths(tree):
            leaf, want = get_path(tree, path), get_path(ref, path)
            for n in ("A", "B"):
                assert isinstance(leaf[n], np.ndarray)
                assert leaf[n].dtype == np.float32
                _close(leaf[n], want[n], 1e-5)
            assert isinstance(leaf["scale"], torch.Tensor)
            assert leaf["scale"].device.type == "cpu"


def test_sharded_cohort_raises_naming_item_9():
    """Ported since the multi-device slice: ``make_runner`` builds the
    sharded runner (block 256), and in one process (a one-rank fed mesh) it
    trains each block of a cohort to the cohort runner's trees, delivered
    block by block in cohort-grouped order."""
    runner = make_runner("sharded_cohort")
    assert isinstance(runner, ShardedCohortRunner) and runner.block == 256
    cfg = ModelConfig(**{**QUICK, "num_layers": 1})
    trees = {}
    for name in ("cohort", ShardedCohortRunner(block=2)):
        tr = FederatedTrainer(cfg, FedConfig(num_clients=8, clients_per_round=5,
                                             heterogeneous=True,
                                             rank_distribution=((4, 4), (8, 4)),
                                             seed=1),
                              LoRAConfig(rank=8, alpha=8.0), OptimConfig(),
                              batch_size=2, local_steps=2, seq_len=8,
                              runner=name, device="cpu")
        plan = tr.scheduler.plan(0, tr)
        got = []
        tr.runner.run(tr, plan, lambda t, ad, init: got.append((t.client_id, ad)))
        trees[tr.runner.name] = got
    order = [t.client_id for r in dict.fromkeys(t.rank for t in plan.tasks)
             for t in plan.tasks if t.rank == r]
    assert [c for c, _ in trees["sharded_cohort"]] == order
    ref = dict(trees["cohort"])
    for cid, tree in trees["sharded_cohort"]:
        for path in adapter_leaf_paths(tree):
            for n in ("A", "B"):
                _close(get_path(tree, path)[n], get_path(ref[cid], path)[n], 1e-5)
    assert tr.runner.peak_live_clients == 2
