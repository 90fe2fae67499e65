"""The cohort on a MoE model against the JAX reference.  The cohort routes each client's rows on their own, as the reference's
``vmap`` of one client's step does: the port's ``cohort`` runner against
the reference's on a tiny MoE model (eval loss within 1e-4, the global
ΔW within 5e-4 of max(1, |ΔW|), the reference's own cohort tolerance),
once with full batches and once on a ragged cohort (clients with fewer
samples than the batch: their rows padded with zero-masked ones); the
port's cohort against its sequential runner where no row is padded (the
same limits); and the property the ragged case rests on, as in the
reference: a client's padded rows are routed with its real rows and
enter its aux, so they are not inert.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.common.config import FedConfig as JFedConfig  # noqa: E402
from repro.common.config import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.common.config import ModelConfig as JModelConfig  # noqa: E402
from repro.common.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.core.federated import FederatedTrainer as JTrainer  # noqa: E402
from repro.data.synthetic import make_federated_data as j_make_data  # noqa: E402
from repro_torch.common.config import (FedConfig, LoRAConfig,  # noqa: E402
                                       ModelConfig, OptimConfig)
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core.aggregators import (adapter_leaf_paths,  # noqa: E402
                                          fold_scale, get_path)
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.data.synthetic import make_federated_data  # noqa: E402
from repro_torch.optim.adamw import adamw_init, tree_map  # noqa: E402
from repro_torch.peft.lora import init_lora  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import step as Step  # noqa: E402

from test_torch_moe import _close  # noqa: E402
from test_torch_moe_model import one_thread  # noqa: E402,F401

TINY_MOE = dict(name="moe-tiny", family="moe", num_layers=1, d_model=64,
                num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32,
                vocab_size=256, num_experts=4, experts_per_token=2,
                moe_d_ff=32, router_aux_coef=0.05, dtype="float32")


def _products(tree):
    out = {}
    for path in adapter_leaf_paths(tree):
        B, A = fold_scale(get_path(tree, path))
        out[path] = np.asarray(torch.as_tensor(B).double()
                               @ torch.as_tensor(A).double())
    return out


def _pair(ragged: bool, runner="cohort", reference=True):
    """The reference's and the port's trainers on one tiny MoE model, the
    reference's params and shared A init carried in.  ``ragged``: clients
    of 4–9 samples against batches of 8."""
    fedkw = dict(num_clients=6, clients_per_round=4, method="florist",
                 tau=0.9, homogeneous_rank=4, seed=2)
    data = dict(num_clients=6, seq_len=16, seed=3,
                mean_samples=5 if ragged else 32)
    kw = dict(batch_size=8 if ragged else 4, local_steps=2, seq_len=16)
    jt = JTrainer(JModelConfig(**TINY_MOE), JFedConfig(**fedkw),
                  JLoRAConfig(rank=4, alpha=4.0), JOptimConfig(lr=3e-3),
                  clients=j_make_data(**data), runner=runner,
                  **kw) if reference else None
    tt = FederatedTrainer(ModelConfig(**TINY_MOE), FedConfig(**fedkw),
                          LoRAConfig(rank=4, alpha=4.0), OptimConfig(lr=3e-3),
                          clients=make_federated_data(**data), runner=runner,
                          device="cpu", **kw)
    if jt is not None:
        tt.params = params_from_numpy(jax.device_get(jt.params), "cpu")
        tt.A_init_full = adapters_from_numpy(jax.device_get(jt.A_init_full),
                                             "cpu")
    return jt, tt


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_cohort_runner_matches_reference_cohort(ragged):
    jt, tt = _pair(ragged)
    if ragged:
        sizes = [tt.clients[t].num_samples for t in range(6)]
        assert min(sizes) < tt.batch_size, sizes      # rows are padded
    jrec, rec = jt.run_round(0), tt.run_round(0)
    assert tt.global_state.ranks == {
        p: [int(v) for v in r] for p, r in jt.global_state.ranks.items()}
    assert rec.eval_loss == pytest.approx(jrec.eval_loss, abs=1e-4)
    want = _products(jax.device_get(jt.global_state.global_adapters))
    got = _products(tt.global_state.global_adapters)
    for p in want:
        _close(got[p], want[p], 5e-4)


def test_cohort_matches_sequential_where_no_row_is_padded():
    _, seq = _pair(False, "sequential", reference=False)
    _, coh = _pair(False, "cohort", reference=False)
    coh.params = seq.params
    coh.A_init_full = seq.A_init_full
    a, b = seq.run_round(0), coh.run_round(0)
    assert b.eval_loss == pytest.approx(a.eval_loss, abs=1e-4)
    want = _products(seq.global_state.global_adapters)
    got = _products(coh.global_state.global_adapters)
    for p in want:
        _close(got[p], want[p], 5e-4)


def test_padded_rows_are_routed_and_enter_the_aux():
    """One cohort step of two clients, the second's last row padded (zero
    tokens, zero mask): each client's aux is its own rows' MoE aux, the
    padded row included, and the padded row moves the second client's aux
    (so the padding is not inert under MoE); the first client's aux is the
    one its own step computes."""
    cfg = ModelConfig(**TINY_MOE)
    params = T.init(cfg, 0, "cpu")
    gen = torch.Generator().manual_seed(0)
    trees = [init_lora(params, ("wq", "wv"), 4, 4.0, gen) for _ in range(2)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *trees)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(1, 256, (2, 3, 16)))
    mask = torch.ones(2, 3, 16)
    toks[1, 2], mask[1, 2] = 0, 0.0
    step = Step.make_cohort_train_step(cfg, OptimConfig(lr=1e-3), loss_chunk=8)
    _, _, m = step(params, stacked, adamw_init(stacked),
                   {"tokens": toks, "loss_mask": mask})
    for c, rows in ((0, 3), (1, 3)):
        _, mc = Step.loss_fn(cfg, params, trees[c],
                             {"tokens": toks[c, :rows],
                              "loss_mask": mask[c, :rows]}, loss_chunk=8)
        assert abs(float(m["aux"][c]) - float(mc["aux"])) <= 1e-6
    _, short = Step.loss_fn(cfg, params, trees[1],
                            {"tokens": toks[1, :2], "loss_mask": mask[1, :2]},
                            loss_chunk=8)
    assert abs(float(m["aux"][1]) - float(short["aux"])) > 1e-4


def test_launchers_run_the_moe_configs(capsys):
    """``launch.fed --arch granite-moe-1b-a400m --smoke`` (cohort runner),
    ``launch.train --arch granite-moe-1b-a400m --smoke`` and
    ``launch.serve --config granite_smoke`` / ``deepseek_moe_smoke`` run
    on the CPU; the full-width MoE configs are in ``launch.serve``."""
    from repro_torch.launch import fed, serve, train
    hist = fed.main(["--arch", "granite-moe-1b-a400m", "--smoke", "--device",
                     "cpu", "--rounds", "1", "--clients", "4", "--sample", "2",
                     "--local-steps", "1", "--runner", "cohort"])
    assert len(hist) == 1 and np.isfinite(hist[0].eval_loss)
    train.main(["--arch", "granite-moe-1b-a400m", "--smoke", "--steps", "2",
                "--seq", "16", "--device", "cpu"])
    assert "final eval: loss=" in capsys.readouterr().out
    for key in ("granite_smoke", "deepseek_moe_smoke"):
        out = serve.serve(key, device="cpu", log=lambda s: None)
        assert len(out["results"]) == serve.N_REQUESTS
    assert serve.CONFIGS["granite_moe_1b_a400m"][0].num_experts == 32
    assert T.layer_plan(serve.CONFIGS["deepseek_v3_l4"][0]) == [
        ("mla_dense", 3), ("mla_moe", 1)]
