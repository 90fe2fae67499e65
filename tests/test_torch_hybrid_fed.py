"""Federated fine-tuning of the Zamba2 hybrid against the JAX reference, on
its ``zamba2-smoke`` config (fp32), LoRA on the six hybrid targets (``wq
wk wv wo`` of the shared block, 2-D leaves; ``in_proj out_proj`` of the
Mamba2 stacks).

A FLoRIST round on the sequential runner against the reference's trainer,
its params and shared A init carried across (kept ranks equal, eval loss
within 1e-4, the finalized ΔW within 1e-4 · max(1, |ΔW|)); the cohort
runner against the sequential one (the same limits); and the cohort
forward's reading of the shared block's (C, r, d) client stacks as
clients, not as a layer stack: each client's rows equal its own forward's
within 1e-5.  The launchers run the three new configs on the CPU.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.common.config import FedConfig as JFedConfig  # noqa: E402
from repro.common.config import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.common.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.core.federated import FederatedTrainer as JTrainer  # noqa: E402
from repro_torch.common.config import FedConfig, LoRAConfig, OptimConfig  # noqa: E402
from repro_torch.configs import lora_targets, zamba2_1p2b  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core.aggregators import adapter_leaf_paths, fold_scale, get_path  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import tree_map  # noqa: E402
from repro_torch.peft.lora import init_lora  # noqa: E402

from test_torch_moe_model import one_thread  # noqa: E402,F401

JCFG = get_smoke_config("zamba2-1.2b")
CFG = zamba2_1p2b.SMOKE
TARGETS = lora_targets(CFG)
FED = dict(num_clients=6, clients_per_round=4, method="florist", tau=0.9,
           homogeneous_rank=4, seed=1)
KW = dict(batch_size=4, local_steps=2, seq_len=16)


def _products(tree):
    out = {}
    for path in adapter_leaf_paths(tree):
        B, A = fold_scale(get_path(tree, path))
        out[path] = np.asarray(torch.as_tensor(B).double()
                               @ torch.as_tensor(A).double())
    return out


def _close(got, want, tol):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _trainer(runner):
    return FederatedTrainer(CFG, FedConfig(**FED),
                            LoRAConfig(rank=4, alpha=4.0, targets=TARGETS),
                            OptimConfig(lr=3e-3), runner=runner, device="cpu",
                            **KW)


def test_florist_round_matches_reference():
    """One round, sequential runner: the shared block's leaves are one
    layer each (``leaf_dims`` L 1), the Mamba2 stacks L 2."""
    jt = JTrainer(JCFG, JFedConfig(**FED),
                  JLoRAConfig(rank=4, alpha=4.0, targets=TARGETS),
                  JOptimConfig(lr=3e-3), **KW)
    tt = _trainer("sequential")
    tt.params = params_from_numpy(jax.device_get(jt.params), "cpu")
    tt.A_init_full = adapters_from_numpy(jax.device_get(jt.A_init_full), "cpu")
    jrec, rec = jt.run_round(0), tt.run_round(0)
    ranks = tt.global_state.ranks
    assert ranks == {p: [int(v) for v in r]
                     for p, r in jt.global_state.ranks.items()}
    assert len(ranks[("shared_blk", "attn", "wq")]) == 1
    assert len(ranks[("blocks", 0, "mixer", "in_proj")]) == 2
    assert rec.eval_loss == pytest.approx(jrec.eval_loss, abs=1e-4)
    for k in ("upload_params", "download_params", "global_rank_total"):
        assert getattr(rec, k) == getattr(jrec, k), k
    want = _products(jax.device_get(jt.global_state.global_adapters))
    got = _products(tt.global_state.global_adapters)
    assert set(got) == set(want)
    for p in want:
        _close(got[p], want[p], 1e-4)


def test_cohort_runner_matches_sequential():
    seq, coh = _trainer("sequential"), _trainer("cohort")
    coh.params, coh.A_init_full = seq.params, seq.A_init_full
    a, b = seq.run_round(0), coh.run_round(0)
    assert coh.global_state.ranks == seq.global_state.ranks
    assert b.eval_loss == pytest.approx(a.eval_loss, abs=1e-4)
    want = _products(seq.global_state.global_adapters)
    got = _products(coh.global_state.global_adapters)
    for p in want:
        _close(got[p], want[p], 1e-4)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_cohort_forward_reads_shared_stacks_as_clients(use_kernels):
    """Three clients (C 3) and two layers a Mamba2 segment: the shared
    block's (3, r, d) leaves are client stacks whose leading axis must not
    be read as layers.  Each client's rows equal its own forward."""
    params = T.init(CFG, 0, "cpu")
    gen = torch.Generator().manual_seed(3)
    trees = []
    for _ in range(3):
        t = init_lora(params, TARGETS, 4, 8.0, gen)
        trees.append(tree_map(lambda x: x + 0.01 * torch.randn(
            x.shape, generator=gen), t))
    stacked = tree_map(lambda *xs: torch.stack(xs), *trees)
    assert stacked["shared_blk"]["attn"]["wq"]["A"].shape == (3, 4, CFG.d_model)
    toks = torch.randint(0, CFG.vocab_size, (3, 2, 16), generator=gen)
    got, _ = T.forward(CFG, params, {"tokens": toks.reshape(6, 16)}, stacked,
                       use_kernels=use_kernels, cohort=3)
    for c in range(3):
        want, _ = T.forward(CFG, params, {"tokens": toks[c]}, trees[c],
                            use_kernels=use_kernels)
        _close(got[2 * c: 2 * c + 2].detach().numpy(), want.detach().numpy(), 1e-5)


def test_launchers_run_the_three_configs(capsys):
    """``launch.serve`` serves the three SMOKE configs on the CPU (16 of 16
    requests), ``launch.train`` and ``launch.fed --arch ... --smoke``
    (cohort runner) take zamba2; the full-width configs are in
    ``launch.serve``."""
    from repro_torch.launch import fed, serve, train
    for key in ("zamba2_smoke", "phi3_vision_smoke", "musicgen_smoke"):
        out = serve.serve(key, device="cpu", log=lambda s: None)
        assert len(out["results"]) == serve.N_REQUESTS
        assert all(len(t) == serve.MAX_TOKENS for t in out["results"].values())
    assert {k: serve.CONFIGS[k][0].family for k in (
        "zamba2_1p2b", "phi3_vision_4p2b", "musicgen_medium")} == {
        "zamba2_1p2b": "hybrid", "phi3_vision_4p2b": "vlm",
        "musicgen_medium": "audio"}
    hist = fed.main(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu",
                     "--rounds", "1", "--clients", "4", "--sample", "2",
                     "--local-steps", "1", "--runner", "cohort"])
    assert len(hist) == 1 and np.isfinite(hist[0].eval_loss)
    train.main(["--arch", "zamba2-1.2b", "--smoke", "--steps", "2", "--seq", "16",
                "--device", "cpu", "--use-kernels"])
    assert "final eval: loss=" in capsys.readouterr().out
