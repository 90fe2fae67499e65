"""DeepSeek-V3's SMOKE model (one dense MLA layer and two MLA-MoE layers,
fp32) trained and prefilled through ``mla_fwd`` against the JAX reference,
its parameters and a classic adapter tree with non-zero B carried across:
one ``make_train_step`` step (loss, the MoE aux and every updated adapter
leaf within 1e-4 of max(1, |y|), the reference's MLA tolerance),
``make_prefill_step``'s logits, and a cohort's per-client ``wkv_b`` fold
(and per-client MoE routing) against each client's own forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.common.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.configs import lora_targets as j_lora_targets  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro.peft.lora import init_lora as j_init_lora  # noqa: E402
from repro.train import step as JStep  # noqa: E402
from repro_torch.common.config import OptimConfig  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import adamw_init, tree_leaves, tree_map  # noqa: E402
from repro_torch.train import step as Step  # noqa: E402

from test_torch_mla_forward import CFG, JCFG, TOL, _close, one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def smoke():
    jparams = JT.init(JCFG, jax.random.PRNGKey(0))
    jad = j_init_lora(jparams, j_lora_targets(JCFG), 4, 8.0,
                      jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)

    def nonzero_b(path, leaf):
        if getattr(path[-1], "key", None) == "B":
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.05, leaf.dtype)
        return leaf

    jad = jax.tree_util.tree_map_with_path(nonzero_b, jad)
    return (jparams, jad, params_from_numpy(jax.device_get(jparams), "cpu"),
            adapters_from_numpy(jax.device_get(jad), "cpu"))


def test_smoke_train_step_matches_reference(smoke):
    """One AdamW step of the SMOKE model (the MoE aux in the loss) on both
    packages: loss, aux and every updated adapter leaf."""
    jparams, jad, params, ad = smoke
    rng = np.random.default_rng(3)
    toks = rng.integers(0, CFG.vocab_size, (2, 16))
    mask = np.ones((2, 16), np.float32)
    jstep = jax.jit(JStep.make_train_step(JCFG, JOptimConfig(lr=1e-2),
                                          remat=False, loss_chunk=8))
    jnew, _, jm = jstep(jparams, jad, j_adamw_init(jad),
                        {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)})
    step = Step.make_train_step(CFG, OptimConfig(lr=1e-2), loss_chunk=8,
                                use_kernels=True)
    new, _, m = step(params, ad, adamw_init(ad),
                     {"tokens": torch.as_tensor(toks),
                      "loss_mask": torch.as_tensor(mask)})
    assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL
    assert abs(float(m["aux"]) - float(jm["aux"])) <= 1e-5 * float(jm["aux"])
    want = jax.tree_util.tree_leaves(jax.device_get(jnew))
    got = tree_leaves(new)
    assert len(got) == len(want)
    for gv, wv in zip(got, want):
        _close(gv, wv)


def test_smoke_prefill_step_matches_reference(smoke):
    jparams, jad, params, ad = smoke
    toks = np.random.default_rng(4).integers(0, CFG.vocab_size, (2, 12))
    want = JStep.make_prefill_step(JCFG)(jparams, jad,
                                         {"tokens": jnp.asarray(toks)})
    got = Step.make_prefill_step(CFG, use_kernels=True)(
        params, ad, {"tokens": torch.as_tensor(toks)})
    _close(got, want)


def test_cohort_folds_wkv_b_per_client(smoke):
    """A cohort forward of two clients (different adapters, each folding
    its own ``wkv_b`` delta on the absorbed route, each routed alone by the
    MoE layers) equals each client's own forward."""
    _, _, params, ad = smoke
    gen = torch.Generator().manual_seed(5)
    other = tree_map(lambda t: t + 0.05 * torch.randn(t.shape, generator=gen)
                     if t.dim() == 3 else t, ad)
    stacked = tree_map(lambda *xs: torch.stack(xs), ad, other)
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, 512, (4, 8)))
    h, aux = T.forward(CFG, params, {"tokens": toks}, stacked, cohort=2)
    assert aux.shape == (2,)
    for c, tree in enumerate((ad, other)):
        hc, ac = T.forward(CFG, params, {"tokens": toks[2 * c:2 * c + 2]}, tree)
        _close(h[2 * c:2 * c + 2], hc.detach().numpy(), 1e-5)
        assert abs(float(aux[c]) - float(ac)) <= 1e-6
