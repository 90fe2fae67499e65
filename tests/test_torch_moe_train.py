"""The MoE training path against the JAX reference: ``loss_fn`` with the
``router_aux_coef · aux`` term (coefficient raised to 0.5) and the
adapters' gradients, on both SMOKE configs (the loss within 1e-5, each
gradient within 1e-4 of max(1, |g|)), and the eval step's aux.  The
cohort: ``test_torch_moe_cohort.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train import step as JStep  # noqa: E402
from repro_torch.train import step as Step  # noqa: E402

from test_torch_moe import _close  # noqa: E402
from test_torch_moe_model import model, one_thread  # noqa: E402,F401


def test_loss_and_gradients_with_aux_match_reference(model):
    """``loss_fn`` adds ``router_aux_coef · aux`` (coefficient raised to
    0.5 so the term is felt), and the adapters' gradients match the
    reference's ``jax.grad``."""
    cfg, jcfg, jparams, jad, params, ad = model
    cfg, jcfg = (c.replace(router_aux_coef=0.5) for c in (cfg, jcfg))
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (2, 16))
    mask = (rng.random((2, 16)) < 0.7).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": torch.as_tensor(toks), "loss_mask": torch.as_tensor(mask)}
    (jloss, jm), jg = jax.value_and_grad(
        lambda a: JStep.loss_fn(jcfg, jparams, a, jb, loss_chunk=8),
        has_aux=True)(jad)
    leaves = Step.tree_leaves(ad)
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    a = Step._unflatten(ad, leaves)
    loss, m = Step.loss_fn(cfg, params, a, tb, loss_chunk=8)
    assert float(m["aux"].detach()) > 0
    assert abs(float(loss) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    assert abs(float(loss) - float(m["loss"]) - 0.5 * float(m["aux"])) <= 1e-5
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree_util.tree_leaves(jax.device_get(jg))
    assert len(want) == len(grads)
    for gv, wv in zip(grads, want):
        _close(gv, wv, 1e-4)
    ev = Step.make_eval_step(cfg, loss_chunk=8)(params, ad, tb)
    assert abs(float(ev["aux"]) - float(jm["aux"])) <= 1e-5
