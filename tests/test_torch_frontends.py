"""Port parity for the vision and audio front ends against the JAX
reference, on the ``phi-3-vision-smoke`` and ``musicgen-smoke`` configs
(fp32), the reference's parameters carried across through numpy, on
batches built with numpy as ``tests/test_models.py`` builds them: 8
projected ``patch_embeds`` before 32 tokens (vision), or 32
``frame_embeds`` in place of tokens with ``labels`` (audio).

``embed_inputs``, ``forward`` (plain and kernel routes; the kernels' plain
versions on the CPU) and the logits within 1e-5 · max(1, |x|); ``loss_fn``
(the CE over the text tail only for vision, over ``labels`` for audio)
within 1e-5; one train step's gradients and adapters within 1e-5; the
layer plans and trees equal the reference's, ``frontend_proj`` included;
a bf16 model casts the projected embeddings to bf16 after the product.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.common.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.configs import lora_targets as j_lora_targets  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro.peft.lora import init_lora as j_init_lora  # noqa: E402
from repro.train.step import loss_fn as j_loss_fn  # noqa: E402
from repro.train.step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.common.config import OptimConfig  # noqa: E402
from repro_torch.configs import get_config, musicgen_medium, phi3_vision_4p2b  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.serve.adapters import adapter_leaves  # noqa: E402
from repro_torch.train.step import loss_fn, make_prefill_step, make_train_step  # noqa: E402

from test_torch_moe_model import one_thread  # noqa: E402,F401

B, S = 2, 32
PAIRS = {"vision": ("phi-3-vision-4.2b", phi3_vision_4p2b.SMOKE),
         "audio": ("musicgen-medium", musicgen_medium.SMOKE)}


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _batch(cfg, rng, seq=S):
    """numpy batch of ``tests/test_models.py``'s ``_batch``."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, seq)),
             "loss_mask": np.ones((B, seq), np.float32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
        batch["loss_mask"][:, :3] = 0.0            # a masked prefix too
    if cfg.frontend == "audio":
        batch = {"frame_embeds": rng.normal(size=(B, seq, cfg.frontend_dim)).astype(np.float32),
                 "labels": batch["tokens"], "loss_mask": batch["loss_mask"]}
    return batch


def _tb(batch):
    return {k: (_t(v).long() if v.dtype.kind == "i" else _t(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=["vision", "audio"])
def model(request):
    name, cfg = PAIRS[request.param]
    jcfg = get_smoke_config(name)
    rng = np.random.default_rng(0)
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    jad = j_init_lora(jparams, j_lora_targets(jcfg), 4, 8.0,
                      jax.random.PRNGKey(1), sigma=0.05)

    def nonzero_b(path, leaf):
        if getattr(path[-1], "key", None) == "B":
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.05, leaf.dtype)
        return leaf

    jad = jax.tree_util.tree_map_with_path(nonzero_b, jad)
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    ad = adapters_from_numpy(jax.device_get(jad), device="cpu")
    batch = _batch(cfg, rng)
    return jcfg, cfg, jparams, jad, params, ad, batch


def test_plans_and_trees_match_reference():
    from repro.configs import get_config as j_get_config
    for name, cfg in PAIRS.values():
        jcfg = get_smoke_config(name)
        for ours, ref in ((cfg, jcfg), (get_config(name), j_get_config(name))):
            assert T.layer_plan(ours) == JT.layer_plan(ref) == [("dense", ours.num_layers)]
            assert ours.param_count() == ref.param_count()
        jp = jax.device_get(JT.init(jcfg, jax.random.PRNGKey(0)))
        p = T.init(cfg, 0, device="cpu")
        assert set(p) == set(jp) and "frontend_proj" in p
        assert tuple(p["frontend_proj"].shape) == jp["frontend_proj"].shape


def test_embed_inputs_match_reference(model):
    jcfg, cfg, jparams, _, params, _, batch = model
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = JT.embed_inputs(jcfg, jparams, jb)
    got = T.embed_inputs(cfg, params, _tb(batch))
    S_total = S + (cfg.num_patches if cfg.frontend == "vision" else 0)
    assert tuple(got.shape) == (B, S_total, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_logits_and_loss_match_reference(model, use_kernels):
    jcfg, cfg, jparams, jad, params, ad, batch = model
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _ = JT.forward(jcfg, jparams, jb, jad)
    got, _ = T.forward(cfg, params, _tb(batch), ad, use_kernels=use_kernels)
    _close(got, want)
    _close(T.logits(cfg, params, got), JT.logits(jcfg, jparams, want))
    jl, jm = j_loss_fn(jcfg, jparams, jad, jb, loss_chunk=8)
    tl, tm = loss_fn(cfg, params, ad, _tb(batch), 8, use_kernels)
    assert float(tl) == pytest.approx(float(jl), abs=1e-5)
    assert float(tm["accuracy"]) == pytest.approx(float(jm["accuracy"]), abs=1e-6)
    if cfg.frontend == "vision":
        # the patch positions are out of the loss: it is the text tail's
        # next-token CE, masked on target positions
        toks, mask = _tb(batch)["tokens"], _tb(batch)["loss_mask"]
        lg = T.logits(cfg, params, got[:, cfg.num_patches:-1])
        ce = torch.nn.functional.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                               toks[:, 1:].reshape(-1),
                                               reduction="none")
        m = mask[:, 1:].reshape(-1)
        assert float((ce * m).sum() / m.sum()) == pytest.approx(float(tl), abs=1e-5)


def test_train_step_matches_reference(model):
    """One train step on the kernel route: gradients and adapters after
    AdamW (``eps`` 1e-3 on both sides, so the step is a Lipschitz function
    of the gradient, as in ``tests/test_torch_hybrid.py``)."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import _unflatten
    jcfg, cfg, jparams, jad, params, ad, batch = model
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jax.jit(jax.grad(lambda a: j_loss_fn(jcfg, jparams, a, jb, loss_chunk=8)[0]))(jad)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(ad)]
    loss, _ = loss_fn(cfg, params, _unflatten(ad, leaves), _tb(batch), 8, True)
    g = _unflatten(ad, torch.autograd.grad(loss, leaves))
    jgl = dict(adapter_leaves(jax.device_get(jg)))
    for path, leaf in adapter_leaves(g):
        for k in ("A", "B", "scale"):
            _close(leaf[k], jgl[path][k])
    jstep = jax.jit(j_make_train_step(jcfg, JOptimConfig(lr=3e-4, eps=1e-3),
                                      remat=False, loss_chunk=8))
    jnew, _, jm = jstep(jparams, jad, j_adamw_init(jad), jb)
    step = make_train_step(cfg, OptimConfig(lr=3e-4, eps=1e-3), loss_chunk=8,
                           use_kernels=True)
    new, _, m = step(params, ad, adamw_init(ad), _tb(batch))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    jl = dict(adapter_leaves(jax.device_get(jnew)))
    for path, leaf in adapter_leaves(new):
        for k in ("A", "B", "scale"):
            _close(leaf[k], jl[path][k])


def test_prefill_step_takes_frontend_batches(model):
    """``make_prefill_step`` forwards a front end's batch: the last
    position's logits equal the reference forward's."""
    jcfg, cfg, jparams, jad, params, ad, batch = model
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "loss_mask"}
    want, _ = JT.forward(jcfg, jparams, jb, jad)
    want = JT.logits(jcfg, jparams, want[:, -1:])[:, 0]
    got = make_prefill_step(cfg, use_kernels=True)(
        params, ad, {k: v for k, v in _tb(batch).items() if k != "loss_mask"})
    _close(got, want)


@pytest.mark.parametrize("frontend", ["vision", "audio"])
def test_bf16_embeddings_are_cast_after_the_product(frontend):
    """In a bf16 model the fp32 embeddings meet the bf16 projection in
    fp32 (jnp's promotion) and the product is cast to bf16: the reference's
    values bit for bit."""
    name, cfg = PAIRS[frontend]
    jcfg = get_smoke_config(name).replace(dtype="bfloat16")
    cfg = cfg.replace(dtype="bfloat16")
    jparams = JT.init(jcfg, jax.random.PRNGKey(2))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    batch = _batch(cfg, np.random.default_rng(4), seq=8)
    want = np.asarray(JT.embed_inputs(jcfg, jparams, {k: jnp.asarray(v)
                                                      for k, v in batch.items()}),
                      np.float32)
    got = T.embed_inputs(cfg, params, _tb(batch))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=1e-6)
