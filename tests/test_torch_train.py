"""Port parity of the train path: ``transformer.forward`` (both routes),
``chunked_ce``, ``adamw_update`` and the train step, against the JAX
reference on the reference's own parameters and adapters, carried across
through numpy (``repro_torch.convert``).

The port's kernel route (``use_kernels=True``) runs on CPU tensors through
the kernels' plain versions and the port's backward passes; the reference
runs its Pallas kernels in interpret mode, selected as
tests/test_kernels.py does (``use_kernels`` and ``lora.USE_KERNEL``).
fp32 throughout: hidden states and logits at 1e-5, the adapters after 1
and 4 steps (A, B and the trained ``scale``) at rtol 1e-4 / atol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.common.config import ModelConfig as JModelConfig  # noqa: E402
from repro.common.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.peft import lora as jlora  # noqa: E402
from repro.train import loss as jloss  # noqa: E402
from repro.train.step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.common.config import ModelConfig, OptimConfig  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.loss import chunked_ce  # noqa: E402
from repro_torch.train.step import make_eval_step, make_train_step  # noqa: E402

TARGETS = ("wq", "wk", "wv", "wo")
SMALL = dict(name="tiny", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=96, dtype="float32")


def _setup(seed=0, nonzero_b=True, **kw):
    jcfg, cfg = JModelConfig(**{**SMALL, **kw}), ModelConfig(**{**SMALL, **kw})
    jparams = JT.init(jcfg, jax.random.PRNGKey(seed))
    jad = jlora.init_lora(jparams, TARGETS, 4, 8.0, jax.random.PRNGKey(seed + 1))
    if nonzero_b:
        rng = np.random.default_rng(seed)
        jad = jax.tree_util.tree_map_with_path(
            lambda p, l: jnp.asarray(rng.normal(size=l.shape) * 0.05, l.dtype)
            if getattr(p[-1], "key", None) == "B" else l, jad)
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    ad = adapters_from_numpy(jax.device_get(jad), "cpu")
    return jcfg, cfg, jparams, jad, params, ad


def _batch(B, S, vocab, seed=0):
    rng = np.random.default_rng(seed + 7)
    toks = rng.integers(1, vocab, size=(B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)},
            {"tokens": torch.from_numpy(toks).long(),
             "loss_mask": torch.from_numpy(mask)})


class _ref_kernels:
    """The reference's kernel route: ``lora.USE_KERNEL`` set while its
    function is traced and run."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.old = jlora.USE_KERNEL
        jlora.USE_KERNEL = self.on

    def __exit__(self, *exc):
        jlora.USE_KERNEL = self.old


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("S,kw", [(24, {}), (20, {"sliding_window": 6})])
def test_forward_hidden_and_logits(use_kernels, S, kw):
    jcfg, cfg, jparams, jad, params, ad = _setup(**kw)
    jb, tb = _batch(2, S, cfg.vocab_size)
    with _ref_kernels(use_kernels):
        jh, _ = JT.forward(jcfg, jparams, jb, jad, use_kernels=use_kernels)
        jlg = JT.logits(jcfg, jparams, jh)
    h, aux = T.forward(cfg, params, tb, ad, use_kernels=use_kernels)
    assert float(aux) == 0.0
    _close(h, jh, 1e-5, 1e-5, "hidden")
    _close(T.logits(cfg, params, h), jlg, 1e-5, 1e-5, "logits")


def test_forward_routes_agree_on_odd_length():
    """S = 600 is no multiple of min(S, 512): the plain route takes the
    einsum path, the kernel route the kernel's plain version; both agree
    with the reference's flash route semantics."""
    jcfg, cfg, jparams, jad, params, ad = _setup(num_layers=1)
    jb, tb = _batch(1, 600, cfg.vocab_size)
    jh, _ = JT.forward(jcfg, jparams, jb, jad)
    for use_kernels in (False, True):
        h, _ = T.forward(cfg, params, tb, ad, use_kernels=use_kernels)
        _close(h, jh, 1e-5, 1e-5, f"use_kernels={use_kernels}")


@pytest.mark.parametrize("S,chunk", [(11, 4), (9, 512), (13, 6)])
def test_chunked_ce(S, chunk):
    jcfg, cfg, jparams, _, params, _ = _setup()
    rng = np.random.default_rng(S)
    hid = rng.normal(size=(3, S, cfg.d_model)).astype(np.float32)
    jb, tb = _batch(3, S, cfg.vocab_size, seed=S)
    jl, jm = jloss.chunked_ce(jcfg, jparams, jnp.asarray(hid), jb["tokens"],
                              jb["loss_mask"], chunk)
    tl, tm = chunked_ce(cfg, params, torch.from_numpy(hid), tb["tokens"],
                        tb["loss_mask"], chunk)
    _close(tl, jl, 1e-5, 1e-6, "loss")
    for k in ("loss", "tokens", "accuracy"):
        _close(tm[k], jm[k], 1e-5, 1e-6, k)


@pytest.mark.parametrize("sched,clip,wd,warm", [
    ("constant", 1.0, 0.0, 0), ("cosine", 0.05, 0.01, 2), ("linear", 0.0, 0.0, 1)])
def test_adamw_update(sched, clip, wd, warm):
    rng = np.random.default_rng(3)
    tree = {"blocks": {0: {"attn": {n: {
        "A": rng.normal(size=(2, 4, 8)).astype(np.float32),
        "B": rng.normal(size=(2, 8, 4)).astype(np.float32),
        "scale": np.full((2,), 2.0, np.float32)} for n in ("wk", "wq")}}}}
    jcfg = JOptimConfig(lr=1e-2, schedule=sched, grad_clip=clip,
                        weight_decay=wd, warmup_steps=warm, total_steps=5)
    cfg = OptimConfig(lr=1e-2, schedule=sched, grad_clip=clip,
                      weight_decay=wd, warmup_steps=warm, total_steps=5)
    jp, tp = jax.tree.map(jnp.asarray, tree), adapters_from_numpy(tree, "cpu")
    js, ts = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    for step in range(3):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                         tree)
        jp, js = jadamw.adamw_update(jcfg, jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = adamw.adamw_update(cfg, adapters_from_numpy(g, "cpu"), ts, tp)
    for a, b in zip(jax.tree.leaves(jp), adamw.tree_leaves(tp)):
        _close(b, a, 1e-5, 1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3


def _train(use_kernels, steps, grad_accum, b_only, nonzero_b):
    jcfg, cfg, jparams, jad, params, ad = _setup(nonzero_b=nonzero_b)
    # the paper's learning rate: Adam divides by |g|, so a gradient entry
    # near zero turns fp noise into an update of size up to lr
    jopt, opt = JOptimConfig(lr=3e-4), OptimConfig(lr=3e-4)
    kw = dict(loss_chunk=8, use_kernels=use_kernels, b_only=b_only,
              grad_accum=grad_accum)
    jstep = jax.jit(j_make_train_step(jcfg, jopt, remat=False, **kw))
    tstep = make_train_step(cfg, opt, **kw)
    js, ts = jadamw.adamw_init(jad), adamw.adamw_init(ad)
    with _ref_kernels(use_kernels):
        for i in range(steps):
            jb, tb = _batch(4, 20, cfg.vocab_size, seed=i)
            jad, js, jm = jstep(jparams, jad, js, jb)
            ad, ts, tm = tstep(params, ad, ts, tb)
            _close(tm["loss"], jm["loss"], 1e-5, 1e-6, f"loss at step {i}")
    return jad, ad


@pytest.mark.parametrize("use_kernels,steps,grad_accum,b_only,nonzero_b", [
    (False, 1, 1, False, False),
    (True, 1, 1, False, True),
    (False, 4, 1, False, False),
    (True, 4, 1, False, False),
    (True, 4, 2, False, True),
    (False, 4, 2, True, True),
])
def test_train_step_adapters_match(use_kernels, steps, grad_accum, b_only,
                                   nonzero_b):
    jad, ad = _train(use_kernels, steps, grad_accum, b_only, nonzero_b)
    moved = False
    for path, want in jax.tree_util.tree_flatten_with_path(jad)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        got = ad
        for k in keys:
            got = got[k]
        _close(got.detach(), want, 1e-4, 1e-5, "/".join(map(str, keys)))
        if keys[-1] == "scale":
            moved |= bool(np.any(np.asarray(want) != 1.0 * 8.0 / 4))
    # the trained scale leaves the init value once B is non-zero
    assert moved == (steps > 1 or nonzero_b)


def test_eval_step_matches_train_loss_without_grads():
    _, cfg, _, _, params, ad = _setup()
    _, tb = _batch(2, 16, cfg.vocab_size)
    m_plain = make_eval_step(cfg, loss_chunk=5)(params, ad, tb)
    m_kern = make_eval_step(cfg, loss_chunk=5, use_kernels=True)(params, ad, tb)
    assert not m_plain["loss"].requires_grad
    _close(m_kern["loss"], m_plain["loss"], 1e-5, 1e-6)
    _close(m_kern["accuracy"], m_plain["accuracy"], 1e-5, 1e-6)
