"""Port parity for the Zamba2 hybrid (Mamba2 layers and one shared
attention block) against the JAX reference on its ``zamba2-smoke`` config
(fp32: 4 layers at ``attn_every`` 2, so two shared applications), the
reference's own parameters carried across through numpy (``convert``).

The plan, the init layout and the param count equal the reference's; the
full-sequence forward and the logits (plain and kernel routes; the kernels'
plain versions on the CPU) within 1e-5 · max(1, |x|); 16 tokens of decode
within 1e-5 of the reference's decode and within 2e-4 relative of the
port's own forward (the reference's limit, tests/test_models.py); one
train step's gradients and adapters within 1e-5; the engine's greedy tokens on a
registry with a ``swap`` equal to the reference engine's; the registry's
shared-block pools unstacked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.common.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.configs import lora_targets as j_lora_targets  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro.peft.lora import init_lora as j_init_lora  # noqa: E402
from repro.serve.adapters import AdapterRegistry as JRegistry  # noqa: E402
from repro.serve.engine import SamplingParams as JSP  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.train.step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.common.config import OptimConfig  # noqa: E402
from repro_torch.configs import get_config, lora_targets, zamba2_1p2b  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.serve.adapters import AdapterRegistry, adapter_leaves  # noqa: E402
from repro_torch.serve.engine import SamplingParams, ServeEngine  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

from test_torch_moe_model import one_thread  # noqa: E402,F401

JCFG = get_smoke_config("zamba2-1.2b")
CFG = zamba2_1p2b.SMOKE
B, S = 2, 16


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _flat(tree):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out[path] = (tuple(node.shape), str(node.dtype).split(".")[-1])

    walk(tree, ())
    return out


@pytest.fixture(scope="module")
def model():
    """The reference's params (a varied ``D`` and ``dt_bias`` in each Mamba2
    segment) and a classic adapter tree on the six hybrid targets with
    non-zero B (2-D leaves on the shared block), and the port's copies."""
    rng = np.random.default_rng(0)
    jparams = JT.init(JCFG, jax.random.PRNGKey(0))
    segs = []
    for seg in jparams["blocks"]:
        mixer = dict(seg["mixer"])
        for k in ("D", "dt_bias"):
            mixer[k] = jnp.asarray(rng.uniform(0.2, 1.5, mixer[k].shape), jnp.float32)
        segs.append(dict(seg, mixer=mixer))
    jparams["blocks"] = tuple(segs)
    jad = j_init_lora(jparams, j_lora_targets(JCFG), 4, 8.0,
                      jax.random.PRNGKey(1), sigma=0.05)

    def nonzero_b(path, leaf):
        if getattr(path[-1], "key", None) == "B":
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.05, leaf.dtype)
        return leaf

    jad = jax.tree_util.tree_map_with_path(nonzero_b, jad)
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    ad = adapters_from_numpy(jax.device_get(jad), device="cpu")
    toks = rng.integers(0, CFG.vocab_size, (B, S))
    return jparams, jad, params, ad, toks


def test_plan_layout_and_param_count_match_reference():
    for name in ("zamba2-1.2b",):
        for ours, ref in ((get_config(name), j_get_config(name)), (CFG, JCFG)):
            assert T.layer_plan(ours) == JT.layer_plan(ref)
            assert T.num_shared_applications(ours) == JT.num_shared_applications(ref)
            assert ours.param_count() == ref.param_count()
            assert (ours.d_inner, ours.num_ssm_heads) == (ref.d_inner, ref.num_ssm_heads)
    full = get_config("zamba2-1.2b")
    assert T.num_shared_applications(full) == 6
    assert T.layer_plan(full)[-1] == ("mamba", 2)
    assert lora_targets(CFG) == tuple(j_lora_targets(JCFG))
    for dtype in ("float32", "bfloat16"):
        jp = jax.device_get(JT.init(JCFG.replace(dtype=dtype), jax.random.PRNGKey(0)))
        p = T.init(CFG.replace(dtype=dtype), 0, device="cpu")
        assert _flat(p) == _flat(jp)
        assert p["shared_blk"]["attn"]["wq"].dim() == 2          # stored once


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_and_logits_match_reference(model, use_kernels):
    jparams, jad, params, ad, toks = model
    want, _ = JT.forward(JCFG, jparams, {"tokens": jnp.asarray(toks)}, jad)
    got, aux = T.forward(CFG, params, {"tokens": _t(toks)}, ad,
                         use_kernels=use_kernels)
    _close(got, want)
    assert float(aux) == 0.0
    _close(T.logits(CFG, params, got), JT.logits(JCFG, jparams, want))


def test_decode_matches_reference_and_forward(model):
    """16 single-token decode steps (the shared block's two unstacked
    rings and the stacked Mamba2 states) against the reference's decode,
    and against the port's own forward."""
    jparams, jad, params, ad, toks = model
    toks = np.concatenate([toks, toks[:, ::-1]], axis=1)[:, :16]
    jcache = JT.init_cache(JCFG, B, 16, kv_dtype=jnp.float32)
    cache = T.init_cache(CFG, B, 16, torch.float32, device="cpu")
    assert _flat(cache) == _flat(jax.device_get(jcache))
    hidden, _ = T.forward(CFG, params, {"tokens": _t(toks)}, ad)
    full = T.logits(CFG, params, hidden)
    jdecode = jax.jit(lambda c, b: JT.decode(JCFG, jparams, c, b, jad))
    outs = []
    for t in range(16):
        want, jcache = jdecode(jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        got, cache = T.decode(CFG, params, cache, {"tokens": _t(toks[:, t:t + 1])},
                              ad, decode_impl="kernel")
        _close(got, want)
        outs.append(got[:, 0])
    dec = torch.stack(outs, 1)
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < 2e-4


def test_train_step_adapters_match_reference(model):
    """One train step on the kernel route (``lora_matmul`` and
    ``flash_attention``, plain versions here): the loss, the gradients and
    every adapter leaf after the AdamW step, the shared block's 2-D leaves
    and scalar ``scale`` included.  Both optimizers take ``eps`` 1e-3, so
    the first step is a Lipschitz function of the gradient: with eps 1e-8
    an entry whose gradient lies within fp32 noise of zero (|g| ~1e-7 here,
    the two packages' gradients 1e-7 apart) moves by up to ±lr either way."""
    from repro.train.step import loss_fn as j_loss_fn
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import _unflatten, loss_fn
    jparams, jad, params, ad, toks = model
    batch = {"tokens": toks, "loss_mask": np.ones((B, S), np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {"tokens": _t(toks), "loss_mask": _t(batch["loss_mask"])}
    jg = jax.jit(jax.grad(
        lambda a: j_loss_fn(JCFG, jparams, a, jb, loss_chunk=8)[0]))(jad)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(ad)]
    loss, _ = loss_fn(CFG, params, _unflatten(ad, leaves), tb, 8, True)
    g = _unflatten(ad, torch.autograd.grad(loss, leaves))
    jgl = dict(adapter_leaves(jax.device_get(jg)))
    for path, leaf in adapter_leaves(g):
        for k in ("A", "B", "scale"):
            _close(leaf[k], jgl[path][k])

    jstep = jax.jit(j_make_train_step(JCFG, JOptimConfig(lr=3e-4, eps=1e-3),
                                      remat=False, loss_chunk=8))
    jnew, _, jm = jstep(jparams, jad, j_adamw_init(jad), jb)
    step = make_train_step(CFG, OptimConfig(lr=3e-4, eps=1e-3), loss_chunk=8,
                           use_kernels=True)
    new, _, m = step(params, ad, adamw_init(ad), tb)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    jl = dict(adapter_leaves(jax.device_get(jnew)))
    got = dict(adapter_leaves(new))
    assert set(got) == set(jl) and ("shared_blk", "attn", "wq") in got
    for path, leaf in got.items():
        for k in ("A", "B", "scale"):
            _close(leaf[k], jl[path][k])


REG = dict(page_rank=4, num_pages=16, max_adapters=5, max_rank=8)
ENGINE = dict(batch_slots=3, capacity=16, prefill_chunk=4)
PROMPTS = [[3, 4, 5, 6, 7, 8, 9], [10, 11], [12, 13, 14, 15, 16], [17],
           [18, 19, 20, 21, 22]]
IDS_AT = ["a", "b", None, "a", "b"]


def _adapter(template, rank, seed):
    """A numpy adapter tree shaped like ``template`` at ``rank``, non-zero
    A and B, on stacked and 2-D leaves alike."""
    rng = np.random.default_rng(seed)

    def make(node):
        if "A" in node:
            lead = node["A"].shape[:-2]
            din, dout = node["A"].shape[-1], node["B"].shape[-2]
            return {"A": (rng.normal(size=lead + (rank, din)) * 0.1).astype(np.float32),
                    "B": (rng.normal(size=lead + (dout, rank)) * 0.1).astype(np.float32),
                    "scale": np.full(lead, 2.0, np.float32)}
        return {k: make(v) for k, v in node.items()}

    return make(template)


def _serve(engine_cls, sp_cls, reg, ads, eng_kw):
    ids = {n: reg.register(n, ads[n]) for n in ("a", "b")}
    eng = engine_cls(registry=reg, **eng_kw)
    sp = sp_cls(max_tokens=5)
    out = {}
    for p, name in zip(PROMPTS, IDS_AT):
        eng.submit(p, sp, adapter_id=ids[name] if name else 0)
    out.update(eng.run_steps(3))
    new = reg.swap("b", ads["b2"])
    eng.submit([9, 8, 7], sp, adapter_id=new)
    eng.submit([5, 4], sp, adapter_id=ids["b"])      # old version still live
    out.update(eng.run())
    return out


def _ads(template):
    return {"a": _adapter(template, 4, 11), "b": _adapter(template, 7, 12),
            "b2": _adapter(template, 5, 13)}


@pytest.fixture(scope="module")
def served(model):
    jparams, _, params, _, _ = model
    template = jax.device_get(j_init_lora(jparams, j_lora_targets(JCFG), 4, 8.0,
                                          jax.random.PRNGKey(1)))
    want = _serve(JEngine, JSP, JRegistry(template, **REG), _ads(template),
                  dict(cfg=JCFG, params=jparams, decode_impl="dense",
                       lora_impl="xla", **ENGINE))
    return template, want


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_engine_greedy_tokens_match_reference(model, served, impl):
    """The engine steps one token at a time (chunk 1) and emits the
    reference engine's greedy tokens through a swap; the registry pools
    the shared block's 2-D leaves unstacked (``lead = ()``)."""
    _, _, params, _, _ = model
    template, want = served
    reg = AdapterRegistry(adapters_from_numpy(template, device="cpu"),
                          device="cpu", **REG)
    pool = reg.device_state["pools"]["shared_blk"]["attn"]["wq"]
    assert pool["A"].shape == (REG["num_pages"], REG["page_rank"], CFG.d_model)
    assert pool["scale"].shape == (REG["max_adapters"],)
    ads = {k: adapters_from_numpy(v, device="cpu") for k, v in _ads(template).items()}
    eng_kw = dict(cfg=CFG, params=params, decode_impl=impl, device="cpu", **ENGINE)
    got = _serve(ServeEngine, SamplingParams, reg, ads, eng_kw)
    assert got == want
    assert len(got) == len(PROMPTS) + 2 and all(len(t) == 5 for t in got.values())


def test_engine_resets_every_state_of_a_slot(model):
    """An aborted slot's rows of the shared rings and of the stacked
    Mamba2 states are wiped; the other slots keep theirs."""
    _, _, params, _, _ = model
    eng = ServeEngine(CFG, params, device="cpu", **ENGINE)
    assert eng.chunk == 1
    for p in PROMPTS[:2]:
        eng.submit(p, SamplingParams(max_tokens=4))
    eng.run_steps(3)
    assert float(eng.cache[0]["ssm"][:, 1].abs().sum()) > 0
    eng.reset_slot(0)
    for c in eng.cache:
        for name, v in c.items():
            bax = 1 if name in ("conv", "ssm") else 0
            assert not v.select(bax, 0).any(), name
            assert v.select(bax, 1).any(), name


def test_convert_round_trips_mixed_dtypes():
    """A bf16 reference tree crosses bit for bit, ``A_log``, ``D`` and
    ``dt_bias`` as fp32 beside bf16 weights, ``frontend_proj`` and the
    unstacked ``shared_blk`` included."""
    for jcfg in (JCFG.replace(dtype="bfloat16"),
                 get_smoke_config("phi-3-vision-4.2b").replace(dtype="bfloat16")):
        jp = jax.device_get(JT.init(jcfg, jax.random.PRNGKey(2)))
        p = params_from_numpy(jp, device="cpu")
        assert _flat(p) == _flat(jp)
        flat_j = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
        flat_p = dict(jax.tree_util.tree_flatten_with_path(p)[0])
        assert flat_j.keys() == flat_p.keys()
        for k, v in flat_j.items():
            t = flat_p[k]
            back = (t.view(torch.int16).numpy().view(v.dtype) if t.dtype == torch.bfloat16
                    else t.numpy())
            assert back.dtype == v.dtype and np.array_equal(back.view(np.uint8),
                                                           np.asarray(v).view(np.uint8))
    assert p["frontend_proj"].dtype == torch.bfloat16
