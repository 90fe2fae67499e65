"""Port parity of the four Qwen dense configs (``qwen2-0.5b``, ``qwen3-4b``,
``qwen2.5-14b``, ``qwen1.5-32b``) at their SMOKE widths.

The configs equal the reference's field for field.  With the reference's
parameters carried across (``repro_torch.convert``) and a non-zero
adapter on ``wq wk wv wo``: the full-sequence forward's logits (plain and
kernel routes; the kernels' plain versions on the CPU) within 1e-4 of the
reference's; the port's token-by-token decode against its own forward;
the reference's decode-routing variants (``tests/test_decode_kernels.py``:
full, window, int8) on the port's dense, streamed and kernel routes, at the
reference's tolerances (1e-4; int8 3e-2), and the port's dense route
against the reference's; and the engine's greedy tokens against the
reference engine's on ``qwen2-0.5b`` SMOKE with a mid-flight ``swap``.
These cover ``qkv_bias``, ``qk_norm``, tied embeddings, GQA groups 1, 2
and 4, head dims 56 and 64.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.peft import lora as jlora  # noqa: E402
from repro.serve.adapters import AdapterRegistry as JRegistry  # noqa: E402
from repro.serve.engine import SamplingParams as JSP  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.adapters import AdapterRegistry  # noqa: E402
from repro_torch.serve.engine import SamplingParams, ServeEngine  # noqa: E402

QWEN = ("qwen2-0.5b", "qwen3-4b", "qwen2.5-14b", "qwen1.5-32b")
IMPLS = ("dense", "streamed", "kernel")


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs files on parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", QWEN)
def test_configs_equal_reference(name):
    for get in ("get_config", "get_smoke_config"):
        ours = getattr(tconfigs, get)(name)
        ref = getattr(jconfigs, get)(name)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref), (name, get)
        assert ours.param_count() == ref.param_count()
    assert tconfigs.lora_targets(tconfigs.get_config(name)) == \
        jconfigs.lora_targets(jconfigs.get_config(name)) == ("wq", "wk", "wv", "wo")
    mod = jconfigs._ALIAS[name]
    assert tconfigs.get_config(mod) == tconfigs.get_config(name)


def _model(name, seed=0):
    """The reference's SMOKE params and a rank-4 adapter with non-zero B,
    and the port's copies."""
    jcfg = jconfigs.get_smoke_config(name)
    cfg = tconfigs.get_smoke_config(name)
    jparams = JT.init(jcfg, jax.random.PRNGKey(seed))
    jad = jlora.init_lora(jparams, jconfigs.lora_targets(jcfg), 4, 8.0,
                          jax.random.PRNGKey(seed + 1), sigma=0.05)
    rng = np.random.default_rng(seed)
    jad = jax.tree_util.tree_map_with_path(
        lambda p, leaf: jnp.asarray(rng.normal(size=leaf.shape) * 0.05, leaf.dtype)
        if getattr(p[-1], "key", None) == "B" else leaf, jad)
    return (jcfg, jparams, jad, cfg,
            params_from_numpy(jax.device_get(jparams), "cpu"),
            adapters_from_numpy(jax.device_get(jad), "cpu"))


def _tokens(vocab, B=2, S=12, seed=3):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", QWEN)
def test_forward_logits_match_reference(name):
    jcfg, jparams, jad, cfg, params, ad = _model(name)
    toks = _tokens(cfg.vocab_size)
    jh, _ = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)}, jad)
    want = np.asarray(JT.logits(jcfg, jparams, jh))
    for use_kernels in (False, True):
        with torch.no_grad():
            h, _ = T.forward(cfg, params, {"tokens": torch.from_numpy(toks).long()},
                             ad, use_kernels=use_kernels)
            got = T.logits(cfg, params, h).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(want).max()),
                                   err_msg=f"{name} use_kernels={use_kernels}")


@pytest.mark.parametrize("name", QWEN)
def test_decode_token_by_token_matches_forward(name):
    _, _, _, cfg, params, ad = _model(name)
    toks = torch.from_numpy(_tokens(cfg.vocab_size)).long()
    B, S = toks.shape
    with torch.no_grad():
        h, _ = T.forward(cfg, params, {"tokens": toks}, ad)
        want = T.logits(cfg, params, h)
        for impl in IMPLS:
            cache = T.init_cache(cfg, B, 16, device="cpu")
            got = []
            for t in range(S):
                lg, cache = T.decode(cfg, params, cache, {"tokens": toks[:, t:t + 1]},
                                     ad, decode_impl=impl)
                got.append(lg[:, 0])
            torch.testing.assert_close(torch.stack(got, 1), want, rtol=0,
                                       atol=1e-4 * max(1.0, want.abs().max().item()),
                                       msg=f"{name} {impl}")


def _trace(decode, cfg, params, impl, kv_dtype, capacity=8):
    """``tests/test_decode_kernels.py``'s trace: a chunked prefill of 4
    (rows of 4 and 2 real tokens), then 10 one-token steps that wrap an
    8-slot ring; each step's logits at every row's last real token."""
    cache = T.init_cache(cfg, 2, capacity, kv_dtype, prefill_chunk=4, device="cpu")
    toks = torch.tensor([[3, 4, 5, 6], [7, 8, 9, 1]])
    n = torch.tensor([4, 2], dtype=torch.int32)
    out = []
    with torch.no_grad():
        lg, cache = decode(cfg, params, cache, {"tokens": toks}, n_tokens=n,
                           decode_impl=impl)
        out.append(lg[torch.arange(2), n.long() - 1].numpy())
        ones = torch.ones(2, dtype=torch.int32)
        for t in range(10):
            tok = torch.tensor([[10 + t], [20 + t]])
            lg, cache = decode(cfg, params, cache, {"tokens": tok}, n_tokens=ones,
                               decode_impl=impl)
            out.append(lg[:, -1].numpy())
    return np.stack(out)


@pytest.mark.parametrize("variant", ["full", "window", "int8"])
def test_decode_routing_variants(variant):
    """The reference's ``test_transformer_decode_parity`` on the port:
    streamed and kernel against dense at the reference's tolerances, and
    the port's dense route against the reference's."""
    jcfg = jconfigs.get_smoke_config("qwen2-0.5b")
    cfg = tconfigs.get_smoke_config("qwen2-0.5b")
    kv, jkv = torch.float32, jnp.float32
    if variant == "window":
        jcfg, cfg = jcfg.replace(sliding_window=4), cfg.replace(sliding_window=4)
    if variant == "int8":
        kv, jkv = torch.int8, jnp.int8
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    tol = 3e-2 if variant == "int8" else 1e-4
    dense = _trace(T.decode, cfg, params, "dense", kv)
    for impl in IMPLS[1:]:
        got = _trace(T.decode, cfg, params, impl, kv)
        np.testing.assert_allclose(got, dense, rtol=tol, atol=tol,
                                   err_msg=f"{variant}/{impl}")

    def jdecode(c, p, cache, batch, n_tokens, decode_impl):
        lg, cache = JT.decode(c, p, cache, {"tokens": jnp.asarray(batch["tokens"].numpy())},
                              n_tokens=jnp.asarray(n_tokens.numpy()),
                              decode_impl=decode_impl)
        return torch.from_numpy(np.array(lg)), cache

    jcache = JT.init_cache(jcfg, 2, 8, jkv, prefill_chunk=4)
    ref = []
    toks = torch.tensor([[3, 4, 5, 6], [7, 8, 9, 1]])
    n = torch.tensor([4, 2], dtype=torch.int32)
    lg, jcache = jdecode(jcfg, jparams, jcache, {"tokens": toks}, n, "dense")
    ref.append(lg[torch.arange(2), n.long() - 1].numpy())
    for t in range(10):
        lg, jcache = jdecode(jcfg, jparams, jcache,
                             {"tokens": torch.tensor([[10 + t], [20 + t]])},
                             torch.ones(2, dtype=torch.int32), "dense")
        ref.append(lg[:, -1].numpy())
    np.testing.assert_allclose(dense, np.stack(ref), rtol=tol, atol=tol,
                               err_msg=f"{variant}: port dense vs reference dense")


REG = dict(page_rank=4, num_pages=12, max_adapters=5, max_rank=8)
ENGINE = dict(batch_slots=3, capacity=32, prefill_chunk=4)
PROMPTS = [[3, 4, 5, 6, 7, 8, 9], [10, 11], [12, 13, 14, 15, 16], [17],
           [18, 19, 20, 21, 22]]
IDS_AT = ["a", "b", None, "a", "b"]


def _adapter(template, rank, seed):
    rng = np.random.default_rng(seed)

    def make(node):
        if "A" in node:
            L, _, din = node["A"].shape
            dout = node["B"].shape[1]
            return {"A": (rng.normal(size=(L, rank, din)) * 0.1).astype(np.float32),
                    "B": (rng.normal(size=(L, dout, rank)) * 0.1).astype(np.float32),
                    "scale": np.full((L,), 2.0, np.float32)}
        return {k: make(v) for k, v in node.items()}

    return make(template)


def _serve(engine_cls, sp_cls, reg, ads, eng_kw):
    """A wave on mixed ids, 3 steps, ``swap`` of "b", requests on the new
    and the old id, run to the end: uid -> tokens."""
    ids = {n: reg.register(n, ads[n]) for n in ("a", "b")}
    eng = engine_cls(registry=reg, **eng_kw)
    sp = sp_cls(max_tokens=5)
    out = {}
    for p, name in zip(PROMPTS, IDS_AT):
        eng.submit(p, sp, adapter_id=ids[name] if name else 0)
    out.update(eng.run_steps(3))
    new = reg.swap("b", ads["b2"])
    eng.submit([9, 8, 7], sp, adapter_id=new)
    eng.submit([5, 4], sp, adapter_id=ids["b"])
    out.update(eng.run())
    return out


@pytest.mark.parametrize("impl", IMPLS)
def test_engine_greedy_tokens_match_reference(impl):
    jcfg = jconfigs.get_smoke_config("qwen2-0.5b")
    cfg = tconfigs.get_smoke_config("qwen2-0.5b")
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    template = jax.device_get(jlora.init_lora(
        jparams, jconfigs.lora_targets(jcfg), 4, 8.0, jax.random.PRNGKey(1)))
    nads = {"a": _adapter(template, 4, 11), "b": _adapter(template, 7, 12),
            "b2": _adapter(template, 5, 13)}
    want = _serve(JEngine, JSP, JRegistry(template, **REG), nads,
                  dict(cfg=jcfg, params=jparams, decode_impl="dense",
                       lora_impl="xla", **ENGINE))
    params = params_from_numpy(jax.device_get(jparams), "cpu")
    reg = AdapterRegistry(adapters_from_numpy(template, device="cpu"),
                          device="cpu", **REG)
    ads = {k: adapters_from_numpy(v, device="cpu") for k, v in nads.items()}
    got = _serve(ServeEngine, SamplingParams, reg, ads,
                 dict(cfg=cfg, params=params, decode_impl=impl, device="cpu",
                      **ENGINE))
    assert got == want
    assert len(got) == len(PROMPTS) + 2 and all(len(t) == 5 for t in got.values())


def test_serve_batch_example_on_cpu(capsys):
    """``repro_torch.examples.serve_batch`` at its defaults and with the
    kernel route over an int8 cache: every step's token in the vocabulary;
    the dense and streamed routes emit the same greedy tokens."""
    from repro_torch.examples import serve_batch
    vocab = tconfigs.get_smoke_config("qwen2-0.5b").vocab_size
    dense = serve_batch.main(["--device", "cpu"])
    assert dense.shape == (4, 24) and int(dense.max()) < vocab
    streamed = serve_batch.main(["--device", "cpu", "--decode-impl", "streamed"])
    assert torch.equal(dense, streamed)
    k8 = serve_batch.main(["--device", "cpu", "--decode-impl", "kernel",
                           "--int8-cache", "--window", "8"])
    assert k8.shape == (4, 24) and int(k8.max()) < vocab
    out = capsys.readouterr().out
    assert "== serving qwen2-smoke" in out and "decode: 24 steps" in out
