"""Port parity: ``repro_torch.models.transformer.decode`` logits against the
reference's ``repro.models.transformer.decode`` on the reference's own
initial parameters and LoRA adapters, carried across through numpy
(``repro_torch.convert``).

The trace is a ragged prefill chunk (n_tokens = [4, 2]) followed by ten
single-token steps that wrap an 8-slot ring.  Float caches compare at 1e-5
(fp32 on both sides, sums in another order); an int8 cache compares the
port's fused fp32 dequantization (``"kernel"``) with the reference's dense
bf16 dequantization at 3e-2, the tolerance tests/test_decode_kernels.py
uses for the same comparison.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.llama3p2_1b import SMOKE as JSMOKE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.peft.lora import init_lora as j_init_lora  # noqa: E402
from repro_torch.common.config import ModelConfig  # noqa: E402
from repro_torch.configs.llama3p2_1b import SMOKE  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import layers as Lyr  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TARGETS = ("wq", "wk", "wv", "wo")


def _cfgs(variant):
    kw = {}
    if variant == "window":
        kw = dict(sliding_window=4)
    elif variant == "qwen_style":
        kw = dict(qkv_bias=True, qk_norm=True)
    small = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                 d_ff=128, vocab_size=128)
    return JSMOKE.replace(**small, **kw), SMOKE.replace(**small, **kw)


def _setup(jcfg):
    key = jax.random.PRNGKey(0)
    jparams = JT.init(jcfg, key)
    ad = j_init_lora(jparams, TARGETS, 4, 8.0, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)

    def nonzero_b(path, leaf):
        if getattr(path[-1], "key", None) == "B":
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.05, leaf.dtype)
        return leaf

    ad = jax.tree_util.tree_map_with_path(nonzero_b, ad)
    return jparams, ad


def _trace(step, init_cache):
    cache = init_cache()
    toks = np.asarray([[3, 4, 5, 6], [7, 8, 9, 1]])
    n = np.asarray([4, 2], np.int32)
    lg, cache = step(cache, toks, n)
    out = [np.take_along_axis(lg, (n - 1)[:, None, None], axis=1)[:, 0]]
    for t in range(10):
        tok = np.asarray([[10 + t], [20 + t]])
        lg, cache = step(cache, tok, np.ones(2, np.int32))
        out.append(lg[:, -1])
    return np.stack(out)


@pytest.mark.parametrize("variant,impl", [
    ("full", "dense"), ("full", "kernel"), ("window", "dense"),
    ("window", "kernel"), ("int8", "kernel"), ("qwen_style", "kernel")])
def test_decode_logits_match_reference(variant, impl):
    jcfg, cfg = _cfgs(variant)
    jparams, jad = _setup(jcfg)
    jkv, kv = (jnp.int8, torch.int8) if variant == "int8" else (
        jnp.float32, torch.float32)

    jstep = jax.jit(lambda c, t, n: JT.decode(
        jcfg, jparams, c, {"tokens": t}, jad, n_tokens=n, decode_impl="dense"))
    want = _trace(
        lambda c, t, n: (lambda lg, c2: (np.asarray(lg), c2))(
            *jstep(c, jnp.asarray(t), jnp.asarray(n))),
        lambda: JT.init_cache(jcfg, 2, 8, jkv, prefill_chunk=4))

    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    ad = adapters_from_numpy(jax.device_get(jad), device="cpu")

    def tstep(c, t, n):
        lg, c2 = T.decode(cfg, params, c, {"tokens": torch.from_numpy(t)}, ad,
                          n_tokens=torch.from_numpy(n), decode_impl=impl)
        return lg.numpy(), c2

    got = _trace(tstep, lambda: T.init_cache(cfg, 2, 8, kv, prefill_chunk=4,
                                              device="cpu"))
    tol = 3e-2 if variant == "int8" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_rope_rotates_split_halves():
    """RoPE rotates the two halves of the head dim (the reference's code),
    so the first and second halves of a unit vector at index 0 move into
    index 0 and index hd/2 only."""
    from repro.models import layers as JL
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5)[None].repeat(2, 0)
    jc, js = JL.rope_freqs(16, 500_000.0, jnp.asarray(pos))
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jc, js))
    c, s = Lyr.rope_freqs(16, 500_000.0, torch.from_numpy(pos))
    got = Lyr.apply_rope(torch.from_numpy(x), c, s).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_init_shapes_and_distributions():
    """The port's seeded init has the reference's tree, shapes and scales."""
    cfg = ModelConfig(name="t", family="dense", num_layers=3, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=100,
                      tie_embeddings=True, dtype="float32")
    jp = JT.init(JSMOKE.replace(num_layers=3, d_model=64, num_heads=4,
                                num_kv_heads=2, head_dim=16, d_ff=256,
                                vocab_size=100, tie_embeddings=True),
                 jax.random.PRNGKey(0))
    p = T.init(cfg, seed=0, device="cpu")
    jflat = {jax.tree_util.keystr(k): v.shape
             for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + f"[{k!r}]")
        elif isinstance(node, tuple):
            for i, v in enumerate(node):
                walk(v, path + f"[{i}]")
        else:
            flat[path] = tuple(node.shape)
    walk(p, "")
    assert flat == jflat
    assert abs(p["blocks"][0]["mlp"]["w_down"].std().item() - 256 ** -0.5) < 3e-3
    assert abs(p["embed"].std().item() - 0.02) < 1e-3
