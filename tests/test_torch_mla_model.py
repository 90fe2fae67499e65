"""Port parity for the MLA serving path: the latent ring cache, the paged
``wkv_b`` fold, one layer's ``mla_decode`` and the model's ``decode``
against the JAX reference, on the reference's DeepSeek-V3 smoke config cut
to its three dense MLA layers (``SMOKE.replace(first_dense_layers=3)``,
fp32) with the reference's own parameters carried across through numpy.

Cache writes and resets compare bit for bit.  Everything else compares at
1e-4 (the reference's own MLA tolerance, tests/test_decode_kernels.py):
fp32 on both sides, sums taken in another order; the port's ``"kernel"``
route runs the kernel's plain version on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.configs import lora_targets as j_lora_targets  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.peft.lora import PagedLoRA as JPagedLoRA  # noqa: E402
from repro.peft.lora import init_lora as j_init_lora  # noqa: E402
from repro.peft.lora import paged_delta_weight as j_paged_delta_weight  # noqa: E402
from repro.serve import kvcache as JKv  # noqa: E402
from repro_torch.configs import deepseek_v3_671b, lora_targets  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import layers as Lyr  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.peft.lora import PagedLoRA, paged_delta_weight  # noqa: E402
from repro_torch.serve import kvcache as Kv  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
JCFG = get_smoke_config("deepseek_v3_671b").replace(first_dense_layers=3)
CFG = deepseek_v3_671b.SMOKE.replace(first_dense_layers=3)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module")
def model():
    """The reference's params and a classic adapter tree (non-zero B), and
    the port's copies of both."""
    jparams = JT.init(JCFG, jax.random.PRNGKey(0))
    jad = j_init_lora(jparams, j_lora_targets(JCFG), 4, 8.0,
                      jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)

    def nonzero_b(path, leaf):
        if getattr(path[-1], "key", None) == "B":
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.05, leaf.dtype)
        return leaf

    jad = jax.tree_util.tree_map_with_path(nonzero_b, jad)
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    ad = adapters_from_numpy(jax.device_get(jad), device="cpu")
    return jparams, jad, params, ad


def _flat(tree):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + f"[{k!r}]")
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + f"[{i}]")
        else:
            out[path] = (tuple(node.shape), str(node.dtype).split(".")[-1])
    walk(tree, "")
    return out


def test_plan_init_and_convert_keep_reference_tree(model):
    """Plan, parameter tree (the empty MoE segment's zero-size leaves
    included) and cache tree equal the reference's; ``convert`` carries the
    zero-size leaves across as they are; the LoRA targets are MLA's five."""
    jparams, _, params, _ = model
    assert T.layer_plan(CFG) == JT.layer_plan(JCFG) == [("mla_dense", 3),
                                                       ("mla_moe", 0)]
    assert lora_targets(CFG) == j_lora_targets(JCFG)
    jflat = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
             for k, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert _flat(T.init(CFG, 0, device="cpu")) == jflat
    assert _flat(params) == jflat
    assert params["blocks"][1]["moe"]["w_gate"].shape == (0, 4, 256, 128)
    for kv, jkv in ((torch.bfloat16, jnp.bfloat16), (torch.int8, jnp.int8)):
        jc = JT.init_cache(JCFG, 2, 8, jkv, prefill_chunk=4)
        want = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
                for k, v in jax.tree_util.tree_flatten_with_path(jc)[0]}
        assert _flat(T.init_cache(CFG, 2, 8, kv, prefill_chunk=4,
                                  device="cpu")) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_mla_cache_update_and_reset_match_reference(dtype):
    """Three chunk writes with ragged n (incl. 0; the last wraps the ring),
    then a reset of two slots: every leaf equals the reference's exactly
    (int8: each half quantized with its own scale)."""
    rng = np.random.default_rng(1)
    B, cap = 3, 6
    jc = JKv.mla_cache(JCFG, B, cap, getattr(jnp, dtype))
    tc = Kv.mla_cache(CFG, B, cap, getattr(torch, dtype), "cpu")
    assert set(tc) == set(jc)
    for C, n in ((4, [4, 2, 0]), (4, [3, 4, 1]), (2, [2, 0, 2])):
        c_kv = (rng.normal(size=(B, C, 32)) * 2).astype(np.float32)
        k_rope = (rng.normal(size=(B, C, 16)) * 50).astype(np.float32)
        n = np.asarray(n, np.int32)
        jc = JKv.mla_cache_update(jc, jnp.asarray(c_kv), jnp.asarray(k_rope),
                                  jnp.asarray(n))
        tc = Kv.mla_cache_update(tc, _t(c_kv), _t(k_rope), _t(n))
    for name in jc:
        np.testing.assert_array_equal(tc[name].float().numpy(),
                                      np.asarray(jc[name].astype(jnp.float32)),
                                      err_msg=name)
    mask = np.asarray([True, False, True])
    jc = JKv.reset_slots(jc, jnp.asarray(mask))
    Kv.reset_slots(tc, mask)
    for name in jc:
        np.testing.assert_array_equal(tc[name].float().numpy(),
                                      np.asarray(jc[name].astype(jnp.float32)),
                                      err_msg=f"after reset: {name}")


def _paged(rng, B, din, dout, P=6, pr=2, Pmax=3):
    """Numpy pools, a page table and per-row ids: adapters of ranks 0
    (base), 3, 6, and stale pages behind masked lanes."""
    a = rng.normal(size=(P, pr, din)).astype(np.float32)
    b = rng.normal(size=(P, dout, pr)).astype(np.float32)
    table = np.asarray([[0, 0, 0], [4, 1, 0], [2, 5, 3]], np.int32)
    rank = np.asarray([0, 3, 6], np.int32)
    scale = np.asarray([0.0, 1.5, 0.25], np.float32)
    ids = np.asarray([1, 0, 2, 1][:B], np.int32)
    return a, b, scale, table, rank, ids


def test_paged_delta_weight_matches_reference():
    rng = np.random.default_rng(2)
    arrs = _paged(rng, 4, 16, 24)
    want = np.asarray(j_paged_delta_weight(JPagedLoRA(*map(jnp.asarray, arrs))))
    got = paged_delta_weight(PagedLoRA(*map(_t, arrs))).numpy()
    assert got.shape == (4, 16, 24)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[1], 0.0)          # base row: exact zero


def _layer_adapters(kind, ad, jad, rng, B):
    """(port, reference) adapters of layer 0's attention: none, the classic
    tree's leaves, or paged pools over every MLA target."""
    if kind == "none":
        return None, None
    if kind == "classic":
        return (T._layer(ad["blocks"][0]["attn"], 0),
                jax.tree.map(lambda x: x[0], jad["blocks"][0]["attn"]))
    shapes = {"wq_a": (256, 64), "wq_b": (64, 192), "wkv_a": (256, 48),
              "wkv_b": (32, 256), "wo": (128, 256)}
    port, ref = {}, {}
    for name, (din, dout) in shapes.items():
        arrs = list(_paged(rng, B, din, dout))
        arrs[0] *= 0.05
        arrs[1] *= 0.05
        port[name] = PagedLoRA(*map(_t, arrs), impl="plain")
        ref[name] = JPagedLoRA(*map(jnp.asarray, arrs))
    return port, ref


@pytest.mark.parametrize("adapter,impl,kv", [
    ("none", "dense", "float32"), ("none", "kernel", "float32"),
    ("classic", "dense", "float32"), ("classic", "kernel", "float32"),
    ("paged", "dense", "float32"), ("paged", "kernel", "float32"),
    ("paged", "kernel", "int8")])
def test_mla_decode_layer_matches_reference(model, adapter, impl, kv):
    """Two ragged chunks through one layer (rows with n = 0 included); the
    outputs on valid positions and the caches against the reference's dense
    route."""
    jparams, jad, params, ad = model
    rng = np.random.default_rng(3)
    B = 4
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"][0]["attn"])
    p = T._layer(params["blocks"][0]["attn"], 0)
    a, ja = _layer_adapters(adapter, ad, jad, rng, B)
    jc = JKv.mla_cache(JCFG, B, 6, getattr(jnp, kv))
    tc = Kv.mla_cache(CFG, B, 6, getattr(torch, kv), "cpu")
    jdec = jax.jit(lambda x, c, a_, n: JL.mla_decode(
        JCFG, jp, x, c, a_, n_tokens=n, decode_impl="dense"))
    for C, n in ((4, [4, 2, 0, 3]), (3, [1, 3, 2, 0])):
        x = rng.normal(size=(B, C, 256)).astype(np.float32)
        n = np.asarray(n, np.int32)
        want, jc = jdec(jnp.asarray(x), jc, ja, jnp.asarray(n))
        got, tc = Lyr.mla_decode(CFG, p, _t(x), tc, a, n_tokens=_t(n),
                                 decode_impl=impl)
        valid = np.arange(C)[None, :] < n[:, None]
        np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                                   **TOL)
    for name in jc:
        np.testing.assert_allclose(tc[name].float().numpy(),
                                   np.asarray(jc[name].astype(jnp.float32)),
                                   **TOL, err_msg=name)


def _trace(step, init_cache):
    """A ragged prefill chunk (n = [4, 2]), then ten single-token steps that
    wrap an 8-slot ring; the logits of every row's last real token."""
    cache = init_cache()
    toks = np.asarray([[3, 4, 5, 6], [7, 8, 9, 1]])
    n = np.asarray([4, 2], np.int32)
    lg, cache = step(cache, toks, n)
    out = [np.take_along_axis(lg, (n - 1)[:, None, None], axis=1)[:, 0]]
    for t in range(10):
        lg, cache = step(cache, np.asarray([[10 + t], [20 + t]]),
                         np.ones(2, np.int32))
        out.append(lg[:, -1])
    return np.stack(out)


@pytest.mark.parametrize("impl,kv", [("dense", "float32"),
                                     ("kernel", "float32"),
                                     ("kernel", "bfloat16"),
                                     ("kernel", "int8")])
def test_decode_logits_match_reference(model, impl, kv):
    """``transformer.decode`` through the three MLA layers with the classic
    adapters, against the reference's dense route with the same cache
    dtype."""
    jparams, jad, params, ad = model
    jstep = jax.jit(lambda c, t, n: JT.decode(
        JCFG, jparams, c, {"tokens": t}, jad, n_tokens=n, decode_impl="dense"))
    want = _trace(lambda c, t, n: (lambda lg, c2: (np.asarray(lg), c2))(
        *jstep(c, jnp.asarray(t), jnp.asarray(n))),
        lambda: JT.init_cache(JCFG, 2, 8, getattr(jnp, kv), prefill_chunk=4))

    def tstep(c, t, n):
        lg, c2 = T.decode(CFG, params, c, {"tokens": torch.from_numpy(t)}, ad,
                          n_tokens=torch.from_numpy(n), decode_impl=impl)
        return lg.numpy(), c2

    got = _trace(tstep, lambda: T.init_cache(CFG, 2, 8, getattr(torch, kv),
                                              prefill_chunk=4, device="cpu"))
    np.testing.assert_allclose(got, want, **TOL)
