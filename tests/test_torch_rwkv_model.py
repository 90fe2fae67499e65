"""Port parity for the RWKV6 model: parameter and cache trees, one layer's
time mix and channel mix, the full-sequence forward (plain and kernel
routes), the prefill step, token-by-token decode and slot resets, against
the JAX reference on its ``rwkv6-smoke`` config (fp32) with the reference's
own parameters carried across through numpy.

Tolerance 1e-4 relative and absolute (fp32 on both sides, sums taken in
another order through two layers); the reference's own decode-against-
forward bound, 2e-4 of max |logit| (tests/test_models.py), where decode is
held to forward.  The port's kernel route runs the kernels' plain versions
on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.configs import lora_targets as j_lora_targets  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.peft.lora import init_lora as j_init_lora  # noqa: E402
from repro.train.step import make_prefill_step as j_make_prefill_step  # noqa: E402
from repro_torch.configs import lora_targets, rwkv6_1p6b  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import layers as Lyr  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import kvcache as Kv  # noqa: E402
from repro_torch.train.step import make_prefill_step  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
JCFG = get_smoke_config("rwkv6-1.6b")
CFG = rwkv6_1p6b.SMOKE
B, S = 2, 12


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module")
def model():
    """The reference's params (with a non-zero bonus ``u`` and a varied
    decay base, so every term of the recurrence counts) and a classic
    adapter tree with non-zero B, and the port's copies of both."""
    rng = np.random.default_rng(0)
    jparams = JT.init(JCFG, jax.random.PRNGKey(0))
    mix = dict(jparams["blocks"][0]["mix"])
    mix["u"] = jnp.asarray(rng.normal(size=mix["u"].shape) * 0.5, jnp.float32)
    mix["w0"] = jnp.asarray(rng.uniform(-6, -1, size=mix["w0"].shape), jnp.float32)
    jparams["blocks"] = (dict(jparams["blocks"][0], mix=mix),)
    jad = j_init_lora(jparams, j_lora_targets(JCFG), 4, 8.0, jax.random.PRNGKey(1))

    def nonzero_b(path, leaf):
        if getattr(path[-1], "key", None) == "B":
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.05, leaf.dtype)
        return leaf

    jad = jax.tree_util.tree_map_with_path(nonzero_b, jad)
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    ad = adapters_from_numpy(jax.device_get(jad), device="cpu")
    toks = rng.integers(0, CFG.vocab_size, (B, S))
    return jparams, jad, params, ad, toks


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


def _jflat(tree):
    return {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_trees_and_convert_match_reference(dtype):
    """Plan, parameter tree (keys, shapes, the mixed dtypes: fp32 ``w0`` and
    ``u``, the rest in the model dtype), cache tree and LoRA targets equal
    the reference's; ``convert`` carries the reference's leaves bit for
    bit."""
    jcfg, cfg = JCFG.replace(dtype=dtype), CFG.replace(dtype=dtype)
    assert T.layer_plan(cfg) == JT.layer_plan(jcfg) == [("rwkv", 2)]
    assert lora_targets(cfg) == j_lora_targets(jcfg) == ("wr", "wk", "wv", "wg", "wo")
    jparams = jax.device_get(JT.init(jcfg, jax.random.PRNGKey(0)))
    want = _jflat(jparams)
    assert _flat(T.init(cfg, 0, device="cpu")) == want
    params = params_from_numpy(jparams, device="cpu")
    assert _flat(params) == want
    mix = params["blocks"][0]["mix"]
    assert mix["w0"].dtype == mix["u"].dtype == torch.float32
    assert mix["mu"].shape == (2, 5, 256) and mix["dd_w2"].shape == (2, 5, 16, 256)
    for name in ("w0", "u", "mu", "dd_w2", "wr"):
        np.testing.assert_array_equal(
            mix[name].float().numpy(),
            np.asarray(jparams["blocks"][0]["mix"][name], np.float32))
    assert _flat(T.init_cache(cfg, 3, 8, device="cpu")) == _jflat(
        JT.init_cache(jcfg, 3, 8))


def test_time_mix_and_channel_mix_match_reference(model):
    """Layer 0 with its adapters, full sequence (scan route) and one decode
    step from a non-zero state."""
    jparams, jad, params, ad, _ = model
    rng = np.random.default_rng(1)
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"][0]["mix"])
    ja = jax.tree.map(lambda x: x[0], jad["blocks"][0]["mix"])
    p = T._layer(params["blocks"][0]["mix"], 0)
    a = T._layer(ad["blocks"][0]["mix"], 0)
    x = rng.normal(size=(B, S, 256)).astype(np.float32)
    want, _ = JR.time_mix(JCFG, jp, jnp.asarray(x), ja)
    got, st = R.time_mix(CFG, p, _t(x), a)
    assert st is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want, _ = JR.channel_mix(JCFG, jp, jnp.asarray(x), ja)
    got, _ = R.channel_mix(CFG, p, _t(x), a)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    state = {"tm_x": rng.normal(size=(B, 256)).astype(np.float32),
             "wkv": rng.normal(size=(B, 8, 32, 32)).astype(np.float32),
             "cm_x": rng.normal(size=(B, 256)).astype(np.float32)}
    x1 = x[:, :1]
    jst = {k: jnp.asarray(v) for k, v in state.items()}
    tst = {k: _t(v) for k, v in state.items()}
    want, jnew = JR.time_mix(JCFG, jp, jnp.asarray(x1), ja, state=jst)
    got, tnew = R.time_mix(CFG, p, _t(x1), a, state=tst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("tm_x", "wkv"):
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]), **TOL)
    want, jnew = JR.channel_mix(JCFG, jp, jnp.asarray(x1), ja, state=jst)
    got, tnew = R.channel_mix(CFG, p, _t(x1), a, state=tst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tnew["cm_x"].numpy(), np.asarray(jnew["cm_x"]))


@pytest.mark.parametrize("mix", ["time_mix", "channel_mix"])
def test_bf16_decode_step_promotes_as_reference(mix):
    """In a bf16 model a decode step promotes as the reference's does: the
    fp32 state's shifted token makes the token shift, the ddlerp and the
    products of the mixed inputs fp32 against the bf16 weights.  Both sides
    run op by op and round at the same points: outputs within 1e-3 of their
    max |out| (a step computed in bf16 instead is 5e-3 to 1.1e-2 of it
    away)."""
    rng = np.random.default_rng(2)
    jcfg, cfg = JCFG.replace(dtype="bfloat16"), CFG.replace(dtype="bfloat16")
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    jp = dict(jax.tree.map(lambda x: x[0], jparams["blocks"][0]["mix"]))
    jp["u"] = jnp.asarray(rng.normal(size=jp["u"].shape) * 0.5, jnp.float32)
    jp["w0"] = jnp.asarray(rng.uniform(-6, -1, size=jp["w0"].shape), jnp.float32)
    ja = j_init_lora({"mix": jp}, j_lora_targets(jcfg), 4, 8.0,
                     jax.random.PRNGKey(1), dtype=jnp.bfloat16)["mix"]
    for leaf in ja.values():
        leaf["B"] = jnp.asarray(rng.normal(size=leaf["B"].shape) * 0.05,
                                jnp.bfloat16)
    p = params_from_numpy(jax.device_get(jp), device="cpu")
    a = adapters_from_numpy(jax.device_get(ja), device="cpu")
    x = rng.normal(size=(3, 1, 256)).astype(np.float32)
    # the carried tokens are bf16 values in fp32 leaves, as decode writes them
    state = {"tm_x": rng.normal(size=(3, 256)), "cm_x": rng.normal(size=(3, 256)),
             "wkv": rng.normal(size=(3, 8, 32, 32))}
    state = {k: np.asarray(jnp.asarray(v, jnp.bfloat16 if k != "wkv"
                                       else jnp.float32), np.float32)
             for k, v in state.items()}
    want, _ = getattr(JR, mix)(jcfg, jp, jnp.asarray(x, jnp.bfloat16), ja,
                               state={k: jnp.asarray(v) for k, v in state.items()})
    got, _ = getattr(R, mix)(cfg, p, _t(x).bfloat16(), a,
                             state={k: _t(v) for k, v in state.items()})
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    assert np.abs(got.float().numpy() - want).max() <= 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_matches_reference(model, use_kernels):
    """Final hidden states over the whole sequence, with adapters; the
    kernel route (``wkv6`` and ``lora_matmul``, plain versions here) against
    the reference's plain route."""
    jparams, jad, params, ad, toks = model
    want, _ = JT.forward(JCFG, jparams, {"tokens": jnp.asarray(toks)}, jad)
    got, aux = T.forward(CFG, params, {"tokens": _t(toks)}, ad,
                         use_kernels=use_kernels)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_prefill_step_matches_reference(model):
    """``make_prefill_step(use_kernels=True)`` on both sides (the reference
    runs its Pallas ``wkv6`` in interpret mode): last-position logits."""
    jparams, jad, params, ad, toks = model
    want = j_make_prefill_step(JCFG, use_kernels=True)(
        jparams, jad, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(CFG, use_kernels=True)(params, ad,
                                                   {"tokens": _t(toks)})
    assert got.shape == (B, CFG.vocab_size) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_matches_reference_and_forward(model):
    """Token-by-token decode: each step's logits against the reference's
    decode (1e-4), and the whole run against the port's own forward (the
    reference's bound, 2e-4 of max |logit|)."""
    jparams, jad, params, ad, toks = model
    jc = JT.init_cache(JCFG, B, 16, kv_dtype=jnp.float32)
    tc = T.init_cache(CFG, B, 16, device="cpu")
    jdec = jax.jit(lambda c, t: JT.decode(JCFG, jparams, c, {"tokens": t}, jad))
    outs = []
    for t in range(S):
        want, jc = jdec(jc, jnp.asarray(toks[:, t:t + 1]))
        got, tc = T.decode(CFG, params, tc, {"tokens": _t(toks[:, t:t + 1])}, ad)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        outs.append(got[:, 0])
    for name in ("tm_x", "wkv", "cm_x"):
        np.testing.assert_allclose(tc[0][name].numpy(), np.asarray(jc[0][name]),
                                   **TOL)
    hidden, _ = T.forward(CFG, params, {"tokens": _t(toks)}, ad)
    full = T.logits(CFG, params, hidden).detach()
    dec = torch.stack(outs, 1)
    assert float((dec - full).abs().max()) < 2e-4 * float(full.abs().max())


def test_decode_rejects_a_chunk(model):
    _, _, params, _, toks = model
    tc = T.init_cache(CFG, B, 16, device="cpu")
    with pytest.raises(ValueError, match="single-token"):
        T.decode(CFG, params, tc, {"tokens": _t(toks[:, :2])})


def test_rows_without_tokens_keep_their_state(model):
    """``n_tokens == 0`` rows leave every state leaf untouched (the
    reference's ``_mask_state_rows``); the other rows match the reference."""
    jparams, jad, params, ad, toks = model
    jc = JT.init_cache(JCFG, B, 16, kv_dtype=jnp.float32)
    tc = T.init_cache(CFG, B, 16, device="cpu")
    for t, n in enumerate(([1, 1], [0, 1], [1, 0], [1, 1])):
        n = np.asarray(n, np.int32)
        before = {k: v.clone() for k, v in tc[0].items()}
        want, jc = JT.decode(JCFG, jparams, jc, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                             jad, n_tokens=jnp.asarray(n))
        got, tc = T.decode(CFG, params, tc, {"tokens": _t(toks[:, t:t + 1])}, ad,
                           n_tokens=_t(n))
        for k, v in tc[0].items():
            kept = v[:, n == 0]
            assert torch.equal(kept, before[k][:, n == 0]), k
            np.testing.assert_allclose(v.numpy(), np.asarray(jc[0][k]), **TOL)
        live = n > 0
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], **TOL)


def test_reset_slots_wipes_recurrent_state():
    """Mirror of the reference's test of the same name
    (tests/test_serve.py): reset_slots on a whole init_cache tuple zeroes
    the masked rows of the RWKV6 recurrent state and leaves the others;
    reset_slot, which has no ``pos`` leaf to read, does the same."""
    Bn = 5                      # unambiguous batch-axis size
    cache = T.init_cache(CFG, Bn, 8, device="cpu")
    for leaf in cache[0].values():
        leaf += 1
    mask = np.zeros(Bn, bool)
    mask[3] = True
    wiped = Kv.reset_slots(cache, mask)
    assert wiped is cache
    for leaf in cache[0].values():
        bax = [i for i, s in enumerate(leaf.shape) if s == Bn][0]
        moved = torch.movedim(leaf, bax, 0)
        assert (moved[3] == 0).all()
        assert (moved[0] != 0).any()
    Kv.reset_slot(cache, 1)
    assert all((v[:, 1] == 0).all() and (v[:, 0] != 0).any()
               for v in cache[0].values())


def test_rmsnorm_is_the_block_norm(model):
    """The RWKV6 blocks normalise with the dense path's rmsnorm, as the
    reference's do: layer 0 of the forward by hand equals the port's."""
    _, _, params, ad, toks = model
    p = T._layer(params["blocks"][0], 0)
    a = T._layer(ad["blocks"][0], 0)
    x = params["embed"][_t(toks)]
    h, _ = R.time_mix(CFG, p["mix"], Lyr.rmsnorm(x, p["ln1"]), a["mix"])
    y = x + h
    h, _ = R.channel_mix(CFG, p["mix"], Lyr.rmsnorm(y, p["ln2"]), a["mix"])
    got = T._block_fwd(CFG, "rwkv", p, x, a, use_kernels=False)
    torch.testing.assert_close(got, y + h, rtol=0, atol=0)
