"""Port parity for the Mamba2 (SSD) layer: the parameter tree, one
mixer's full-sequence forward at S < 256 (one chunk) and S = 512 (two
chunks of 256), the chunked SSD and its gradients at strong decay, the
decode step with masked rows and its fp32 state, against the JAX
reference (``repro.models.ssm``) on the ``zamba2-smoke`` widths (fp32),
with the reference's own parameters carried across through numpy.

Tolerances: outputs within 1e-5 · max(1, |y|) (fp32 on both sides, sums
in another order); the SSD's gradients within 1e-4 · max(1, |g|) (the
gradient with respect to the log-decays sums long cumulative products: in
fp32 both packages lie up to 1.9e-5 of max |g| from a float64 evaluation,
and 3.7e-5 from each other); one bf16 decode
step within 1e-2 of max |y| (both sides round to bf16 at the same points;
a conv run in bf16 instead of fp32 is further).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.configs import lora_targets as j_lora_targets  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.peft.lora import init_lora as j_init_lora  # noqa: E402
from repro_torch.configs import zamba2_1p2b  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

JCFG = get_smoke_config("zamba2-1.2b")
CFG = zamba2_1p2b.SMOKE
B = 2


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _mixer(cfg=JCFG, key=0):
    """Layer 0's mixer of the reference's params (a varied ``D`` and
    ``dt_bias``, so every term counts), a classic adapter on ``in_proj``
    and ``out_proj`` with non-zero B, and the port's copies."""
    rng = np.random.default_rng(key)
    jparams = JT.init(cfg, jax.random.PRNGKey(key))
    jp = dict(jax.tree.map(lambda t: t[0], jparams["blocks"][0]["mixer"]))
    H = cfg.num_ssm_heads
    jp["D"] = jnp.asarray(rng.uniform(0.5, 1.5, H), jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.normal(size=H) * 0.5, jnp.float32)
    jp["conv_b"] = jnp.asarray(rng.normal(size=jp["conv_b"].shape) * 0.1,
                               jp["conv_b"].dtype)
    ja = j_init_lora({"mixer": jp}, j_lora_targets(cfg), 4, 8.0,
                     jax.random.PRNGKey(key + 1), dtype=jnp.dtype(cfg.dtype))["mixer"]
    for leaf in ja.values():
        leaf["B"] = jnp.asarray(rng.normal(size=leaf["B"].shape) * 0.05,
                                leaf["B"].dtype)
    p = params_from_numpy(jax.device_get(jp), device="cpu")
    a = adapters_from_numpy(jax.device_get(ja), device="cpu")
    return jp, ja, p, a, rng


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_segment_tree_matches_reference(dtype):
    """Keys, stacked shapes and dtypes of a Mamba2 segment: ``A_log``,
    ``D`` and ``dt_bias`` fp32 beside weights in the model dtype; ``A_log``
    the reference's values."""
    jcfg, cfg = JCFG.replace(dtype=dtype), CFG.replace(dtype=dtype)
    jseg = jax.device_get(JT.init(jcfg, jax.random.PRNGKey(0))["blocks"][0])
    seg = T.init(cfg, 0, device="cpu")["blocks"][0]
    assert _flat(seg) == _flat(jseg)
    np.testing.assert_allclose(seg["mixer"]["A_log"].numpy(),
                               np.asarray(jseg["mixer"]["A_log"]), rtol=1e-6)


@pytest.mark.parametrize("seq", [32, 512])
def test_mamba2_fwd_matches_reference(seq):
    """One mixer over a whole sequence with adapters: one chunk (S 32) and
    two chunks of 256 (S 512); the lora_matmul route (its plain version
    here) too."""
    jp, ja, p, a, rng = _mixer()
    x = rng.normal(size=(B, seq, JCFG.d_model)).astype(np.float32)
    want = JS.mamba2_fwd(JCFG, jp, jnp.asarray(x), ja)
    for use_kernel in (False, True):
        got = S.mamba2_fwd(CFG, p, _t(x), a, use_kernel=use_kernel)
        _close(got, want)


def _ssd_inputs(rng, seq, H=4, hd=8, st=16, strong=False):
    xs = rng.normal(size=(B, seq, H, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, seq, H)) + (2.0 if strong else 0.0)))
    A = -np.exp(np.log(np.linspace(1.0, 16.0, H)))
    dA = (dt * A).astype(np.float32)
    Bm = rng.normal(size=(B, seq, st)).astype(np.float32)
    Cm = rng.normal(size=(B, seq, st)).astype(np.float32)
    return xs, dt.astype(np.float32), dA, Bm, Cm


@pytest.mark.parametrize("seq,strong", [(64, False), (512, False), (512, True)])
def test_ssd_chunked_and_grads_match_reference(seq, strong):
    """The chunked SSD's output and the gradients of a weighted sum of it
    with respect to every input.  Strong decay (cumulative log-decays of
    -1e4 over a chunk) makes the masked entries' exp overflow: the mask
    taken before exp keeps the gradients finite and equal to the
    reference's."""
    rng = np.random.default_rng(seq + strong)
    ins = _ssd_inputs(rng, seq, strong=strong)
    w = rng.normal(size=(B, seq, 4, 8)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(JS._ssd_chunked(*a) * w)

    want_y = JS._ssd_chunked(*map(jnp.asarray, ins))
    want_g = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))
    ts = [_t(v).requires_grad_(True) for v in ins]
    y = S._ssd_chunked(*ts)
    _close(y, want_y)
    gs = torch.autograd.grad((y * _t(w)).sum(), ts)
    for g, wg in zip(gs, want_g):
        assert bool(torch.isfinite(g).all())
        _close(g, wg, 1e-4)


def test_ssd_refuses_a_ragged_sequence():
    ins = [_t(v) for v in _ssd_inputs(np.random.default_rng(0), 300)]
    with pytest.raises(ValueError, match="do not tile"):
        S._ssd_chunked(*ins)


def test_decode_steps_match_reference_with_masked_rows():
    """Six decode steps from a random state against the reference's
    ``mamba2_decode`` and ``_mask_state_rows``; row 1 has ``n_tokens`` 0 on
    alternate steps and keeps its state there, through the model's
    ``_block_decode``, which writes the cache in place."""
    jp, ja, p, a, rng = _mixer(key=3)
    cdim = JCFG.d_inner + 2 * JCFG.ssm_state
    jstate = {"conv": jnp.asarray(rng.normal(size=(B, JCFG.ssm_conv - 1, cdim)),
                                  jnp.float32),
              "ssm": jnp.asarray(rng.normal(size=(B, JCFG.num_ssm_heads,
                                                  JCFG.ssm_state,
                                                  JCFG.ssm_head_dim)) * 0.1,
                                 jnp.float32)}
    jblk = {"ln": jnp.ones((JCFG.d_model,), jnp.float32), "mixer": jp}
    blk = {"ln": torch.ones(CFG.d_model), "mixer": p}
    cache = {k: _t(v) for k, v in jax.device_get(jstate).items()}
    addr = {k: v.data_ptr() for k, v in cache.items()}
    for step in range(6):
        x = rng.normal(size=(B, 1, JCFG.d_model)).astype(np.float32)
        n = np.array([1, step % 2], np.int32)
        want, jstate = JT._block_decode(JCFG, "mamba", jblk, jnp.asarray(x),
                                        jstate, {"mixer": ja}, jnp.asarray(n))
        before = {k: v.clone() for k, v in cache.items()}
        got, cache = T._block_decode(CFG, "mamba", blk, _t(x), cache,
                                     {"mixer": a}, _t(n))
        _close(got, want)
        for k in ("conv", "ssm"):
            assert cache[k].dtype == torch.float32
            assert cache[k].data_ptr() == addr[k]
            _close(cache[k], jstate[k])
            if n[1] == 0:
                assert torch.equal(cache[k][1], before[k][1])


def test_bf16_decode_step_promotes_as_reference():
    """In a bf16 model the fp32 conv history joined with the bf16 ``xBC``
    makes the conv run in fp32, cast to bf16 only after the SiLU; the new
    state is fp32 (``conv`` holds the bf16 token's values exactly)."""
    jcfg, cfg = JCFG.replace(dtype="bfloat16"), CFG.replace(dtype="bfloat16")
    jp, ja, p, a, rng = _mixer(jcfg, key=5)
    cdim = jcfg.d_inner + 2 * jcfg.ssm_state
    conv = np.asarray(jnp.asarray(rng.normal(size=(3, jcfg.ssm_conv - 1, cdim)),
                                  jnp.bfloat16), np.float32)
    ssm = (rng.normal(size=(3, jcfg.num_ssm_heads, jcfg.ssm_state,
                            jcfg.ssm_head_dim)) * 0.1).astype(np.float32)
    x = rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
    want, wst = JS.mamba2_decode(jcfg, jp, jnp.asarray(x, jnp.bfloat16),
                                 {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}, ja)
    got, st = S.mamba2_decode(cfg, p, _t(x).bfloat16(),
                              {"conv": _t(conv), "ssm": _t(ssm)}, a)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert st["conv"].dtype == st["ssm"].dtype == torch.float32
    assert wst["conv"].dtype == wst["ssm"].dtype == jnp.float32
    want = np.asarray(want, np.float32)
    assert np.abs(got.float().numpy() - want).max() <= 1e-2 * np.abs(want).max()
    _close(st["conv"], wst["conv"], 1e-6)
    _close(st["ssm"], wst["ssm"], 1e-2)


def test_init_state_is_fp32_at_the_reference_shapes():
    want = jax.device_get(JS.mamba2_init_state(JCFG, 3))
    got = S.mamba2_init_state(CFG, 3, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (v.shape, torch.float32) for k, v in want.items()}
