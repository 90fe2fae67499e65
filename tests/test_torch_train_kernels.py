"""Port parity of the federated round's kernel wrappers: the port's
``ops.lora_matmul``, ``ops.flash_attention`` and ``ops.adapter_gram`` on CPU
tensors (their plain versions, with the port's autograd backward passes)
against the reference's Pallas kernels in interpret mode (``jax.vjp`` for
the gradients).

Inputs are drawn with numpy from a seed and fed to both.  fp32 throughout:
``lora_matmul`` at rtol 1e-5 / atol 1e-6, ``flash_attention`` and
``adapter_gram`` at 1e-5 (sums taken in another order).  The CUDA kernels
themselves run only on the card, where ``chip_smoke.py`` holds them against
these plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.adapter_gram import ROWS, TARGET_BLOCKS, TILE, panels  # noqa: E402


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


@pytest.mark.parametrize("lead,din,dout,r,scale", [
    ((2, 8), 32, 24, 4, 2.0),       # one block, padded on the reference side
    ((3, 50), 40, 136, 12, 0.5),    # ragged M (150) and dout (136 > 128)
    ((1, 7), 16, 8, 1, -1.5),       # rank 1, negative scale
])
def test_lora_matmul_forward_and_grads(lead, din, dout, r, scale):
    rng = np.random.default_rng(din + dout + r)
    x = rng.normal(size=lead + (din,)).astype(np.float32)
    w = (rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32)
    a = (rng.normal(size=(r, din)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(dout, r)) * 0.2).astype(np.float32)
    s = np.float32(scale)
    g = (rng.normal(size=lead + (dout,)) * 0.1).astype(np.float32)

    y_j, pull = jax.vjp(lambda x_, a_, b_, s_: jops.lora_matmul(
        x_, jnp.asarray(w), a_, b_, s_), jnp.asarray(x), jnp.asarray(a),
        jnp.asarray(b), jnp.asarray(s))
    want = [np.asarray(y_j)] + [np.asarray(t) for t in pull(jnp.asarray(g))]

    xt, at, bt, st = _t(x, True), _t(a, True), _t(b, True), _t(s, True)
    y = tops.lora_matmul(xt, _t(w), at, bt, st)
    y.backward(_t(g))
    got = [y.detach().numpy(), xt.grad.numpy(), at.grad.numpy(),
           bt.grad.numpy(), st.grad.numpy()]
    assert got[4].shape == ()
    for name, gv, wv in zip(("y", "dx", "dA", "dB", "dscale"), got, want):
        np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("B,S,H,K,hd,causal,window", [
    (1, 136, 4, 2, 16, True, 0),      # S past one 128-block: reference pads
    (2, 40, 4, 1, 16, True, 16),      # window + MQA
    (1, 48, 8, 2, 32, False, 0),      # non-causal, GQA 4x
    (1, 72, 2, 2, 16, False, 20),     # window without causal
])
def test_flash_attention_forward_and_grads(B, S, H, K, hd, causal, window):
    rng = np.random.default_rng(S + H + window)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    g = rng.normal(size=(B, S, H, hd)).astype(np.float32)

    o_j, pull = jax.vjp(lambda q_, k_, v_: jops.flash_attention(
        q_, k_, v_, causal=causal, window=window), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(o_j)] + [np.asarray(t) for t in pull(jnp.asarray(g))]

    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    o = tops.flash_attention(qt, kt, vt, causal=causal, window=window)
    o.backward(_t(g))
    got = [o.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(),
           vt.grad.numpy()]
    for name, gv, wv in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", [(600, 12), (3, 600, 12), (2, 100, 40)])
def test_adapter_gram(shape):
    """Tail panel (600 rows over the reference's 512-row panels) and a
    batch axis (the reference's vmap)."""
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(np.float32)
    fn = jops.adapter_gram if len(shape) == 2 else jax.vmap(jops.adapter_gram)
    want = np.asarray(fn(jnp.asarray(x)))
    got = tops.adapter_gram(_t(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("G,m,r,want", [
    (32, 2048, 64, (224, 10)), (32, 512, 16, (32, 16)), (1, 70, 5, (32, 3)),
    (2, 2048, 512, (672, 4)), (132, 40, 8, (32, 2)), (32, 2048, 128, (672, 4))])
def test_adapter_gram_panels_cover_m(G, m, r, want):
    """The panel split covers every row once, in 32-row multiples, and
    gives the card at least TARGET_BLOCKS blocks where m allows it."""
    rows, n = panels(G, m, r)
    assert (rows, n) == want
    assert rows % ROWS == 0 and (n - 1) * rows < m <= n * rows
    blocks = G * (-(-r // TILE)) ** 2
    assert blocks * n >= min(TARGET_BLOCKS, blocks * -(-m // ROWS))


def test_wrappers_take_plain_version_only_for_cpu_tensors():
    """CPU tensors run the plain versions and count no launch; tensors on
    another device reach the CUDA launchers, whose checks raise before any
    launch (the meta device is not CUDA)."""
    tops.reset_launch_counts()
    x, w = torch.zeros(1, 4, 16), torch.zeros(16, 8)
    a, b, s = torch.zeros(2, 16), torch.zeros(8, 2), torch.ones(())
    q, kv = torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 1, 16)
    tops.lora_matmul(x, w, a, b, s)
    tops.flash_attention(q, kv, kv)
    tops.adapter_gram(torch.zeros(2, 8, 4))
    names = ("lora_matmul", "flash_attention", "adapter_gram")
    assert all(tops.launch_counts()[n] == 0 for n in names)
    m = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        tops.lora_matmul(m(x), m(w), m(a), m(b), m(s))
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(m(q), m(kv), m(kv))
    with pytest.raises(ValueError, match="CUDA"):
        tops.adapter_gram(m(torch.zeros(2, 8, 4)))
    assert all(tops.launch_counts()[n] == 0 for n in names)
