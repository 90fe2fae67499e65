"""Port parity: ring-cache writes, int8 quantization and slot resets of
``repro_torch.serve.kvcache`` equal the reference's ``repro.serve.kvcache``
exactly (bit for bit), on inputs drawn with numpy from a seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.common.config import ModelConfig as JModelConfig  # noqa: E402
from repro.serve import kvcache as JKv  # noqa: E402
from repro_torch.common.config import ModelConfig  # noqa: E402
from repro_torch.serve import kvcache as Kv  # noqa: E402

DIMS = dict(name="t", family="dense", num_layers=1, d_model=32, num_heads=4,
            num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("C,cap", [(3, 8), (5, 5), (7, 4)])
def test_ring_write_matches_reference(C, cap):
    """Ragged n_tokens incl. 0 and n > cap (last cap tokens win), wrapped
    write heads; C > cap takes the lane-by-lane path."""
    rng = np.random.default_rng(C * 10 + cap)
    B = 5
    buf = rng.normal(size=(B, cap, 2, 3)).astype(np.float32)
    val = rng.normal(size=(B, C, 2, 3)).astype(np.float32)
    pos = rng.integers(0, 3 * cap, size=B).astype(np.int32)
    n = np.asarray([C, 0, 1, min(C, 2), C], np.int32)
    want = np.asarray(JKv._ring_write(jnp.asarray(buf), jnp.asarray(val),
                                      jnp.asarray(pos), jnp.asarray(n)))
    got = Kv._ring_write(_t(buf), _t(val), _t(pos), _t(n)).numpy()
    np.testing.assert_array_equal(got, want)


def test_quant_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 6, 2, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                                  # absmax floor 1e-8
    x[1, 1, 1, :4] = [127 * 0.5, -127 * 0.5, 0.5, 1.5]   # rounding ties
    jq, js = JKv.quant(jnp.asarray(x))
    q, s = Kv.quant(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_cache_update_and_reset_match_reference(dtype):
    """Two chunk writes (the second wraps the ring), then a reset of two
    slots: every leaf equals the reference's exactly."""
    rng = np.random.default_rng(1)
    jcfg, cfg = JModelConfig(**DIMS), ModelConfig(**DIMS)
    B, cap = 3, 6
    jc = JKv.attn_cache(jcfg, B, cap, getattr(jnp, dtype))
    tc = Kv.attn_cache(cfg, B, cap, getattr(torch, dtype), "cpu")
    for C, n in ((4, [4, 2, 0]), (4, [3, 4, 1])):
        k = rng.normal(size=(B, C, 2, 8)).astype(np.float32)
        v = rng.normal(size=(B, C, 2, 8)).astype(np.float32)
        n = np.asarray(n, np.int32)
        jc = JKv.cache_update(jcfg, jc, jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(n))
        tc = Kv.cache_update(cfg, tc, _t(k), _t(v), _t(n))
    assert set(tc) == set(jc)
    for name in jc:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]),
                                      err_msg=name)
    jk, jv = JKv.cache_kv(jcfg, jc)
    tk, tv = Kv.cache_kv(cfg, tc)
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(jk.astype(jnp.float32)))
    mask = np.asarray([True, False, True])
    jc = JKv.reset_slots(jc, jnp.asarray(mask))
    Kv.reset_slots(tc, mask)
    for name in jc:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]),
                                      err_msg=f"after reset: {name}")


def test_reset_slot_on_stacked_cache_tuple():
    """A layer-stacked cache tuple (L, B, ...): the batch axis is found
    from the leaf-rank table, as in the reference."""
    rng = np.random.default_rng(2)
    tree = ({"k": rng.normal(size=(2, 3, 4, 2, 8)).astype(np.float32),
             "v": rng.normal(size=(2, 3, 4, 2, 8)).astype(np.float32),
             "pos": np.asarray([[5, 6, 7]] * 2, np.int32),
             "length": np.asarray([[4, 4, 4]] * 2, np.int32)},)
    want = JKv.reset_slot(tuple({k: jnp.asarray(v) for k, v in c.items()}
                                for c in tree), 1)
    got = Kv.reset_slot(tuple({k: _t(v) for k, v in c.items()}
                              for c in tree), 1)
    for name in tree[0]:
        np.testing.assert_array_equal(got[0][name].numpy(),
                                      np.asarray(want[0][name]), err_msg=name)
