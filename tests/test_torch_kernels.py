"""Port parity: the plain versions of the port's kernels (what
``repro_torch.kernels.ops`` runs on a CPU tensor) against the JAX reference
— ``ring_decode_ref`` and the Pallas ``ops.ring_decode`` in interpret mode,
``paged_lora_delta`` through its ``"xla"`` twin and the Pallas ``bgmv``.

Inputs are drawn with numpy from a seed and fed to both.  Tolerance 2e-5
(as tests/test_decode_kernels.py) for attention: fp32 throughout, sums
taken in another order.  1e-5 for the LoRA delta.  The CUDA kernels
themselves run only on the card (``chip_smoke.py`` holds them against
these plain versions there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.peft.lora import PagedLoRA as JPagedLoRA  # noqa: E402
from repro.peft.lora import paged_lora_delta as j_paged_lora_delta  # noqa: E402
from repro.serve.kvcache import quant as jquant  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models.attention_core import (ring_attend_mask,  # noqa: E402
                                               ring_block_mask)

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _states():
    """(pos, length): mid-prefill, exactly full, wrapped, never written."""
    return (np.asarray([3, 20, 33, 0], np.int32),
            np.asarray([3, 20, 20, 0], np.int32))


def _case(seed, B=4, C=3, H=8, K=2, hd=16, cap=20):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, C, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, cap, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, cap, K, hd)).astype(np.float32)
    return q, k, v


def _both(q, k, v, pos, length, n, window=0, ks=None, vs=None):
    """(port plain version, JAX dense oracle, JAX Pallas interpret)."""
    got = tops.ring_decode(_t(q), _t(k), _t(v), _t(pos), _t(length), _t(n),
                           window=window,
                           k_scale=None if ks is None else _t(ks),
                           v_scale=None if vs is None else _t(vs)).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, pos, length, n)]
    jkw = dict(window=window,
               k_scale=None if ks is None else jnp.asarray(ks),
               v_scale=None if vs is None else jnp.asarray(vs))
    want = np.asarray(jref.ring_decode_ref(*jargs, **jkw))
    pallas = np.asarray(jops.ring_decode(*jargs, bk=8, **jkw))
    return got, want, pallas


@pytest.mark.parametrize("window", [0, 5])
def test_ring_decode_matches_reference(window):
    """All four ring states in one batch, incl. wraparound and a
    never-written row (excluded: degenerate softmax, discarded by callers)."""
    q, k, v = _case(0)
    pos, length = _states()
    n = np.full((4,), 3, np.int32)
    got, want, pallas = _both(q, k, v, pos, length, n, window=window)
    np.testing.assert_allclose(got[:3], want[:3], **TOL)
    np.testing.assert_allclose(got[:3], pallas[:3], **TOL)


def test_ring_decode_ragged_valid_positions():
    q, k, v = _case(1)
    pos, length = _states()
    n = np.asarray([3, 1, 2, 0], np.int32)
    got, want, pallas = _both(q, k, v, pos, length, n, window=4)
    valid = np.arange(3)[None, :] < n[:, None]
    np.testing.assert_allclose(got[valid], want[valid], **TOL)
    np.testing.assert_allclose(got[valid], pallas[valid], **TOL)


@pytest.mark.parametrize("K", [1, 4, 8])
def test_ring_decode_gqa_and_mqa(K):
    q, k, v = _case(2, K=K)
    pos, length = _states()
    n = np.full((4,), 3, np.int32)
    got, want, _ = _both(q, k, v, pos, length, n)
    np.testing.assert_allclose(got[:3], want[:3], **TOL)


@pytest.mark.parametrize("window", [0, 9])
def test_ring_decode_wide_chunk_ragged_and_wrapped(window):
    """A 16-query chunk (the engine's prefill width) with n_tokens ragged
    across rows, on rings that are wrapped, exactly full, partial and
    fresh: the shapes of the CUDA kernel's tensor-core route."""
    q, k, v = _case(5, B=5, C=16, H=8, K=2, cap=40)
    pos = np.asarray([57, 40, 21, 16, 93], np.int32)
    length = np.minimum(pos, 40).astype(np.int32)
    n = np.asarray([16, 3, 9, 16, 1], np.int32)
    got, want, pallas = _both(q, k, v, pos, length, n, window=window)
    valid = np.arange(16)[None, :] < n[:, None]
    np.testing.assert_allclose(got[valid], want[valid], **TOL)
    np.testing.assert_allclose(got[valid], pallas[valid], **TOL)


def test_ring_decode_int8():
    """int8 cache with per-token scales, quantized by the reference."""
    q, k, v = _case(3, hd=64)
    pos, length = _states()
    n = np.full((4,), 3, np.int32)
    kq, ks = (np.asarray(a) for a in jquant(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jquant(jnp.asarray(v)))
    got, want, pallas = _both(q, kq, vq, pos, length, n, ks=ks, vs=vs)
    np.testing.assert_allclose(got[:3], want[:3], **TOL)
    np.testing.assert_allclose(got[:3], pallas[:3], **TOL)


def test_ring_masks_match_reference():
    """Dense ring mask and per-tile masks (the CUDA kernel's math) equal the
    reference's, including never-written slots where ``last - s < 0``
    needs a floor modulo, and tile padding past ``cap``."""
    from repro.models.attention_core import (
        ring_attend_mask as j_attend, ring_block_mask as j_block)
    rng = np.random.default_rng(4)
    for cap, C, window in ((20, 3, 0), (7, 2, 3), (5, 4, 9)):
        pos = rng.integers(0, 3 * cap, size=6).astype(np.int32)
        pos[0] = 0
        length = np.minimum(pos, cap).astype(np.int32)
        n = np.minimum(pos, rng.integers(0, C + 1, size=6)).astype(np.int32)
        qpos = (pos - n)[:, None] + np.arange(C)[None, :]
        want = np.asarray(j_attend(jnp.asarray(pos), jnp.asarray(length), cap,
                                   jnp.asarray(qpos), window))
        got = ring_attend_mask(_t(pos), _t(length), cap, _t(qpos), window)
        np.testing.assert_array_equal(got.numpy(), want)
        for start in (0, 8):
            wb = np.asarray(j_block(jnp.asarray(pos), jnp.asarray(length),
                                    jnp.asarray(n), cap, start, 8, C, window))
            gb = ring_block_mask(_t(pos), _t(length), _t(n), cap, start, 8, C,
                                 window)
            np.testing.assert_array_equal(gb.numpy(), wb)


def _paged_case(seed, B=5, C=2, din=24, dout=16, P=10, pr=4, maxA=6, Pmax=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, C, din)).astype(np.float32)
    a = rng.normal(size=(P, pr, din)).astype(np.float32)
    b = rng.normal(size=(P, dout, pr)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=maxA).astype(np.float32)
    table = rng.integers(0, P, size=(maxA, Pmax)).astype(np.int32)
    rank = np.asarray([0, 3, 12, 4, 9, 0], np.int32)     # id 0 = base
    ids = np.asarray([1, 0, 2, 4, 5], np.int32)[:B]
    return x, a, b, scale, table, rank, ids


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_bgmv_matches_paged_lora_delta(impl):
    """Heterogeneous ranks (3, 12, 9, not page multiples), an evicted id
    (rank 0) and the base id: the port's plain bgmv equals the reference's
    paged delta, and rank-0 rows are exact zeros."""
    x, a, b, scale, table, rank, ids = _paged_case(5)
    got = tops.bgmv(_t(x), _t(a), _t(b), _t(table), _t(rank), _t(scale),
                    _t(ids)).numpy()
    ad = JPagedLoRA(jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale),
                    jnp.asarray(table), jnp.asarray(rank), jnp.asarray(ids),
                    impl=impl)
    want = np.asarray(j_paged_lora_delta(jnp.asarray(x), ad))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    zero_rows = rank[ids] == 0
    assert zero_rows.any() and (got[zero_rows] == 0).all()
