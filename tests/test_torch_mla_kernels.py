"""Port parity for the MLA latent decode kernel's plain version (what
``repro_torch.kernels.ops.mla_ring_decode`` runs on a CPU tensor) against the
JAX reference: ``repro.kernels.ref.mla_ring_decode_ref`` and the Pallas
``ops.mla_ring_decode`` in interpret mode.

Inputs are drawn with numpy from a seed and fed to both; bf16 caches are
rounded once with ``ml_dtypes`` and handed to both sides as the same bits,
int8 caches are quantized once, per half, with the reference's ``quant``.
Outputs are compared on valid query positions ``t < n_tokens[b]`` at 1e-4
(the reference's own MLA tolerance, tests/test_decode_kernels.py): fp32 on
both sides, sums taken in another order.  The CUDA kernel itself runs only
on the card (``chip_smoke.py`` holds it against this plain version there).
"""
import math

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.serve.kvcache import quant as jquant  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import mla_ring_decode as tmla  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
KVR, ROPE, NOPE = 32, 16, 32
SCALE = 1.0 / math.sqrt(NOPE + ROPE)
# ring states AFTER the write: mid-prefill, exactly full, wrapped twice,
# never written (its row has n = 0 and is excluded from the comparison)
POS = np.asarray([3, 20, 47, 0], np.int32)
LEN = np.asarray([3, 20, 20, 0], np.int32)


def _inputs(seed, C, cap=20, H=4, B=4):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, C, H, KVR + ROPE)).astype(np.float32)
    c_kv = rng.normal(size=(B, cap, KVR)).astype(np.float32)
    k_rope = rng.normal(size=(B, cap, ROPE)).astype(np.float32)
    return q, c_kv, k_rope


def _cache(kind, c_kv, k_rope):
    """(c_kv, k_rope, c_kv_scale, k_rope_scale) as numpy storage."""
    if kind == "bfloat16":
        return (c_kv.astype(ml_dtypes.bfloat16),
                k_rope.astype(ml_dtypes.bfloat16), None, None)
    if kind == "int8":
        (q1, s1), (q2, s2) = jquant(jnp.asarray(c_kv)), jquant(jnp.asarray(k_rope))
        return tuple(np.asarray(a) for a in (q1, q2, s1, s2))
    return c_kv, k_rope, None, None


def _run(q, ckv, kr, cs, rs, n, window):
    t = [None if a is None else tensor_from_numpy(a, "cpu")
         for a in (q, ckv, kr, POS, LEN, n, cs, rs)]
    got = tops.mla_ring_decode(*t[:6], scale=SCALE, window=window,
                               c_kv_scale=t[6], k_rope_scale=t[7]).numpy()
    j = [None if a is None else jnp.asarray(a)
         for a in (q, ckv, kr, POS, LEN, n, cs, rs)]
    kw = dict(window=window, c_kv_scale=j[6], k_rope_scale=j[7])
    want = np.asarray(jref.mla_ring_decode_ref(*j[:6], SCALE, **kw))
    pallas = np.asarray(jops.mla_ring_decode(*j[:6], scale=SCALE, bk=8, **kw))
    return got, want, pallas


@pytest.mark.parametrize("seed,kind,C,window,n", [
    (0, "float32", 3, 0, [3, 3, 3, 0]),
    (1, "float32", 1, 0, [1, 1, 1, 0]),
    (2, "float32", 3, 5, [3, 1, 2, 0]),
    (3, "bfloat16", 3, 0, [3, 2, 3, 0]),
    (4, "bfloat16", 1, 4, [1, 1, 1, 0]),
    (5, "int8", 3, 0, [3, 3, 1, 0]),
    (6, "int8", 1, 6, [1, 1, 1, 0]),
])
def test_mla_ring_decode_plain_matches_reference(seed, kind, C, window, n):
    """Every dtype with a wrapped ring, a never-written row (n = 0), C > 1
    with ragged n, and sliding windows."""
    q, c_kv, k_rope = _inputs(seed, C)
    ckv, kr, cs, rs = _cache(kind, c_kv, k_rope)
    n = np.asarray(n, np.int32)
    got, want, pallas = _run(q, ckv, kr, cs, rs, n, window)
    valid = np.arange(C)[None, :] < n[:, None]
    assert got.shape == want.shape == (4, C, 4, KVR) and got.dtype == np.float32
    np.testing.assert_allclose(got[valid], want[valid], **TOL)
    np.testing.assert_allclose(got[valid], pallas[valid], **TOL)


def test_int8_scales_are_per_half():
    """The two halves carry their own absmax scales: scaling k_rope's values
    up changes c_kv's stored bytes not at all, and the decode still matches
    the reference (a single concatenated scale could not)."""
    q, c_kv, k_rope = _inputs(7, 2)
    ckv, kr, cs, rs = _cache("int8", c_kv, k_rope * 50.0)
    ckv0, _, cs0, _ = _cache("int8", c_kv, k_rope)
    np.testing.assert_array_equal(ckv, ckv0)
    np.testing.assert_array_equal(cs, cs0)
    n = np.asarray([2, 2, 2, 0], np.int32)
    got, want, _ = _run(q, ckv, kr, cs, rs, n, 0)
    np.testing.assert_allclose(got[:3], want[:3], **TOL)


def test_plain_version_is_the_dense_softmax():
    """Against a direct numpy evaluation: one row, a full unwrapped ring,
    the last query position sees every slot."""
    q, c_kv, k_rope = _inputs(8, 1, cap=8, B=1, H=2)
    pos = torch.tensor([8], dtype=torch.int32)
    out = tref.mla_ring_decode_ref(torch.from_numpy(q), torch.from_numpy(c_kv),
                                   torch.from_numpy(k_rope), pos, pos,
                                   torch.tensor([1], dtype=torch.int32),
                                   SCALE).numpy()
    keff = np.concatenate([c_kv, k_rope], -1)[0]              # (8, 48)
    s = np.einsum("hd,td->ht", q[0, 0], keff) * SCALE
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(out[0, 0], p @ c_kv[0], rtol=1e-5, atol=1e-6)


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    """A CPU tensor counts no launch; a tensor on another device reaches the
    CUDA wrapper, whose checks raise before any launch."""
    tops.reset_launch_counts()
    q = torch.zeros(1, 1, 2, 576)
    ckv, kr = torch.zeros(1, 32, 512), torch.zeros(1, 32, 64)
    i = torch.ones(1, dtype=torch.int32)
    tops.mla_ring_decode(q, ckv, kr, i, i, i, scale=0.1)
    assert tops.launch_counts()["mla_ring_decode"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tops.mla_ring_decode(q.to("meta"), ckv.to("meta"), kr.to("meta"),
                             i.to("meta"), i.to("meta"), i.to("meta"),
                             scale=0.1)
    # the SMOKE widths 32 + 16 pass the width check and reach the device
    # check; 40 + 16 is outside the range the kernel takes
    with pytest.raises(ValueError, match="CUDA"):
        tops.mla_ring_decode(q[..., :48].to("meta"), ckv[..., :32].to("meta"),
                             kr[..., :16].to("meta"), i, i, i, scale=0.1)
    with pytest.raises(ValueError, match="multiple of 16 up to 512"):
        tops.mla_ring_decode(q[..., :56].to("meta"), ckv[..., :40].to("meta"),
                             kr[..., :16].to("meta"), i, i, i, scale=0.1)
    assert tops.launch_counts()["mla_ring_decode"] == 0


# -- the route-"wgmma" arithmetic, replicated in plain PyTorch ---------------

SPLIT_POS = np.asarray([150, 100, 37, 0], np.int32)     # wrapped, full, partial, empty


@pytest.mark.parametrize("seed,C,window,nsplit,hot", [
    (20, 1, 0, 1, False),
    (21, 1, 0, 3, False),
    (22, 16, 0, 2, False),
    (23, 16, 24, 3, False),
    (24, 1, 0, 4, True),
    (25, 16, 0, 1, True),
])
def test_split_replica_keeps_fp32_results(seed, C, window, nsplit, hot):
    """``mla_split_plain`` — route "wgmma"'s arithmetic: the fp32 queries as
    bf16 hi + lo parts against the bf16 cache, P as a bf16 hi + lo pair,
    tiles of 32 slots split over the cluster and merged — against the reference's fp32 decode and the
    Pallas kernel in interpret mode, within 1e-4 of each output row's max
    |reference|.  A ring of 4 tiles (the last ragged) holds rows wrapped,
    full, partial and empty; ``hot`` scales one batch row's queries by 10."""
    cap = 100
    q, c_kv, k_rope = _inputs(seed, C, cap=cap)
    if hot:
        q[1] *= 10.0
    ckv, kr, _, _ = _cache("bfloat16", c_kv, k_rope)
    pos = SPLIT_POS
    length = np.minimum(pos, cap).astype(np.int32)
    n = np.minimum(pos, C).astype(np.int32)
    t = [tensor_from_numpy(a, "cpu") for a in (q, ckv, kr, pos, length, n)]
    got = tmla.mla_split_plain(*t, SCALE, window, nsplit=nsplit).numpy()
    j = [jnp.asarray(a) for a in (q, ckv, kr, pos, length, n)]
    kw = dict(window=window)
    want = np.asarray(jref.mla_ring_decode_ref(*j[:6], SCALE, **kw))
    pallas = np.asarray(jops.mla_ring_decode(*j[:6], scale=SCALE, bk=8, **kw))
    valid = np.arange(C)[None, :] < n[:, None]
    assert not got[~valid].any()                  # the empty row is zeros
    for ref_out in (want, pallas):
        g, w = got[valid], ref_out[valid]         # (rows, H, kvr)
        rel = np.abs(g - w).max(-1) / np.abs(w).max(-1)
        assert rel.max() <= 1e-4, rel.max()
