"""The widths the port's CUDA kernels take, checked without a card.

Every head width of every configuration in ``repro.configs`` and
``repro_torch.configs`` maps to a route of each kernel its family reaches:
``flash_attention`` and ``ring_decode`` at ``head_dim`` (attention
families), ``mla_ring_decode`` at the latent widths (MLA), ``wkv6`` at
``rwkv_head_dim`` (RWKV6).  The pure width functions and the wrappers'
checks (reached with tensors on the meta device, which is not CUDA) take
the stated ranges and refuse what lies outside with a ``ValueError`` that
names the range.  The newly taken head dims 56 and 96 are held to the JAX
reference on the plain route: ``ops.flash_attention`` against the Pallas
kernel in interpret mode (rtol = atol = 1e-5, fp32, sums in another order)
and ``ops.ring_decode`` against ``ring_decode_ref`` and its Pallas kernel
(2e-5, as tests/test_torch_kernels.py).
"""
import importlib
import pkgutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.configs  # noqa: E402
import repro_torch.configs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import lora_matmul as lm  # noqa: E402
from repro_torch.kernels import mla_ring_decode as mla  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ring_decode as rd  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402


def _configs():
    """(package.module.NAME, config) for every ModelConfig the two config
    packages define."""
    out = []
    for pkg in (repro.configs, repro_torch.configs):
        for m in pkgutil.iter_modules(pkg.__path__):
            mod = importlib.import_module(f"{pkg.__name__}.{m.name}")
            for name, v in sorted(vars(mod).items()):
                if type(v).__name__ == "ModelConfig":
                    out.append((f"{pkg.__name__}.{m.name}.{name}", v))
    return out


CONFIGS = _configs()


def test_both_config_packages_are_covered():
    names = [n for n, _ in CONFIGS]
    assert any(n.startswith("repro.configs.phi3_vision_4p2b") for n in names)
    assert any(n.startswith("repro_torch.configs.rwkv6_1p6b") for n in names)
    assert len(names) >= 30


@pytest.mark.parametrize("name,cfg", CONFIGS, ids=[n for n, _ in CONFIGS])
def test_every_config_width_has_a_route(name, cfg):
    """Each kernel a family reaches takes its widths, and the padded tiles'
    shared memory fits the 227 KB a block may use."""
    if cfg.use_mla:
        lat, rope = mla.padded_widths(cfg.kv_lora_rank, cfg.qk_rope_head_dim)
        assert lat >= cfg.kv_lora_rank and rope >= cfg.qk_rope_head_dim
    elif cfg.family == "ssm":
        wk.check_head_dim(cfg.rwkv_head_dim)
    else:
        hd = cfg.head_dim
        assert fa.padded_hd(hd) >= hd
        assert fa.bf16_smem_bytes(hd) <= fa.SMEM_LIMIT
        for kv in (torch.float32, torch.bfloat16, torch.int8):
            for how in ("keys", "rows", "narrow", "tensor"):
                assert rd.smem_bytes(hd, kv, how) <= rd.SMEM_LIMIT


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_attention_head_dims_pad_to_the_next_tile_width(hd):
    w = fa.padded_hd(hd)
    assert w in fa.TILE_WIDTHS and w >= hd
    assert all(t < hd for t in fa.TILE_WIDTHS if t < w)
    # int8 rows of a multiple of 16 bytes take 16-byte copies, others 8
    assert rd.copy_bytes(hd, 1) == (16 if hd % 16 == 0 else 8)
    assert rd.copy_bytes(hd, 2) == rd.copy_bytes(hd, 4) == 16


@pytest.mark.parametrize("hd", [0, 4, 12, 60, 100, 136, 256])
def test_attention_head_dims_outside_the_range_are_refused(hd):
    with pytest.raises(ValueError, match="multiple of 8 from 8 to 128"):
        fa.padded_hd(hd)


def _meta(*shapes, dtype=torch.float32):
    return [torch.zeros(s, dtype=dtype, device="meta") for s in shapes]


@pytest.mark.parametrize("hd,taken", [(56, True), (96, True), (8, True),
                                      (60, False), (144, False)])
def test_attention_wrappers_check_the_range(hd, taken):
    """A width in the range passes the width check and is refused only by
    the device check; one outside is refused naming the range."""
    want = "CUDA" if taken else "multiple of 8 from 8 to 128"
    q, kv = _meta((1, 8, 4, hd), (1, 8, 2, hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=want):
        tops.flash_attention(q, kv, kv)
    i = torch.ones(1, dtype=torch.int32, device="meta")
    qd, cache = _meta((1, 1, 4, hd), (1, 64, 2, hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=want):
        tops.ring_decode(qd, cache, cache, i, i, i)
    assert tops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("kvr,rope,want", [
    (512, 64, (512, 64)), (32, 16, (32, 32)), (32, 48, (64, 64)),
    (16, 16, (32, 32)), (64, 64, (64, 64)), (96, 32, (128, 64)),
    (256, 64, (256, 64)), (400, 16, (512, 64))])
def test_mla_widths_take_the_first_padded_pair_that_holds_them(kvr, rope, want):
    assert mla.padded_widths(kvr, rope) == want
    assert want in mla.PADDED_WIDTHS
    assert sum(want) % 64 == 0      # the key splits over 8 warps in steps of 8


@pytest.mark.parametrize("kvr,rope", [(40, 16), (512, 80), (528, 64),
                                      (32, 8), (0, 16), (512, 0)])
def test_mla_widths_outside_the_range_are_refused(kvr, rope):
    with pytest.raises(ValueError, match="multiple of 16 up to 512"):
        mla.padded_widths(kvr, rope)


@pytest.mark.parametrize("hd,taken", [(32, True), (64, True), (16, False),
                                      (48, False), (128, False)])
def test_wkv6_head_dims(hd, taken):
    if taken:
        wk.check_head_dim(hd)
    else:
        with pytest.raises(ValueError, match=r"the kernel takes \(32, 64\)"):
            wk.check_head_dim(hd)


@pytest.mark.parametrize("r,want", [(1, 16), (16, 16), (17, 32), (32, 32),
                                    (33, 64), (100, 128), (128, 128)])
def test_lora_ranks_pad(r, want):
    assert lm.rank_pad(r) == want


@pytest.mark.parametrize("r", [0, 129, 256])
def test_lora_ranks_outside_the_range_are_refused(r):
    with pytest.raises(ValueError, match=r"not in \[1, 128\]"):
        lm.rank_pad(r)
    x, w, a, b = _meta((4, 16), (16, 8), (max(r, 1), 16), (8, max(r, 1)),
                       dtype=torch.bfloat16)
    if r:
        with pytest.raises(ValueError, match=r"not in \[1, 128\]"):
            lm.lora_matmul_cuda(x, w, a, b)


def _flash_parity(hd, causal, window, S=40, H=4, K=2, seed=0):
    rng = np.random.default_rng(seed + hd)
    q = rng.normal(size=(1, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(1, S, K, hd)).astype(np.float32)
    v = rng.normal(size=(1, S, K, hd)).astype(np.float32)
    want = np.asarray(jops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                           causal=causal, window=window))
    got = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd", [56, 96])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 9), (False, 0)])
def test_flash_attention_new_head_dims_match_reference(hd, causal, window):
    _flash_parity(hd, causal, window)


@pytest.mark.parametrize("hd", [56, 96])
@pytest.mark.parametrize("C,window", [(1, 0), (3, 5), (16, 0)])
def test_ring_decode_new_head_dims_match_reference(hd, C, window):
    """Wrapped, exactly full, partial and never-written rings; a chunk of
    C queries with n_tokens ragged at C 16."""
    rng = np.random.default_rng(hd + C)
    B, H, K, cap = 4, 8, 2, 40
    q = rng.normal(size=(B, C, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, cap, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, cap, K, hd)).astype(np.float32)
    pos = np.asarray([57, 40, 21, 0], np.int32)
    length = np.minimum(pos, cap).astype(np.int32)
    n = np.minimum(pos, [C, max(1, C - 2), C, 0]).astype(np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, pos, length, n)]
    got = tops.ring_decode(*t, window=window).numpy()
    j = [jnp.asarray(a) for a in (q, k, v, pos, length, n)]
    want = np.asarray(jref.ring_decode_ref(*j, window=window))
    pallas = np.asarray(jops.ring_decode(*j, bk=8, window=window))
    valid = np.arange(C)[None, :] < n[:, None]
    np.testing.assert_allclose(got[valid], want[valid], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[valid], pallas[valid], rtol=2e-5, atol=2e-5)
