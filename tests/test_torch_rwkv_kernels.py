"""Port parity for the RWKV6 WKV recurrence: the port's plain version
(``kernels/ref.wkv6_ref``, the loop ``wkv6_scan``) and ``ops.wkv6`` on the
CPU route against the reference's ``ref.wkv6_ref``, ``models.rwkv.
wkv_scan`` and its Pallas ``ops.wkv6`` (interpret mode on the CPU, as
tests/test_kernels.py runs it), on inputs made with numpy.

Tolerance rtol = atol = 1e-5 (the reference's own for its kernel against
its scan): fp32 on both sides, sums taken in another order.  The CUDA
kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against this plain version; ``wkv6.wkv6_chunked_plain`` replays its
chunked arithmetic here, against the same references and against the
recurrence in float64 at weak to strong decays.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import wkv6 as twkv6  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, S, H, hd):
    """r, k, v, u normal; w = -exp(normal), the log-decay (as
    tests/test_kernels.py makes it)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(3))
    w = -np.exp(rng.normal(size=(B, S, H, hd))).astype(np.float32)
    u = rng.normal(size=(H, hd)).astype(np.float32)
    return r, k, v, w, u


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("S,H,hd,chunk", [(64, 2, 16, 32), (128, 4, 32, 64),
                                          (96, 1, 16, 32)])
def test_plain_version_and_cpu_route_match_reference(S, H, hd, chunk):
    args = _inputs(S + H, 2, S, H, hd)
    want = np.asarray(jref.wkv6_ref(*map(jnp.asarray, args)))
    pallas = np.asarray(jops.wkv6(*map(jnp.asarray, args), chunk=chunk))
    np.testing.assert_allclose(pallas, want, **TOL)
    got_ref = tref.wkv6_ref(*_t(*args)).numpy()
    got_ops = tops.wkv6(*_t(*args), chunk=chunk).numpy()
    assert got_ops.dtype == np.float32 and got_ops.shape == (2, S, H, hd)
    np.testing.assert_allclose(got_ref, want, **TOL)
    np.testing.assert_allclose(got_ops, pallas, **TOL)


def test_scan_final_state_matches_reference():
    args = _inputs(7, 2, 40, 2, 16)
    jy, js = jrwkv.wkv_scan(*map(jnp.asarray, args))
    ty, ts = trwkv.wkv_scan(*_t(*args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    assert ts.shape == (2, 2, 16, 16)


def test_chunk_has_no_effect():
    """Chunk 16 against chunk 64: the reference's chunked grid carries its
    state across chunks; the port's result does not depend on the chunk."""
    args = _inputs(3, 1, 64, 2, 16)
    j16 = np.asarray(jops.wkv6(*map(jnp.asarray, args), chunk=16))
    j64 = np.asarray(jops.wkv6(*map(jnp.asarray, args), chunk=64))
    np.testing.assert_allclose(j16, j64, rtol=1e-6, atol=1e-6)
    t16 = tops.wkv6(*_t(*args), chunk=16).numpy()
    t64 = tops.wkv6(*_t(*args), chunk=64).numpy()
    np.testing.assert_array_equal(t16, t64)
    np.testing.assert_allclose(t16, j16, **TOL)


def test_bf16_inputs_match_reference():
    """bf16 r, k, v (the main path's type) are read exactly and computed in
    fp32 on both sides."""
    r, k, v, w, u = _inputs(5, 2, 32, 2, 16)
    rb, kb, vb = (a.astype(ml_dtypes.bfloat16) for a in (r, k, v))
    want = np.asarray(jref.wkv6_ref(*map(jnp.asarray, (rb, kb, vb, w, u))))
    tb = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
          for a in (r, k, v)]
    got = tops.wkv6(*tb, *_t(w, u)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_sequence_not_a_multiple_of_chunk_is_refused_on_both_sides():
    args = _inputs(1, 1, 48, 1, 16)
    with pytest.raises(AssertionError):
        jops.wkv6(*map(jnp.asarray, args), chunk=32)
    with pytest.raises(ValueError, match="multiple"):
        tops.wkv6(*_t(*args), chunk=32)
    # min(chunk, S) = S: a short sequence is one chunk on both sides
    np.testing.assert_allclose(
        tops.wkv6(*_t(*args), chunk=256).numpy(),
        np.asarray(jops.wkv6(*map(jnp.asarray, args), chunk=256)), **TOL)


def test_no_backward_under_grad():
    """Like the reference's kernel, wkv6 has no backward: with grad mode on
    and an input that requires grad it raises; it never falls back."""
    r, k, v, w, u = _t(*_inputs(2, 1, 16, 1, 16))
    tops.reset_launch_counts()
    for i in range(5):
        args = [r, k, v, w, u]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(NotImplementedError, match="no backward"):
            tops.wkv6(*args)
        with torch.no_grad():
            assert tops.wkv6(*args).shape == r.shape
    assert tops.launch_counts()["wkv6"] == 0


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    """A CPU tensor counts no launch; a tensor on another device reaches the
    CUDA wrapper, whose checks raise before any launch."""
    tops.reset_launch_counts()
    r, k, v, w, u = _t(*_inputs(4, 1, 8, 2, 64))
    tops.wkv6(r, k, v, w, u)
    assert tops.launch_counts()["wkv6"] == 0
    meta = [t.to("meta") for t in (r, k, v, w, u)]
    with pytest.raises(ValueError, match="CUDA"):
        tops.wkv6(*meta)
    # hd 32 (the SMOKE config's) reaches the device check; hd 16 is refused
    with pytest.raises(ValueError, match="CUDA"):
        tops.wkv6(*[t[..., :32] for t in meta[:4]], meta[4][:, :32])
    with pytest.raises(ValueError, match=r"head dim 16; the kernel takes \(32, 64\)"):
        tops.wkv6(*[t[..., :16] for t in meta[:4]], meta[4][:, :16])
    assert tops.launch_counts()["wkv6"] == 0


# -- the CUDA kernel's chunked form, replayed in plain PyTorch ----------------

SHAPES = [(64, 16), (200, 32), (257, 64)]      # (S, hd): whole, ragged chunks


@pytest.mark.parametrize("S,hd", SHAPES)
def test_chunked_replica_matches_reference_and_pallas(S, hd):
    """``wkv6.wkv6_chunked_plain`` (the kernel's chunks, running-product
    decays and reference point) against the reference's scan and its Pallas
    kernel in interpret mode, at the file's decays."""
    args = _inputs(S + hd, 2, S, 2, hd)
    want = np.asarray(jref.wkv6_ref(*map(jnp.asarray, args)))
    pallas = np.asarray(jops.wkv6(*map(jnp.asarray, args), chunk=S))
    got = twkv6.wkv6_chunked_plain(*_t(*args)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, S, 2, hd)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def _scan64(r, k, v, w, u):
    """The recurrence in float64 (numpy), token by token."""
    B, S, H, hd = r.shape
    state = np.zeros((B, H, hd, hd))
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(np.einsum("bhk,bhkv->bhv", r[:, t], state + u[None, :, :, None] * kv))
        state = np.exp(w[:, t])[..., None] * state + kv
    return np.stack(ys, axis=1)


@pytest.mark.parametrize("mu", [-3.0, 1.0, 3.0])
@pytest.mark.parametrize("S,hd", SHAPES)
def test_chunked_replica_is_fp32_accurate_at_every_decay(S, hd, mu):
    """w = -exp(N(mu, 1)): at mu = 3 the cumulative log-decays of a chunk
    reach -3000 and a single e^w can underflow.  The running products keep
    the fp32 scan's accuracy (~2e-7 of max |y|); exps of differences of
    cumulative sums lose digits there (up to ~5e-6), so 1e-6 tells them
    apart."""
    rng = np.random.default_rng(int(mu) + 7)
    r, k, v = (rng.normal(size=(2, S, 2, hd)).astype(np.float32) for _ in range(3))
    w = -np.exp(rng.normal(mu, 1.0, size=(2, S, 2, hd))).astype(np.float32)
    u = rng.normal(size=(2, hd)).astype(np.float32)
    want = _scan64(*(a.astype(np.float64) for a in (r, k, v, w, u)))
    got = twkv6.wkv6_chunked_plain(*_t(r, k, v, w, u)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("S,hd", SHAPES)
def test_chunked_replica_finite_at_strong_decay_with_large_inputs(S, hd):
    """mu = 3 with r, k, v ten times larger: every output finite (no e^{-a},
    no quotient of decay products), and within 1e-6 of the float64 scan."""
    rng = np.random.default_rng(S)
    r, k, v = (10 * rng.normal(size=(1, S, 2, hd)).astype(np.float32) for _ in range(3))
    w = -np.exp(rng.normal(3.0, 1.0, size=(1, S, 2, hd))).astype(np.float32)
    u = rng.normal(size=(2, hd)).astype(np.float32)
    got = twkv6.wkv6_chunked_plain(*_t(r, k, v, w, u)).numpy()
    assert np.isfinite(got).all()
    want = _scan64(*(a.astype(np.float64) for a in (r, k, v, w, u)))
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())
