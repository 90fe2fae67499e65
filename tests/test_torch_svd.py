"""Port parity of the server SVD pipeline, ``repro_torch.core.svd`` against
``repro.core.svd``, with inputs drawn from numpy with a seed.

Singular vectors carry a free sign (and eigh a free order of equal
eigenvalues), so factors are compared through their products: ranks
exactly, spectra at 1e-5 relative to the largest singular value, and
``B_g @ A_g`` (and ``U S Vᵀ``) at 1e-5 relative to the largest entry.
fp32 on both sides.  ``gram`` runs the plain Gram product on CPU tensors,
as the reference does off the TPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import svd as jsvd  # noqa: E402
from repro_torch.core import svd as tsvd  # noqa: E402

METHODS = ("svd", "gram")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rel(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _stacks(L=3, m=32, n=24, ranks=(4, 8, 4), seed=0, duplicate=False):
    """Weighted client stacks (L, m, Σr) / (L, Σr, n); ``duplicate`` repeats
    the first client (a rank-deficient stack)."""
    rng = np.random.default_rng(seed)
    Bs = [rng.normal(size=(L, m, r)) * 0.1 for r in ranks]
    As = [rng.normal(size=(L, r, n)) * 0.1 for r in ranks]
    if duplicate:
        Bs.append(Bs[0])
        As.append(As[0])
    w = rng.dirichlet(np.ones(len(Bs)))
    B = np.concatenate(Bs, axis=-1).astype(np.float32)
    A = np.concatenate([wk * a for wk, a in zip(w, As)], axis=-2).astype(np.float32)
    return B, A


def _spectrum(got, want, n):
    """Singular values above the Gram route's resolution limit
    σ_max·√(n·eps) at 1e-5; below it both routes return rounding noise
    (square roots of eigenvalues at the noise floor), held only to the
    limit."""
    got, want = np.asarray(got), np.asarray(want)
    limit = want[..., :1] * np.sqrt(n * np.finfo(np.float32).eps)
    big = want > 2 * limit
    np.testing.assert_allclose(np.where(big, got, 0), np.where(big, want, 0),
                               rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    assert np.all(np.where(big, True, got <= 4 * limit))


def _products(Bg, Ag):
    return np.einsum("lmr,lrn->lmn", np.asarray(Bg), np.asarray(Ag))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("duplicate", [False, True])
@pytest.mark.parametrize("tau", [0.5, 0.9, 0.99, "auto"])
def test_florist_core_batched(method, duplicate, tau):
    B, A = _stacks(duplicate=duplicate)
    jBg, jAg, jsp, jp = jsvd.florist_core_batched(jnp.asarray(B), jnp.asarray(A),
                                                  tau, method)
    Bg, Ag, sp, p = tsvd.florist_core_batched(_t(B), _t(A), tau, method)
    assert p.dtype == torch.int32
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    _rel(sp.numpy(), jsp)
    _rel(_products(Bg, Ag), _products(jBg, jAg))


@pytest.mark.parametrize("method", METHODS)
def test_florist_core_max_rank_and_stacked(method):
    B, A = _stacks(L=1, seed=4)
    jout = jsvd.florist_core_stacked(jnp.asarray(B[0]), jnp.asarray(A[0]), 0.95,
                                     method, max_rank=3)
    out = tsvd.florist_core_stacked(_t(B[0]), _t(A[0]), 0.95, method,
                                    max_rank=3)
    assert out.p == jout.p == 3
    _rel(out.spectrum.numpy(), jout.spectrum)
    _rel((out.B_g @ out.A_g).numpy(), np.asarray(jout.B_g @ jout.A_g))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", [(2, 24, 40), (2, 40, 24)])
def test_florist_core_delta_batched(method, shape):
    rng = np.random.default_rng(shape[1])
    M = (rng.normal(size=shape[:2] + (6,)) @ rng.normal(size=(shape[0], 6, shape[2]))
         ).astype(np.float32)
    j = jsvd.florist_core_delta_batched(jnp.asarray(M), 0.9, method)
    t = tsvd.florist_core_delta_batched(_t(M), 0.9, method)
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    _spectrum(t[2].numpy(), j[2], min(shape[1:]))
    _rel(_products(t[0], t[1]), _products(j[0], j[1]))


@pytest.mark.parametrize("shape", [(40, 12), (12, 40), (3, 30, 30)])
def test_gram_svd_rank_deficient(shape):
    """A rank-5 matrix: the Gram route's near-null columns are zeroed and
    U S Vᵀ still rebuilds x, as in the reference."""
    rng = np.random.default_rng(sum(shape))
    lead, (m, n) = shape[:-2], shape[-2:]
    x = (rng.normal(size=lead + (m, 5)) @ rng.normal(size=lead + (5, n))
         ).astype(np.float32)
    fn = jsvd.gram_svd if not lead else jax.vmap(jsvd.gram_svd)
    ju, js, jvt = fn(jnp.asarray(x))
    u, s, vt = tsvd.gram_svd(_t(x))
    _spectrum(s.numpy(), js, min(m, n))
    rebuilt = (u * s[..., None, :]) @ vt
    _rel(rebuilt.numpy(), np.asarray((ju * js[..., None, :]) @ jvt))
    _rel(rebuilt.numpy(), x, 1e-4)
    # columns past the true rank are exact zeros in both
    np.testing.assert_array_equal(u.numpy()[..., 5:] == 0,
                                  np.asarray(ju)[..., 5:] == 0)


@pytest.mark.parametrize("tau,want", [(0.5, 1), (0.625, 2), (0.75, 3),
                                      (0.7500001, 4), (1.0, 5), (0.0, 1)])
def test_energy_rank_at_boundaries(tau, want):
    """σ = (4, 2, 2, 2, 2): the cumulative energy fractions 0.5, 0.625,
    0.75, 0.875, 1 are exact in fp32, so τ on a boundary picks the smaller
    rank (searchsorted from the left)."""
    s = np.asarray([4, 2, 2, 2, 2], np.float32)
    assert jsvd.energy_rank(jnp.asarray(s), tau) == want
    assert tsvd.energy_rank(_t(s), tau) == want
    batch = np.stack([s, s[::-1].copy()])
    np.testing.assert_array_equal(
        tsvd.energy_rank_traced(_t(batch), tau).numpy(),
        np.asarray(jax.vmap(lambda v: jsvd.energy_rank_traced(v, tau))(
            jnp.asarray(batch))))


@pytest.mark.parametrize("seed", range(3))
def test_knee_rank(seed):
    s = np.sort(np.random.default_rng(seed).exponential(size=16))[::-1]
    s = s.astype(np.float32)
    assert tsvd.knee_rank(_t(s)) == jsvd.knee_rank(jnp.asarray(s))


def test_florist_core_lists_and_error_bounds():
    rng = np.random.default_rng(9)
    Bs = [rng.normal(size=(20, r)).astype(np.float32) for r in (2, 3)]
    As = [rng.normal(size=(r, 16)).astype(np.float32) for r in (2, 3)]
    w = [0.3, 0.7]
    jout = jsvd.florist_core([jnp.asarray(b) for b in Bs],
                             [jnp.asarray(a) for a in As], w, 0.8)
    out = tsvd.florist_core([_t(b) for b in Bs], [_t(a) for a in As], w, 0.8)
    assert out.p == jout.p
    err = tsvd.reconstruction_error([_t(b) for b in Bs], [_t(a) for a in As],
                                    w, out.B_g, out.A_g)
    jerr = jsvd.reconstruction_error([jnp.asarray(b) for b in Bs],
                                     [jnp.asarray(a) for a in As], w,
                                     jout.B_g, jout.A_g)
    assert err == pytest.approx(jerr, rel=1e-4, abs=1e-5)
    bound = tsvd.eckart_young_bound(out.spectrum, out.p)
    assert bound == pytest.approx(jsvd.eckart_young_bound(jout.spectrum, jout.p),
                                  rel=1e-5)
    assert err == pytest.approx(bound, rel=1e-3)
