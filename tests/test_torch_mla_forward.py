"""Port parity for MLA's full-sequence path (``layers.mla_fwd``,
``attention_core.mla_absorbed``) against the JAX reference, on the
reference's DeepSeek-V3 SMOKE widths (fp32), the reference's parameters and
adapters carried across through ``repro_torch.convert``.

* One layer's ``mla_fwd`` on both routes: the absorbed route at S 16 (the
  ``wkv_b`` adapter folded into the absorbed weight) and the expanded route
  at S 520 (``520 % 512 != 0``), with and without ``use_kernel`` (the
  ``lora_matmul`` plain version on the CPU), and the adapters' gradients.
* ``flash_torch`` at an explicit ``scale`` against ``flash_jax``.
* The ``PagedLoRA`` refusal on the absorbed route.

The SMOKE model's train and prefill steps and the cohort's per-client
``wkv_b`` fold: ``test_torch_mla_train.py``.

Tolerance 1e-4 of max(1, |y|), the reference's own MLA tolerance
(tests/test_decode_kernels.py); the two packages sum in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import attention_core as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import deepseek_v3_671b  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import attention_core as A  # noqa: E402
from repro_torch.models import layers as Lyr  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.peft.lora import PagedLoRA  # noqa: E402
from repro_torch.train import step as Step  # noqa: E402

CFG = deepseek_v3_671b.SMOKE
JCFG = get_smoke_config("deepseek_v3_671b")
TOL = 1e-4
TARGETS = ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test (the suite runs files on parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _layer(seed=0):
    """One MLA layer's reference params, a classic adapter on each of the
    five targets (non-zero A and B), and the port's copies."""
    jp = JL.init_mla(JCFG, jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed)
    ad = {}
    for name in TARGETS:
        din, dout = jp[name].shape
        ad[name] = {"A": (rng.normal(size=(4, din)) * 0.1).astype(np.float32),
                    "B": (rng.normal(size=(dout, 4)) * 0.1).astype(np.float32),
                    "scale": np.float32(2.0)}
    jad = jax.tree.map(jnp.asarray, ad)
    return (jp, jad, params_from_numpy(jax.device_get(jp), "cpu"),
            adapters_from_numpy(ad, "cpu"))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("S", [16, 520], ids=["absorbed", "expanded"])
def test_mla_fwd_matches_reference(S, use_kernel):
    jp, jad, p, ad = _layer()
    x = np.random.default_rng(S).normal(size=(2, S, CFG.d_model)).astype(np.float32)
    want = JL.mla_fwd(JCFG, jp, jnp.asarray(x), jad)
    got = Lyr.mla_fwd(CFG, p, torch.as_tensor(x), ad, use_kernel=use_kernel)
    _close(got, want)
    base = Lyr.mla_fwd(CFG, p, torch.as_tensor(x), None, use_kernel=use_kernel)
    _close(base, JL.mla_fwd(JCFG, jp, jnp.asarray(x)))


@pytest.mark.parametrize("S", [16, 520], ids=["absorbed", "expanded"])
def test_mla_fwd_adapter_gradients_match_reference(S):
    jp, jad, p, ad = _layer(1)
    rng = np.random.default_rng(S + 1)
    x = rng.normal(size=(1, S, CFG.d_model)).astype(np.float32)
    g = rng.normal(size=(1, S, CFG.d_model)).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(JL.mla_fwd(JCFG, jp, jnp.asarray(x), a)
                                    * g))(jad)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(ad)]
    a = Step._unflatten(ad, leaves)
    y = Lyr.mla_fwd(CFG, p, torch.as_tensor(x), a, use_kernel=True)
    grads = torch.autograd.grad((y * torch.as_tensor(g)).sum(), leaves)
    want = jax.tree_util.tree_leaves(jax.device_get(jg))
    assert len(want) == len(grads) == 3 * len(TARGETS)
    for gv, wv in zip(grads, want):
        _close(gv, wv)


@pytest.mark.parametrize("window", [0, 5])
def test_flash_torch_scale_matches_flash_jax(window):
    """MLA's absorbed attention scales by 1/√(nope + rope), not 1/√dq."""
    rng = np.random.default_rng(window)
    q = rng.normal(size=(2, 32, 4, 48)).astype(np.float32)
    k = rng.normal(size=(2, 32, 1, 48)).astype(np.float32)
    v = rng.normal(size=(2, 32, 1, 32)).astype(np.float32)
    want = JA.flash_jax(*map(jnp.asarray, (q, k, v)), causal=True,
                        window=window, scale=0.125, q_chunk=16, kv_chunk=8)
    got = A.flash_torch(*map(torch.as_tensor, (q, k, v)), causal=True,
                        window=window, scale=0.125, q_chunk=16, kv_chunk=8)
    _close(got, want, 1e-5)


def test_paged_adapter_refused_on_the_absorbed_route():
    _, _, p, ad = _layer()
    din, dout = p["wkv_b"].shape
    paged = PagedLoRA(torch.zeros(2, 4, din), torch.zeros(2, dout, 4),
                      torch.ones(2), torch.zeros(2, 2, dtype=torch.int32),
                      torch.zeros(2, dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32), impl="plain")
    with pytest.raises(NotImplementedError, match="decode"):
        Lyr.mla_fwd(CFG, p, torch.zeros(1, 16, CFG.d_model),
                    dict(ad, wkv_b=paged))
