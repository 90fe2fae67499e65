"""Port parity for the MoE layer (``repro_torch.models.moe``) against the
JAX reference (the whole MoE transformer: ``test_torch_moe_model.py``; the
cohort: ``test_torch_moe_cohort.py``), on the reference's granite-moe and
DeepSeek-V3 SMOKE configs (fp32; softmax router, and sigmoid with one
shared expert), with the reference's own parameters carried across through
``repro_torch.convert``.

Routing compares exactly: for every token the set of experts it keeps and
the capacity slot of each, at capacity factor 1.25 (inputs skewed toward
one expert so that tokens are dropped) and 8.0 (none dropped).  The inputs'
top-k margin is asserted above fp32 rounding first: how a tie breaks is a
freedom of the two packages, not a fault.  Values compare at 1e-5 of
max(1, |y|) for one layer and its gradients, aux at 1e-6 (the two
packages sum in other orders: the reference scatter-adds a token's k rows
in sorted order, the port sums them over k).  Also the capacity
arithmetic, per-slab routing (``groups``), the combine's fixed order,
``active_param_count`` and the DeepSeek-V3-L4 cut.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import moe as JMoe  # noqa: E402
from repro_torch.configs import (deepseek_v3_671b, get_config,  # noqa: E402
                                 granite_moe_1b_a400m)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import moe as Moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CONFIGS = {"granite": (granite_moe_1b_a400m.SMOKE,
                       get_smoke_config("granite_moe_1b_a400m")),
           "deepseek": (deepseek_v3_671b.SMOKE,
                        get_smoke_config("deepseek_v3_671b"))}
MARGIN = 1e-6   # least top-k margin of the inputs: 30x the scores' fp32 error


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test (the suite runs files on parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _layer(name, factor):
    """One MoE layer of the SMOKE config at capacity ``factor``: the
    reference's params, the port's copy, and skewed inputs (expert 0's
    logit raised for every token, so factor 1.25 drops tokens)."""
    cfg, jcfg = CONFIGS[name]
    cfg = cfg.replace(moe_capacity_factor=factor)
    jcfg = jcfg.replace(moe_capacity_factor=factor)
    jp = JMoe.init_moe(jcfg, jax.random.PRNGKey(3), jnp.float32)
    p = params_from_numpy(jax.device_get(jp), "cpu")
    rng = np.random.default_rng(7)
    r0 = np.asarray(jp["router"])[:, 0]
    x = rng.normal(size=(2, 64, cfg.d_model)) + 1.5 * r0 / (r0 @ r0)
    return cfg, jcfg, jp, p, x.astype(np.float32)


def _kept(st, dst_e, dst_c, keep):
    """{(token, expert, slot)} of the kept dispatch entries."""
    return {(int(t), int(e), int(c)) for t, e, c, k in zip(st, dst_e, dst_c, keep)
            if k}


def _margin(cfg, router, x):
    probs = np.sort(np.asarray(JMoe.router_scores(cfg, router, x)), axis=-1)
    k = cfg.experts_per_token
    return float((probs[:, -k] - probs[:, -k - 1]).min())


@pytest.mark.parametrize("factor", [1.25, 8.0])
@pytest.mark.parametrize("name", ["granite", "deepseek"])
def test_moe_fwd_matches_reference(name, factor):
    cfg, jcfg, jp, p, x = _layer(name, factor)
    xt = x.reshape(-1, cfg.d_model)
    assert _margin(jcfg, jp["router"], xt) > MARGIN
    C = JMoe._capacity(jcfg, xt.shape[0])
    assert Moe._capacity(cfg, xt.shape[0]) == C
    _, (st, dst_e, dst_c, _, keep), jaux = JMoe._route_and_dispatch(
        jcfg, jp["router"], jnp.asarray(xt), C)
    _, (pe, pc, _), aux = Moe._route_and_dispatch(
        cfg, p["router"], _t(xt)[None], C)
    want = _kept(np.asarray(st), np.asarray(dst_e), np.asarray(dst_c),
                 np.asarray(keep))
    got = _kept(torch.arange(pe.shape[1]) // cfg.experts_per_token, pe[0],
                pc[0], pe[0] < cfg.num_experts)
    assert got == want
    dropped = xt.shape[0] * cfg.experts_per_token - len(want)
    assert (dropped > 0) == (factor < 2), dropped
    jout, jaux = JMoe.moe_fwd(jcfg, jp, jnp.asarray(x))
    out, aux = Moe.moe_fwd(cfg, p, _t(x))
    _close(out, jout, 1e-5)
    assert aux.shape == () and abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("T,factor", [(8, 1.25), (100, 1.25), (128, 1.0),
                                      (1000, 1.25), (2048, 8.0), (3, 0.5)])
@pytest.mark.parametrize("name", ["granite_moe_1b_a400m", "deepseek_v3_671b"])
def test_capacity_is_the_reference_arithmetic(name, T, factor):
    from repro.configs import get_config as j_get_config
    for cfg, jcfg in ((get_config(name), j_get_config(name)),
                      CONFIGS[name.split("_")[0]]):
        c = Moe._capacity(cfg.replace(moe_capacity_factor=factor), T)
        assert c == JMoe._capacity(jcfg.replace(moe_capacity_factor=factor), T)
        assert c % 8 == 0 and c >= 8


def test_moe_groups_route_each_slab_alone():
    """``groups`` G routes each of G slabs as ``moe_fwd`` routes it alone
    (the cohort's per-client routing), aux per slab."""
    cfg, _, _, p, x = _layer("deepseek", 1.25)
    out, aux = Moe.moe_fwd(cfg, p, _t(x), groups=2)
    assert aux.shape == (2,)
    for g in range(2):
        o1, a1 = Moe.moe_fwd(cfg, p, _t(x[g:g + 1]))
        _close(out[g:g + 1], o1.numpy(), 1e-6)
        assert abs(float(aux[g]) - float(a1)) <= 1e-7


@pytest.mark.parametrize("name", ["granite", "deepseek"])
def test_moe_gradients_match_reference(name):
    """d/dx of <g, out> + aux through routing weights, experts and (for
    DeepSeek-V3) a LoRA adapter on the shared expert's ``w_up``, whose A and
    B gradients compare too."""
    cfg, jcfg, jp, p, x = _layer(name, 1.25)
    rng = np.random.default_rng(11)
    g = rng.normal(size=x.shape).astype(np.float32)
    jad, ad = None, None
    if cfg.num_shared_experts:
        sff = cfg.moe_d_ff * cfg.num_shared_experts
        a = rng.normal(size=(4, cfg.d_model)).astype(np.float32) * 0.1
        b = rng.normal(size=(sff, 4)).astype(np.float32) * 0.1
        jad = {"shared": {"w_up": {"A": jnp.asarray(a), "B": jnp.asarray(b),
                                   "scale": jnp.float32(2.0)}}}
        ad = {"shared": {"w_up": {"A": _t(a).requires_grad_(True),
                                  "B": _t(b).requires_grad_(True),
                                  "scale": torch.tensor(2.0)}}}

    def jloss(xx, aa):
        out, aux = JMoe.moe_fwd(jcfg, jp, xx, aa)
        return jnp.sum(out * g) + aux

    jgx, jga = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jad)
    xx = _t(x).requires_grad_(True)
    out, aux = Moe.moe_fwd(cfg, p, xx, ad)
    leaves = [xx] + ([ad["shared"]["w_up"]["A"], ad["shared"]["w_up"]["B"]]
                     if ad else [])
    grads = torch.autograd.grad((out * _t(g)).sum() + aux, leaves)
    _close(grads[0], jgx, 1e-5)
    if ad:
        _close(grads[1], jga["shared"]["w_up"]["A"], 1e-5)
        _close(grads[2], jga["shared"]["w_up"]["B"], 1e-5)


def test_active_param_count_matches_reference():
    from repro.configs import get_config as j_get_config
    for name in ("granite_moe_1b_a400m", "deepseek_v3_671b"):
        ours, ref = get_config(name), j_get_config(name)
        assert ours.active_param_count() == ref.active_param_count()
        assert ours.param_count() == ref.param_count()
        assert ours.active_param_count() < ours.param_count()
    for cfg, jcfg in CONFIGS.values():
        assert cfg.active_param_count() == jcfg.active_param_count()
    dense = get_config("llama-3.2-1b")
    assert dense.active_param_count() == dense.param_count()
    l4 = deepseek_v3_671b.L4
    assert T.layer_plan(l4) == [("mla_dense", 3), ("mla_moe", 1)]
    assert abs(l4.param_count() - 14.05e9) < 0.01e9


def test_combine_sums_in_a_fixed_order():
    """Two calls give the same bits, and the combine equals a float64
    scatter-add of the weighted expert rows within fp32 rounding."""
    cfg, _, _, p, x = _layer("granite", 1.25)
    a, _ = Moe.moe_fwd(cfg, p, _t(x))
    b, _ = Moe.moe_fwd(cfg, p, _t(x))
    assert torch.equal(a, b)
    xt = _t(x).reshape(1, -1, cfg.d_model)
    C = Moe._capacity(cfg, xt.shape[1])
    buf, meta, _ = Moe._route_and_dispatch(cfg, p["router"], xt, C)
    E, k = cfg.num_experts, cfg.experts_per_token
    eo = Moe._experts(p, buf[0])
    dst_e, dst_c, w = (m[0] for m in meta)
    rows = eo[dst_e % E, dst_c].double() * w.double()[:, None]
    want = torch.zeros(xt.shape[1], cfg.d_model, dtype=torch.float64)
    want.index_add_(0, torch.arange(dst_e.shape[0]) // k, rows)
    _close(a.reshape(-1, cfg.d_model), want.numpy(), 1e-6)
    assert bool((w[dst_e == E] == 0).all()) and bool((dst_e == E).any())
