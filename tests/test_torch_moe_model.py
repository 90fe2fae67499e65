"""Port parity for the MoE transformer (granite-moe's ``[("moe", 2)]`` and
DeepSeek-V3's ``[("mla_dense", 1), ("mla_moe", 2)]`` SMOKE configs, fp32)
against the JAX reference, the reference's parameters and a classic
adapter tree with non-zero B carried across through ``repro_torch.convert``:
the plan and trees, ``forward`` hidden states and aux (both routes),
chunked ``decode`` logits (dense and kernel routes, a row with n_tokens 0),
token-by-token decode against ``forward``, and a decode step with no host
synchronisation (``loss_fn`` with the aux term and the cohort:
``test_torch_moe_train.py``).  Tolerance 1e-4 of max(1, |y|) (the
reference's own for whole models; sums in other orders), aux 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import lora_targets as j_lora_targets  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.peft.lora import init_lora as j_init_lora  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import moe as Moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

from test_torch_moe import CONFIGS, _close  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test (the suite runs files on parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["granite", "deepseek"])
def model(request):
    """The SMOKE model's reference params and a classic adapter tree with
    non-zero B, and the port's copies."""
    cfg, jcfg = CONFIGS[request.param]
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    jad = j_init_lora(jparams, j_lora_targets(jcfg), 4, 8.0,
                      jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)

    def nonzero_b(path, leaf):
        if getattr(path[-1], "key", None) == "B":
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.05, leaf.dtype)
        return leaf

    jad = jax.tree_util.tree_map_with_path(nonzero_b, jad)
    return (cfg, jcfg, jparams, jad,
            params_from_numpy(jax.device_get(jparams), "cpu"),
            adapters_from_numpy(jax.device_get(jad), "cpu"))


def _flat(tree, path=""):
    """{path: (shape, dtype name)} of a nested dict / tuple tree."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key],
                                                      f"{path}/{key}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _flat(t, f"{path}/{i}").items()}
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def test_plan_and_trees_match_reference(model):
    """Plan and parameter tree (4-D expert stacks, fp32 router, DeepSeek's
    shared expert) as the reference's; ``convert`` carries it as it is."""
    cfg, jcfg, jparams, _, params, _ = model
    assert T.layer_plan(cfg) == JT.layer_plan(jcfg)
    want = _flat(jax.device_get(jparams))
    assert _flat(T.init(cfg, 0, "cpu")) == want == _flat(params)
    moe = params["blocks"][-1]["moe"]
    assert moe["router"].dtype == torch.float32 and moe["w_gate"].dim() == 4
    assert ("shared" in moe) == bool(cfg.num_shared_experts)


@pytest.mark.parametrize("S", [16, 40])
def test_forward_matches_reference(model, S):
    cfg, jcfg, jparams, jad, params, ad = model
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S))
    jh, jaux = JT.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)}, jad)
    h, aux = T.forward(cfg, params, {"tokens": torch.as_tensor(toks)}, ad)
    _close(h, jh, 1e-4)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * max(1.0, abs(float(jaux)))
    h2, aux2 = T.forward(cfg, params, {"tokens": torch.as_tensor(toks)}, ad,
                         use_kernels=True)
    _close(h2, jh, 1e-4)
    assert abs(float(aux2) - float(jaux)) <= 1e-5 * max(1.0, abs(float(jaux)))


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_decode_matches_reference(model, impl):
    """Two chunked decode calls (chunks of 4 and 3, a row with n_tokens 0
    in the second) against the reference's dense decode."""
    cfg, jcfg, jparams, jad, params, ad = model
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 7))
    jcache = JT.init_cache(jcfg, 2, 16, kv_dtype=jnp.float32, prefill_chunk=4)
    cache = T.init_cache(cfg, 2, 16, kv_dtype=torch.float32, prefill_chunk=4,
                         device="cpu")
    for sl, n in ((slice(0, 4), None), (slice(4, 7), np.array([3, 0]))):
        jn = None if n is None else jnp.asarray(n, jnp.int32)
        tn = None if n is None else torch.as_tensor(n, dtype=torch.int32)
        jl, jcache = JT.decode(jcfg, jparams, jcache,
                               {"tokens": jnp.asarray(toks[:, sl])}, jad,
                               n_tokens=jn)
        lg, cache = T.decode(cfg, params, cache,
                             {"tokens": torch.as_tensor(toks[:, sl])}, ad,
                             n_tokens=tn, decode_impl=impl)
        valid = np.ones(jl.shape[:2], bool) if n is None else \
            np.arange(jl.shape[1])[None] < n[:, None]
        _close(lg.detach().numpy()[valid], np.asarray(jl)[valid], 1e-4)


def test_decode_token_by_token_matches_forward(model):
    """With no token dropped (capacity factor 8 in the forward; decode's
    B·1 tokens are under the floor of 8 slots), feeding a prompt one token
    at a time gives the forward's logits at every position."""
    cfg, _, _, _, params, ad = model
    cfg8 = cfg.replace(moe_capacity_factor=8.0)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 10))
    h, _ = T.forward(cfg8, params, {"tokens": torch.as_tensor(toks)}, ad)
    want = T.logits(cfg8, params, h).detach().numpy()
    cache = T.init_cache(cfg, 2, 16, kv_dtype=torch.float32, device="cpu")
    for i in range(10):
        lg, cache = T.decode(cfg, params, cache,
                             {"tokens": torch.as_tensor(toks[:, i:i + 1])}, ad)
        _close(lg[:, 0], want[:, i], 1e-4)


def test_moe_path_makes_no_host_sync(model):
    """The MoE layer inside a decode step makes no host synchronisation
    (no ``item``, ``nonzero``, boolean-mask indexing or ``unique``): the
    serving engine captures it in a CUDA graph."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Syncs(TorchDispatchMode):
        HOST = ("aten._local_scalar_dense", "aten.nonzero", "aten.is_nonzero",
                "aten.masked_select", "aten.equal", "aten.unique",
                "aten.bincount", "aten.repeat_interleave", "aten.item")

        def __init__(self):
            super().__init__()
            self.bad = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if str(func.overloadpacket) in self.HOST:
                self.bad.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    cfg, _, _, _, params, ad = model
    cache = T.init_cache(cfg, 2, 16, kv_dtype=torch.float32, device="cpu")
    toks = torch.ones(2, 4, dtype=torch.long)
    with Syncs() as mode:
        T.decode(cfg, params, cache, {"tokens": toks}, ad,
                 n_tokens=torch.tensor([4, 0], dtype=torch.int32),
                 decode_impl="kernel")
        Moe.moe_fwd(cfg, T._layer(params["blocks"][-1]["moe"], 0),
                    torch.randn(2, 3, cfg.d_model), groups=2)
    assert mode.bad == []
