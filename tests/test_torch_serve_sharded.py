"""Tensor-parallel serving in the port (``ServeEngine(mesh=...)``) on gloo
worlds of 2 and 4 ranks over a ``file://`` store, against the JAX
mesh-less engine and the port's own.

The reference's ``TINY`` (``tests/test_serve_sharded.py``: 8 heads over 4
KV heads, float32), its params carried in from JAX: the meshed engine's
greedy tokens on routes ``dense``, ``streamed`` and ``kernel`` (the
kernels' plain twins on the CPU) equal the JAX mesh-less engine's.  The
port's mesh-less engine is the yardstick for sampled tokens (the same
seed), multi-tenant mixed ranks with a ``swap``, the int8 cache and a
dense-only MLA smoke model.  Every rank emits the same tokens, each step
makes two ``all_reduce``s a layer, the builds equal the mesh-less
engine's, granite-moe builds under the mesh (its serving is held by
``tests/test_torch_serve_sharded_families.py``) and an indivisible width
raises.  One world of each size (a module fixture) runs every case.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.common.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import SamplingParams as JSP  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch import topology as ttop  # noqa: E402
from repro_torch.common.config import ModelConfig  # noqa: E402

TINY_KW = dict(name="shard-tiny", family="dense", num_layers=2, d_model=64,
               num_heads=8, num_kv_heads=4, head_dim=8, d_ff=128,
               vocab_size=128, dtype="float32")
ROUTES = ("dense", "streamed", "kernel")


def _workload(eng, sp, adapter_ids=None, steps=12, seed=3):
    rng = np.random.default_rng(seed)
    for r in range(4):
        kw = {"adapter_id": adapter_ids[r]} if adapter_ids else {}
        eng.submit(rng.integers(1, eng.cfg.vocab_size, 4).tolist(), sp, **kw)
    return eng.run_steps(steps)


def _cases(np_params, n):
    """Every case on one rank (``n`` None: the port's mesh-less engine in
    this process).  Returns the tokens of each case, the all_reduce counts,
    steps and builds, and the refusals."""
    from repro_torch.configs import granite_moe_1b_a400m, lora_targets
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.serve import CONFIGS, make_adapter
    from repro_torch.models import transformer as T
    from repro_torch.serve.adapters import AdapterRegistry
    from repro_torch.serve.engine import SamplingParams, ServeEngine
    from repro_torch.topology import make_serve_mesh
    torch.set_num_threads(1)
    cfg = ModelConfig(**TINY_KW)
    params = params_from_numpy(np_params, "cpu")
    mesh = (lambda: make_serve_mesh(n, device="cpu")) if n else (lambda: None)
    greedy = SamplingParams(max_tokens=5)
    out = {"tokens": {}, "reduces": {}}

    def engine(c, p, **kw):
        kw = {"batch_slots": 4, "capacity": 32, "prefill_chunk": 4, "seed": 0,
              "device": "cpu", "mesh": mesh(), **kw}
        return ServeEngine(c, p, **kw)

    for impl in ROUTES:
        eng = engine(cfg, params, decode_impl=impl)
        out["tokens"][impl] = _workload(eng, greedy)
        out["reduces"][impl] = ((eng.tp.all_reduces if eng.tp else 0),
                                eng.steps_run)
        out.setdefault("builds", {})[impl] = dict(eng.trace_counts)
    eng = engine(cfg, params, decode_impl="dense")
    out["tokens"]["sampled"] = _workload(
        eng, SamplingParams(temperature=0.8, top_k=20, max_tokens=5))
    eng = engine(cfg, params, decode_impl="streamed", kv_dtype=torch.int8)
    out["tokens"]["int8"] = _workload(eng, greedy)
    # multi-tenant: adapters of ranks 4, 7, 3 and the base id, then a swap
    g = torch.Generator().manual_seed(7)
    targets = lora_targets(cfg)
    reg = AdapterRegistry(make_adapter(params, targets, 4, g, torch.float32),
                          page_rank=4, num_pages=16, max_adapters=8,
                          max_rank=8, device="cpu")
    ids = [0] + [reg.register(f"t{r}", make_adapter(params, targets, r, g,
                                                    torch.float32))
                 for r in (4, 7, 3)]
    eng = engine(cfg, params, decode_impl="kernel", registry=reg)
    toks = _workload(eng, greedy, ids, steps=4)
    new = reg.swap("t7", make_adapter(params, targets, 6, g, torch.float32))
    toks.update(_workload(eng, greedy, [new, new, ids[1], 0], steps=4, seed=4))
    toks.update(eng.run(100))
    reg.evict("t3")
    out["tokens"]["multitenant"] = toks
    out["pages_free"] = reg.num_free_pages
    # DeepSeek-V3's dense MLA layers at smoke widths, with adapters
    mcfg = CONFIGS["deepseek_smoke"][0]
    mp = T.init(mcfg, 0, "cpu")
    mreg = AdapterRegistry(make_adapter(mp, lora_targets(mcfg), 4, g,
                                        torch.float32),
                           page_rank=4, num_pages=16, max_adapters=4,
                           max_rank=8, device="cpu")
    mid = mreg.register("m", make_adapter(mp, lora_targets(mcfg), 8, g,
                                          torch.float32))
    eng = engine(mcfg, mp, decode_impl="kernel", registry=mreg)
    out["tokens"]["mla"] = _workload(eng, greedy, [mid, 0, mid, 0])
    if n and n > 1:
        gcfg = granite_moe_1b_a400m.SMOKE
        try:
            geng = engine(gcfg, T.init(gcfg, 0, "cpu"))
            out["other_family"] = (
                geng.tp.size, geng.dcfg.num_heads,
                tuple(geng.params["blocks"][0]["moe"]["w_up"].shape))
        except ValueError as e:
            out["other_family"] = str(e)
        try:
            engine(cfg.replace(num_heads=6, num_kv_heads=3), T.init(
                cfg.replace(num_heads=6, num_kv_heads=3), 0, "cpu"))
        except ValueError as e:
            out["indivisible"] = str(e)
    return out


@pytest.fixture(scope="module")
def reference():
    """The JAX mesh-less engine's greedy tokens and the port's mesh-less
    cases, on the same params."""
    jcfg = JModelConfig(**TINY_KW)
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    np_params = jax.device_get(jparams)
    eng = JEngine(jcfg, jparams, batch_slots=4, capacity=32, prefill_chunk=4,
                  decode_impl="streamed", seed=0)
    jgreedy = _workload(eng, JSP(max_tokens=5))
    n = torch.get_num_threads()
    port = _cases(np_params, None)
    torch.set_num_threads(n)
    return np_params, jgreedy, port


@pytest.fixture(scope="module", params=[2, 4], ids=["mesh2", "mesh4"])
def world(request, reference):
    n = request.param
    return n, ttop.spawn(_cases, n, "gloo", "cpu", args=(reference[0], n),
                         timeout_s=180)


def test_greedy_routes_match_jax_mesh_less(world, reference):
    n, res = world
    _, jgreedy, port = reference
    assert len(jgreedy) == 4
    for impl in ROUTES:
        assert port["tokens"][impl] == jgreedy, impl
        for r in range(n):
            assert res[r]["tokens"][impl] == jgreedy, (impl, r)


@pytest.mark.parametrize("case", ["sampled", "int8", "multitenant", "mla"])
def test_cases_match_port_mesh_less(world, reference, case):
    n, res = world
    want = reference[2]["tokens"][case]
    assert len(want) == (8 if case == "multitenant" else 4)
    for r in range(n):
        assert res[r]["tokens"][case] == want, (case, r)
    if case == "multitenant":
        assert res[0]["pages_free"] == reference[2]["pages_free"]


def test_every_rank_emits_the_same_tokens(world):
    n, res = world
    assert all(res[r]["tokens"] == res[0]["tokens"] for r in range(n))


def test_two_all_reduces_a_layer_a_step_and_no_extra_builds(world, reference):
    n, res = world
    for impl in ROUTES:
        reduces, steps = res[0]["reduces"][impl]
        assert steps > 0 and reduces == 2 * TINY_KW["num_layers"] * steps
        assert reference[2]["reduces"][impl][0] == 0
        assert res[0]["builds"][impl] == reference[2]["builds"][impl]


def test_other_families_refuse_naming_item_9b(world):
    """Since the second multi-device slice no family refuses: granite-moe
    builds under the mesh (its heads and experts cut to the rank's), and
    a width the axis does not divide still raises."""
    from repro_torch.configs import granite_moe_1b_a400m
    n, res = world
    g = granite_moe_1b_a400m.SMOKE
    if g.num_kv_heads % n:                    # 2 KV heads on 4 ranks
        assert "does not divide" in res[0]["other_family"]
        assert "num_kv_heads" in res[0]["other_family"]
    else:
        assert res[0]["other_family"] == (
            n, g.num_heads // n,
            (g.num_layers, g.num_experts // n, g.d_model, g.moe_d_ff))
    assert "does not divide" in res[0]["indivisible"]
