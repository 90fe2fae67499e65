"""Port parity for multi-tenant serving: the port's ``AdapterRegistry``
mirrors the reference's exactly, and the port's ``ServeEngine`` emits the
reference engine's greedy tokens (``decode_impl="dense"``,
``lora_impl="xla"``) for a heterogeneous-rank batch with a mid-flight
``swap``.  Sampled streams cannot match the reference's ``fold_in``
streams, so sampling is held to the invariances the reference's own tests
check: slot placement and batch ≡ solo."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.llama3p2_1b import SMOKE as JSMOKE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.peft.lora import init_lora as j_init_lora  # noqa: E402
from repro.serve.adapters import AdapterRegistry as JRegistry  # noqa: E402
from repro.serve.engine import SamplingParams as JSP  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs.llama3p2_1b import SMOKE  # noqa: E402
from repro_torch.convert import (adapters_from_numpy, params_from_numpy,  # noqa: E402
                                 registry_state_from_numpy)
from repro_torch.peft.lora import PagedLoRA  # noqa: E402
from repro_torch.serve.adapters import AdapterRegistry, attach  # noqa: E402
from repro_torch.serve.engine import SamplingParams, ServeEngine  # noqa: E402

TARGETS = ("wq", "wk", "wv", "wo")
REG = dict(page_rank=4, num_pages=16, max_adapters=6, max_rank=16)
SMALL = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=256)
JCFG, CFG = JSMOKE.replace(**SMALL), SMOKE.replace(**SMALL)


@pytest.fixture(scope="module")
def model():
    jparams = JT.init(JCFG, jax.random.PRNGKey(0))
    template = j_init_lora(jparams, TARGETS, 4, 8.0, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jparams, template, params


def _adapter(template, rank, seed):
    """A numpy adapter tree shaped like ``template`` at ``rank``, with
    non-zero A and B drawn from a seed."""
    rng = np.random.default_rng(seed)

    def make(node):
        if "A" in node:
            L, _, din = node["A"].shape
            dout = node["B"].shape[1]
            return {"A": (rng.normal(size=(L, rank, din)) * 0.1).astype(np.float32),
                    "B": (rng.normal(size=(L, dout, rank)) * 0.1).astype(np.float32),
                    "scale": np.full((L,), 2.0, np.float32)}
        return {k: make(v) for k, v in node.items()}

    return make(jax.device_get(template))


def _churn(reg, ads):
    """register x3 (ranks 4, 7, 16), swap, evict, register into the gap."""
    ids = [reg.register(n, ads[n]) for n in ("a", "b", "c")]
    ids.append(reg.swap("b", ads["b2"]))
    reg.evict("a")
    ids.append(reg.register("d", ads["d"]))
    return ids


def _ads(template):
    return {"a": _adapter(template, 4, 11), "b": _adapter(template, 7, 12),
            "c": _adapter(template, 16, 13), "b2": _adapter(template, 5, 14),
            "d": _adapter(template, 3, 15)}


def test_registry_mirrors_reference(model):
    _, template, _ = model
    ads = _ads(template)
    jreg = JRegistry(template, **REG)
    reg = AdapterRegistry(adapters_from_numpy(jax.device_get(template),
                                              device="cpu"), device="cpu", **REG)
    assert _churn(jreg, ads) == _churn(
        reg, {k: adapters_from_numpy(v, device="cpu") for k, v in ads.items()})
    for aid in jreg.live_ids:
        assert reg.metadata(aid) == jreg.metadata(aid)
    assert reg.num_free_pages == jreg.num_free_pages
    want = jax.tree_util.tree_leaves(jax.device_get(jreg.device_state))
    got = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            got.append(node.numpy())
    walk(reg.device_state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_registry_state_from_numpy_mirrors(model):
    _, template, _ = model
    jreg = JRegistry(template, **REG)
    _churn(jreg, _ads(template))
    reg = AdapterRegistry(adapters_from_numpy(jax.device_get(template),
                                              device="cpu"), device="cpu", **REG)
    registry_state_from_numpy(reg, jax.device_get(jreg.device_state))
    np.testing.assert_array_equal(reg.device_state["table"].numpy(),
                                  np.asarray(jreg.device_state["table"]))
    a = reg.device_state["pools"]["blocks"][0]["attn"]["wk"]["B"]
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(jreg.device_state["pools"]["blocks"][0]["attn"]
                              ["wk"]["B"]))


def test_attach_shapes(model):
    _, template, _ = model
    reg = AdapterRegistry(adapters_from_numpy(jax.device_get(template),
                                              device="cpu"), device="cpu", **REG)
    reg.register("a", adapters_from_numpy(_adapter(template, 6, 3), device="cpu"))
    ids = torch.tensor([1, 0, 1], dtype=torch.int32)
    tree = attach(reg.device_state, ids)
    leaf = tree["blocks"][0]["attn"]["wq"]
    assert isinstance(leaf, PagedLoRA) and leaf.impl == "kernel"
    L, d = CFG.num_layers, CFG.d_model
    assert leaf.a_pages.shape == (L, REG["num_pages"], 4, d)
    assert leaf.b_pages.shape == (L, REG["num_pages"], d, 4)
    assert leaf.scale.shape == (L, REG["max_adapters"])
    assert leaf.table.shape == (REG["max_adapters"], 4) and leaf.ids.shape == (3,)
    one = leaf.layer(1)
    assert one.a_pages.shape == (REG["num_pages"], 4, d)
    assert one.scale.shape == (REG["max_adapters"],)
    with pytest.raises(ValueError, match="impl"):
        attach(reg.device_state, ids, impl="xla")


def _serve(engine_cls, sp_cls, reg, ads_for, eng_kw, prompts, ids_at):
    """Submit a wave, run 3 steps, swap "b" mid-flight and submit against
    the new id, then run to the end.  Returns uid -> tokens."""
    ids = {n: reg.register(n, ads_for[n]) for n in ("a", "b", "c")}
    eng = engine_cls(registry=reg, **eng_kw)
    sp = sp_cls(max_tokens=6)
    out = {}
    for p, name in zip(prompts, ids_at):
        eng.submit(p, sp, adapter_id=ids[name] if name else 0)
    out.update(eng.run_steps(3))
    new = reg.swap("b", ads_for["b2"])
    eng.submit([9, 8, 7], sp, adapter_id=new)
    eng.submit([5, 4], sp, adapter_id=ids["b"])      # old version still live
    out.update(eng.run())
    return out


PROMPTS = [[3, 4, 5, 6, 7, 8, 9], [10, 11], [12, 13, 14, 15, 16], [17],
           [18, 19, 20, 21, 22, 23, 24, 25, 26], [27, 28, 29]]
IDS_AT = ["a", "b", None, "c", "b", "a"]


@pytest.fixture(scope="module")
def reference_tokens(model):
    jparams, template, _ = model
    ads = _ads(template)
    return _serve(JEngine, JSP, JRegistry(template, **REG), ads,
                  dict(cfg=JCFG, params=jparams, batch_slots=4, capacity=32,
                       prefill_chunk=4, decode_impl="dense", lora_impl="xla"),
                  PROMPTS, IDS_AT)


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_engine_greedy_tokens_match_reference(model, reference_tokens, impl):
    _, template, params = model
    ads = {k: adapters_from_numpy(v, device="cpu")
           for k, v in _ads(template).items()}
    reg = AdapterRegistry(adapters_from_numpy(jax.device_get(template),
                                              device="cpu"), device="cpu", **REG)
    got = _serve(ServeEngine, SamplingParams, reg, ads,
                 dict(cfg=CFG, params=params, batch_slots=4, capacity=32,
                      prefill_chunk=4, decode_impl=impl, device="cpu"),
                 PROMPTS, IDS_AT)
    assert got == reference_tokens
    assert len(got) == len(PROMPTS) + 2


def _sampled(params, prompts_first, batch_slots=4):
    """Serve a sampled request (uid fixed by submission order) among greedy
    fillers; returns the sampled request's tokens."""
    eng = ServeEngine(CFG, params, batch_slots=batch_slots, capacity=32,
                      prefill_chunk=4, device="cpu", seed=7)
    sp = SamplingParams(temperature=0.9, top_k=40, top_p=0.9, max_tokens=8)
    uid = eng.submit([3, 1, 4, 1, 5], sp)
    for p in prompts_first:
        eng.submit(p, SamplingParams(max_tokens=5))
    return eng.run()[uid], eng


def test_sampling_invariant_to_slot_placement(model):
    _, _, params = model
    a, _ = _sampled(params, [[9, 2, 6], [5, 3, 5, 8, 9, 7]])
    b, _ = _sampled(params, [[5, 3, 5, 8, 9, 7], [9, 2, 6], [2, 7]])
    assert a == b and len(a) == 8


def test_sampling_batch_equals_solo(model):
    _, _, params = model
    batched, _ = _sampled(params, [[9, 2, 6], [5, 3, 5, 8, 9, 7], [1, 1]])
    solo, _ = _sampled(params, [], batch_slots=1)
    assert batched == solo
    greedy = ServeEngine(CFG, params, batch_slots=1, capacity=32,
                         prefill_chunk=4, device="cpu")
    u = greedy.submit([3, 1, 4, 1, 5], SamplingParams(max_tokens=8))
    assert greedy.run()[u] != batched      # the draw is not the argmax path


def test_engine_counts_steps_and_resets_slot(model):
    _, _, params = model
    eng = ServeEngine(CFG, params, batch_slots=2, capacity=32,
                      prefill_chunk=4, device="cpu")
    eng.submit([1, 2, 3, 4, 5], SamplingParams(max_tokens=4))
    eng.run_steps(2)
    assert eng.steps_run == 2
    assert int(eng.cache[0]["length"][0, 0]) == 5
    eng.reset_slot(0)
    assert eng.slots[0] is None and not bool(eng._state["active"][0])
    assert int(eng.cache[0]["length"][:, 0].sum()) == 0
    with pytest.raises(ValueError, match="not occupied"):
        eng.reset_slot(0)
    with pytest.raises(RuntimeError, match="record_steps"):
        eng.step_log()


def test_step_log_accounts_for_every_emitted_token(model):
    """The recorded steps' widths follow the engine's schedule and their
    emitted counts add up to the tokens the requests hold, split between
    prefill-width steps (rows finishing a prompt or already decoding) and
    width-1 steps."""
    _, _, params = model
    eng = ServeEngine(CFG, params, batch_slots=3, capacity=32, prefill_chunk=4,
                      device="cpu", record_steps=True)
    for p in PROMPTS:
        eng.submit(p, SamplingParams(max_tokens=5))
    res = eng.run()
    log = eng.step_log()
    assert len(log) == eng.steps_run
    assert {s["width"] for s in log} == {1, 4}
    assert all(s["ms"] >= 0 and 0 <= s["emitted"] <= 3 for s in log)
    assert sum(s["emitted"] for s in log) == sum(len(t) for t in res.values())
    assert sum(s["emitted"] for s in log if s["width"] == 4) > 0


def test_launcher_serves_smoke_config_with_swap():
    from repro_torch.launch.serve import MAX_TOKENS, N_REQUESTS, serve
    out = serve("smoke", device="cpu", log=lambda s: None)
    st, res = out["stats"], out["results"]
    assert len(res) == N_REQUESTS
    assert all(len(t) == MAX_TOKENS for t in res.values())
    old, new = out["swap"]
    assert {0, old, new} <= set(out["served_by"].values())
    assert st["decode_tokens"] + st["prefill_step_tokens"] == st["generated_tokens"]
    assert st["decode_tokens"] <= st["decode_steps"] * 8
    assert st["decode_tok_s"] > 0 and st["prefill_tok_s"] > 0
