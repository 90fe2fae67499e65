"""Port parity for multi-tenant MLA serving, and the MLA slice's guards.

The port's ``ServeEngine`` on an ``AdapterRegistry`` over MLA's five LoRA
targets emits the reference engine's greedy tokens (``decode_impl="dense"``,
``lora_impl="xla"``) for a heterogeneous-rank batch with a mid-flight
``swap``, on the reference's DeepSeek-V3 smoke config cut to its three
dense MLA layers, fp32, the reference's parameters carried across.  The
port's ``"kernel"`` route runs the kernels' plain versions on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.configs import lora_targets as j_lora_targets  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.peft.lora import init_lora as j_init_lora  # noqa: E402
from repro.serve.adapters import AdapterRegistry as JRegistry  # noqa: E402
from repro.serve.engine import SamplingParams as JSP  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import deepseek_v3_671b  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.adapters import AdapterRegistry  # noqa: E402
from repro_torch.serve.engine import SamplingParams, ServeEngine  # noqa: E402

JCFG = get_smoke_config("deepseek_v3_671b").replace(first_dense_layers=3)
CFG = deepseek_v3_671b.SMOKE.replace(first_dense_layers=3)
REG = dict(page_rank=4, num_pages=12, max_adapters=5, max_rank=8)
ENGINE = dict(batch_slots=3, capacity=16, prefill_chunk=4)
PROMPTS = [[3, 4, 5, 6, 7, 8, 9], [10, 11], [12, 13, 14, 15, 16], [17],
           [18, 19, 20, 21, 22]]
IDS_AT = ["a", "b", None, "a", "b"]


@pytest.fixture(scope="module")
def model():
    jparams = JT.init(JCFG, jax.random.PRNGKey(0))
    template = j_init_lora(jparams, j_lora_targets(JCFG), 4, 8.0,
                           jax.random.PRNGKey(1))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jparams, jax.device_get(template), params


def _adapter(template, rank, seed):
    """A numpy adapter tree shaped like ``template`` (the empty MoE
    segment's zero-size leaves included) at ``rank``, non-zero A and B."""
    rng = np.random.default_rng(seed)

    def make(node):
        if "A" in node:
            L, _, din = node["A"].shape
            dout = node["B"].shape[1]
            return {"A": (rng.normal(size=(L, rank, din)) * 0.1).astype(np.float32),
                    "B": (rng.normal(size=(L, dout, rank)) * 0.1).astype(np.float32),
                    "scale": np.full((L,), 2.0, np.float32)}
        return {k: make(v) for k, v in node.items()}

    return make(template)


def _ads(template):
    return {"a": _adapter(template, 4, 11), "b": _adapter(template, 7, 12),
            "b2": _adapter(template, 5, 13)}


def _serve(engine_cls, sp_cls, reg, ads, eng_kw):
    """Submit a wave, run 3 steps, swap "b" mid-flight, submit against the
    new and the old id, run to the end.  Returns uid -> tokens."""
    ids = {n: reg.register(n, ads[n]) for n in ("a", "b")}
    eng = engine_cls(registry=reg, **eng_kw)
    sp = sp_cls(max_tokens=5)
    out = {}
    for p, name in zip(PROMPTS, IDS_AT):
        eng.submit(p, sp, adapter_id=ids[name] if name else 0)
    out.update(eng.run_steps(3))
    new = reg.swap("b", ads["b2"])
    eng.submit([9, 8, 7], sp, adapter_id=new)
    eng.submit([5, 4], sp, adapter_id=ids["b"])      # old version still live
    out.update(eng.run())
    return out


@pytest.fixture(scope="module")
def reference_tokens(model):
    jparams, template, _ = model
    return _serve(JEngine, JSP, JRegistry(template, **REG), _ads(template),
                  dict(cfg=JCFG, params=jparams, decode_impl="dense",
                       lora_impl="xla", **ENGINE))


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_engine_greedy_tokens_match_reference(model, reference_tokens, impl):
    _, template, params = model
    ads = {k: adapters_from_numpy(v, device="cpu")
           for k, v in _ads(template).items()}
    reg = AdapterRegistry(adapters_from_numpy(template, device="cpu"),
                          device="cpu", **REG)
    got = _serve(ServeEngine, SamplingParams, reg, ads,
                 dict(cfg=CFG, params=params, decode_impl=impl, device="cpu",
                      **ENGINE))
    assert got == reference_tokens
    assert len(got) == len(PROMPTS) + 2
    assert all(len(t) == 5 for t in got.values())


def test_engine_resets_latent_slot(model):
    _, _, params = model
    eng = ServeEngine(CFG, params, batch_slots=2, capacity=16,
                      prefill_chunk=4, kv_dtype=torch.int8, device="cpu")
    eng.submit([1, 2, 3, 4, 5], SamplingParams(max_tokens=4))
    eng.run_steps(2)
    c = eng.cache[0]
    assert int(c["length"][0, 0]) == 5 and c["c_kv"].dtype == torch.int8
    assert float(c["k_rope_scale"][:, 0].abs().sum()) > 0
    eng.reset_slot(0)
    assert int(c["length"][:, 0].sum()) == 0
    assert not c["c_kv"][:, 0].any() and not c["c_kv_scale"][:, 0].any()


def test_layer_plan_raises_for_moe_layers():
    """The full DeepSeek-V3 config has 58 MoE layers: MoE is not ported, so
    its plan raises; the dense-3 cut serves."""
    with pytest.raises(NotImplementedError, match="MoE"):
        T.layer_plan(deepseek_v3_671b.CONFIG)
    with pytest.raises(NotImplementedError, match="MoE"):
        T.init(deepseek_v3_671b.SMOKE, 0, device="cpu")   # first_dense_layers=1
    assert T.layer_plan(deepseek_v3_671b.DENSE3) == [("mla_dense", 3),
                                                     ("mla_moe", 0)]
    for family in ("ssm", "hybrid", "vlm"):
        with pytest.raises(NotImplementedError, match=family):
            T.layer_plan(CFG.replace(family=family, use_mla=False,
                                     num_experts=0))


def test_forward_raises_on_mla(model):
    _, _, params = model
    with pytest.raises(NotImplementedError, match="mla_fwd"):
        T.forward(CFG, params, {"tokens": torch.zeros(1, 4, dtype=torch.long)})


def test_decode_streamed_raises(model):
    _, _, params = model
    cache = T.init_cache(CFG, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="streamed"):
        T.decode(CFG, params, cache, {"tokens": torch.zeros(1, 1, dtype=torch.long)},
                 decode_impl="streamed")


def test_launcher_serves_deepseek_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import MAX_TOKENS, N_REQUESTS, main
    main(["--config", "deepseek_smoke", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    reqs = [line for line in out if line.startswith("req ")]
    assert len(reqs) == N_REQUESTS
    assert all(f": {MAX_TOKENS} tokens" in line for line in reqs)
    assert "'decode_tok_s'" in out[-1]


def test_launcher_raises_without_cuda(monkeypatch):
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", "deepseek_smoke"])
