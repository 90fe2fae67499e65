"""Port parity for multi-tenant RWKV6 serving, and the RWKV6 slice's guards.

The port's ``ServeEngine`` on an ``AdapterRegistry`` over RWKV6's five LoRA
targets emits the reference engine's greedy tokens (``decode_impl="dense"``,
``lora_impl="xla"``) for a heterogeneous-rank batch with a mid-flight
``swap``, on the reference's ``rwkv6-smoke`` config (fp32) with the
reference's parameters carried across.  Both engines step the recurrence
one token at a time.  The port's ``"kernel"`` route runs ``bgmv``'s plain
version on the CPU.
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
from repro_torch.common.config import FedConfig, LoRAConfig, OptimConfig  # noqa: E402
from repro_torch.configs import rwkv6_1p6b  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.adapters import AdapterRegistry  # noqa: E402
from repro_torch.serve.engine import SamplingParams, ServeEngine  # noqa: E402

JCFG = get_smoke_config("rwkv6-1.6b")
CFG = rwkv6_1p6b.SMOKE
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
    """A numpy adapter tree shaped like ``template`` at ``rank``, non-zero A
    and B."""
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


def test_engine_steps_one_token_and_resets_state(model):
    """``chunk`` is 1 for the recurrent families whatever ``prefill_chunk``
    says (as in the reference engine); an aborted slot's state is wiped."""
    jparams, _, params = model
    eng = ServeEngine(CFG, params, device="cpu", **ENGINE)
    assert eng.chunk == 1
    assert JEngine(JCFG, jparams, **ENGINE).chunk == 1
    dense = ServeEngine(CFG.replace(family="dense"),
                        T.init(CFG.replace(family="dense"), 0, device="cpu"),
                        device="cpu", **ENGINE)
    assert dense.chunk == 4
    eng.submit([1, 2, 3, 4, 5], SamplingParams(max_tokens=4))
    eng.run_steps(2)
    c = eng.cache[0]
    assert float(c["wkv"][:, 0].abs().sum()) > 0
    eng.reset_slot(0)
    assert all(not v[:, 0].any() for v in c.values())


def test_launcher_serves_rwkv_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import MAX_TOKENS, N_REQUESTS, main
    main(["--config", "rwkv_smoke", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    reqs = [line for line in out if line.startswith("req ")]
    assert len(reqs) == N_REQUESTS
    assert all(f": {MAX_TOKENS} tokens" in line for line in reqs)
    assert "'prefill_steps': 0" in out[-1] and "'step_tok_s'" in out[-1]


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.launch.serve import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: T.init(CFG, 0), lambda: T.init_cache(CFG, 2, 8),
                 lambda: serve("rwkv_smoke")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_federated_trainer_refuses_rwkv():
    """The trainer once refused RWKV6; it no longer does: it builds on the
    CPU and runs one round (the recurrence trains through ``wkv_scan``,
    ``tests/test_torch_rwkv_train.py`` holds it to the reference)."""
    from repro_torch.core.federated import FederatedTrainer
    tr = FederatedTrainer(CFG, FedConfig(num_clients=2, clients_per_round=1,
                                         homogeneous_rank=4),
                          LoRAConfig(rank=4, alpha=8.0,
                                     targets=("wr", "wk", "wv", "wg", "wo")),
                          OptimConfig(), batch_size=2, local_steps=1,
                          seq_len=16, device="cpu")
    rec = tr.run_round(0)
    assert np.isfinite(rec.eval_loss)
    assert 1 <= min(min(r) for r in tr.global_state.ranks.values())


@pytest.mark.parametrize("family", ["hybrid", "vlm", "audio"])
def test_other_families_still_raise(family):
    """The families that raised before the Mamba2-and-hybrid and front-end
    slice of the port now plan as the reference does, at their published
    configs and their SMOKE cuts (the test keeps its name)."""
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config, get_smoke_config as t_smoke
    name = {"hybrid": "zamba2-1.2b", "vlm": "phi-3-vision-4.2b",
            "audio": "musicgen-medium"}[family]
    for ours, ref in ((get_config(name), j_get_config(name)),
                      (t_smoke(name), get_smoke_config(name))):
        assert ours.family == ref.family == family
        assert T.layer_plan(ours) == JT.layer_plan(ref)
