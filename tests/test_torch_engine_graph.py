"""The engine's invariants that let its steps and bursts run as CUDA graphs,
checked on the CPU (where the same built functions run uncaptured).

* Every slot-state and cache tensor keeps its address across ``run``,
  ``run_steps``, admission, ``reset_slot`` and registry churn: a graph
  replays the addresses it captured.
* The built step and burst functions make no host synchronisation (no
  ``item``, ``nonzero`` or data-dependent shape), on every family and
  decode route, greedy and sampled, MoE routing and dispatch included.
* The capture counter's arithmetic (``ops.launch_delta`` /
  ``ops.add_launches``) as plain functions.
* ``trace_counts`` (builds here, captures on the card) is fixed after the
  first pass and under register / swap / evict.
* The sampling noise (``gumbel_noise``): a function of each row's
  ``(key, draw)`` only (slot placement, batch and solo give the same
  bits), the same bits for the same ``(seed, uid, draw)``, Gumbel(0, 1)
  in distribution, and the draw is not the argmax path.
* The step log keeps one entry per engine step, bursts marked.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import (deepseek_v3_671b, granite_moe_1b_a400m,  # noqa: E402
                                 llama3p2_1b, rwkv6_1p6b)
from repro_torch.configs import lora_targets  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import make_adapter  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.peft.lora import init_lora  # noqa: E402
from repro_torch.serve import engine as E  # noqa: E402
from repro_torch.serve.adapters import AdapterRegistry  # noqa: E402
from repro_torch.serve.engine import SamplingParams, ServeEngine  # noqa: E402

SMALL = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=256)
GQA = llama3p2_1b.SMOKE.replace(**SMALL)
MLA = deepseek_v3_671b.SMOKE.replace(first_dense_layers=3)
RWKV = rwkv6_1p6b.SMOKE
MOE = granite_moe_1b_a400m.SMOKE.replace(**SMALL)
MLA_MOE = deepseek_v3_671b.SMOKE                # 1 dense + 2 MoE MLA layers
SAMPLED = SamplingParams(temperature=0.9, top_k=20, top_p=0.9, max_tokens=6)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs files on parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(cfg, decode_impl="dense", **kw):
    params = T.init(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    targets = lora_targets(cfg)
    reg = AdapterRegistry(init_lora(params, targets, 4, 8.0, gen), page_rank=4,
                          num_pages=16, max_adapters=6, max_rank=8, device="cpu")
    ids = [reg.register(f"r{r}", make_adapter(params, targets, r, gen,
                                              torch.float32)) for r in (4, 8)]
    eng = ServeEngine(cfg, params, registry=reg, batch_slots=3, capacity=16,
                      prefill_chunk=4, decode_impl=decode_impl, device="cpu",
                      **kw)
    return eng, reg, ids, params, gen


def _addresses(eng):
    out = {f"state/{k}": t.data_ptr() for k, t in eng._state.items()}
    for i, seg in enumerate(eng.cache):
        out.update({f"cache{i}/{k}": t.data_ptr() for k, t in seg.items()})
    return out


@pytest.mark.parametrize("cfg", [GQA, MLA, RWKV, MOE, MLA_MOE],
                         ids=["gqa", "mla", "rwkv", "moe", "mla-moe"])
def test_state_and_cache_keep_their_addresses(cfg):
    eng, reg, ids, params, gen = _engine(cfg)
    before = _addresses(eng)
    eng.submit([1, 2, 3, 4, 5], SamplingParams(max_tokens=5), adapter_id=ids[0])
    eng.submit([6, 7], SAMPLED, adapter_id=ids[1])
    eng.run_steps(3)
    eng.reset_slot(0)
    reg.swap("r4", make_adapter(params, lora_targets(cfg), 4, gen, torch.float32))
    eng.submit([8, 9, 10], SamplingParams(max_tokens=4))
    eng.run_steps(9, poll_every=4)
    eng.run(poll_every=2)
    reg.evict("r8")
    eng.submit([3, 3], SamplingParams(max_tokens=3))
    eng.run()
    assert _addresses(eng) == before
    assert eng.registry.device_state["table"].data_ptr() == reg._table.data_ptr()


class _Syncs(TorchDispatchMode):
    """Records the operations that would synchronise the host with the
    device or that a CUDA graph cannot capture: reading a value back, a
    data-dependent shape, and a tensor made from host data (``lift_fresh``,
    ``torch.tensor``'s copy to the card)."""

    HOST = ("aten._local_scalar_dense", "aten.nonzero", "aten.is_nonzero",
            "aten.masked_select", "aten.equal", "aten.unique", "aten.item",
            "aten.lift_fresh")

    def __init__(self):
        super().__init__()
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in self.HOST:
            self.bad.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("cfg,impl", [(GQA, "dense"), (GQA, "streamed"),
                                      (GQA, "kernel"), (MLA, "streamed"),
                                      (MLA, "kernel"), (RWKV, "kernel"),
                                      (MOE, "kernel"), (MLA_MOE, "kernel")],
                         ids=["gqa-dense", "gqa-streamed", "gqa-kernel",
                              "mla-streamed", "mla-kernel", "rwkv",
                              "moe-kernel", "mla-moe-kernel"])
def test_built_functions_make_no_host_sync(cfg, impl):
    eng, _, ids, _, _ = _engine(cfg, impl)
    eng.submit([1, 2, 3, 4, 5], SAMPLED, adapter_id=ids[0])
    eng.submit([6, 7], SamplingParams(max_tokens=6), adapter_id=ids[1])
    eng._admit()
    emitted = torch.zeros(4, dtype=torch.int64)
    args = (eng.params, eng._adapters_arg(), eng.cache, eng._state, emitted)
    fns = [E._build_engine_step(cfg, eng.chunk, s, impl, eng.lora_impl)
           for s in (False, True)]
    fns += [E._build_engine_burst(cfg, 4, s, impl, eng.lora_impl)
            for s in (False, True)]
    with _Syncs() as mode:
        for fn in fns:
            fn(*args)
    assert mode.bad == []
    assert int(eng._state["consumed"].sum()) > 0              # they did run


def test_capture_counter_arithmetic():
    before = {"ring_decode": 3, "bgmv": 10, "wkv6": 0}
    after = {"ring_decode": 19, "bgmv": 74, "wkv6": 0}
    assert ops.launch_delta(before, after) == {"ring_decode": 16, "bgmv": 64}
    assert ops.launch_delta(after, after) == {}
    saved = ops.launch_counts()
    try:
        ops.reset_launch_counts()
        start = ops.launch_counts()
        ops.ring_decode.launches += 16       # a capture's Python calls
        ops.bgmv.launches += 64
        delta = ops.launch_delta(start, ops.launch_counts())
        ops.add_launches(delta, -1)          # the capture launched nothing
        assert ops.launch_counts() == start
        for _ in range(3):                   # three replays
            ops.add_launches(delta)
        assert ops.launch_counts()["ring_decode"] == 48
        assert ops.launch_counts()["bgmv"] == 192
        ops.add_launches(delta, 2)
        assert ops.launch_counts()["bgmv"] == 320
    finally:
        for name, n in saved.items():
            ops.WRAPPERS[name].launches = n


def test_trace_counts_stable_after_warmup_and_under_churn():
    eng, reg, ids, params, gen = _engine(GQA)

    def wave():
        for i, p in enumerate(([1, 2, 3, 4, 5, 6], [7, 8], [9, 10, 11], [4])):
            eng.submit(p, SAMPLED if i == 1 else SamplingParams(max_tokens=5),
                       adapter_id=ids[i % 2])
        return eng.run(poll_every=4)

    wave()
    warm = dict(eng.trace_counts)
    assert warm == {(4, "sampled"): 1, ("burst4", "sampled"): 1,
                    (4, "greedy"): 1, ("burst4", "greedy"): 1}
    targets = lora_targets(GQA)
    ids[0] = reg.swap("r4", make_adapter(params, targets, 8, gen, torch.float32))
    ids.append(reg.register("r2", make_adapter(params, targets, 2, gen,
                                               torch.float32)))
    reg.evict("r8")
    ids[1] = ids[2]
    out = wave()
    assert len(out) == 4 and eng.trace_counts == warm
    assert eng.warmup_steps == 0                     # no capture on the CPU


def test_gumbel_noise_is_a_function_of_key_and_draw():
    keys = torch.tensor([E.request_key(7, u) for u in (1, 2, 3, 4)])
    draws = torch.tensor([0, 5, 2, 9])
    V = 300
    a = E.gumbel_noise(keys, draws, V)
    assert a.shape == (4, V) and a.dtype == torch.float32
    assert torch.isfinite(a).all()
    perm = torch.tensor([2, 0, 3, 1])                 # other slots
    assert torch.equal(E.gumbel_noise(keys[perm], draws[perm], V), a[perm])
    for i in range(4):                               # solo == in the batch
        assert torch.equal(E.gumbel_noise(keys[i:i + 1], draws[i:i + 1], V)[0],
                           a[i])
    assert torch.equal(E.gumbel_noise(keys, draws, V), a)   # same bits again
    assert E.request_key(7, 3) == E.request_key(7, 3) != E.request_key(8, 3)
    assert 0 <= E.request_key(7, 3) < 2 ** 32
    nxt = E.gumbel_noise(keys, draws + 1, V)         # the next draw differs
    assert not torch.equal(nxt, a)
    other = E.gumbel_noise(keys + 1, draws, V)       # so does another key
    assert (other != a).float().mean() > 0.99


def test_mix32_stays_in_32_bits_and_is_exact():
    x = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1, 123456789], dtype=torch.int64)
    h = E.mix32(x)
    assert int(h.min()) >= 0 and int(h.max()) < 2 ** 32

    def ref(v):                                       # Python's exact integers
        v ^= v >> 16
        v = (v * 0x7FEB352D) & 0xFFFFFFFF
        v ^= v >> 15
        v = (v * 0x2C1B3C6D) & 0xFFFFFFFF
        return v ^ (v >> 16)

    assert h.tolist() == [ref(int(v)) for v in x]


def test_gumbel_noise_is_gumbel():
    keys = torch.tensor([E.request_key(0, u) for u in range(8)])
    g = E.gumbel_noise(keys, torch.zeros(8, dtype=torch.int64), 1 << 16).double()
    # Gumbel(0, 1): mean = Euler's gamma, variance = pi^2 / 6
    assert abs(float(g.mean()) - 0.5772156649) < 0.01
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03


def test_sampled_draw_is_not_the_argmax_and_replays():
    cfg = GQA
    params = T.init(cfg, 0, device="cpu")
    toks = {}
    for name, sp, seed in (("greedy", SamplingParams(max_tokens=8), 0),
                           ("sampled", SAMPLED, 0), ("again", SAMPLED, 0),
                           ("reseeded", SAMPLED, 1)):
        eng = ServeEngine(cfg, params, batch_slots=2, capacity=16,
                          prefill_chunk=4, seed=seed, device="cpu")
        u = eng.submit([3, 1, 4, 1, 5], sp)
        toks[name] = eng.run(poll_every=3)[u]
    assert toks["sampled"] == toks["again"]
    assert toks["sampled"] != toks["greedy"]
    assert toks["sampled"] != toks["reseeded"]


def test_step_log_marks_bursts():
    eng, _, _, _, _ = _engine(GQA, record_steps=True)
    for p in ([1, 2, 3, 4, 5, 6, 7], [8, 9], [10]):
        eng.submit(p, SamplingParams(max_tokens=9))
    res = eng.run(poll_every=4)
    log = eng.step_log()
    assert len(log) == eng.steps_run
    assert {s["burst"] for s in log} == {1, 4}
    assert all(s["width"] == 1 for s in log if s["burst"] == 4)
    assert sum(s["emitted"] for s in log) == sum(len(t) for t in res.values())
