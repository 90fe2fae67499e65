"""Port parity for the streamed decode route (``decode_impl="streamed"``).

``ring_flash_decode`` and ``mla_ring_flash_decode`` against the reference's
functions on the same numpy inputs: fp32 and int8 caches, wrapped rings, a
sliding window, a ``cap`` that is not a multiple of the 128-slot block, and
rows with ``n_tokens`` 0; within 1e-5 · max(1, |out|) on the valid query
positions.  Then the streamed engine's greedy tokens against the reference
engine's streamed tokens, on the GQA and the MLA smoke configs with a
registry and a mid-flight ``swap`` (the ``test_torch_serve.py`` pattern).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention_core as JA  # noqa: E402
from repro.serve.kvcache import quant as j_quant  # noqa: E402
from repro_torch.models import attention_core as A  # noqa: E402
from repro_torch.serve.kvcache import quant  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs files on parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring_state(rng, B, C, cap):
    """Per-row ring state AFTER a chunk write: wrapped twice, full, partial,
    a fresh prefill, a row with n_tokens 0 (never written) and ragged n."""
    pos = np.array([2 * cap + 37, cap, 5 + C, C, 0, cap + 3][:B], np.int32)
    length = np.minimum(pos, cap).astype(np.int32)
    n = np.array([C, C, C - 1, C, 0, 1][:B], np.int32)
    return pos, length, n


def _close(got, want, valid):
    """|got - want| <= 1e-5 · max(1, |want|) on the valid query rows."""
    g = np.asarray(got)[valid]
    w = np.asarray(want)[valid]
    assert np.all(np.abs(g - w) <= 1e-5 * np.maximum(1.0, np.abs(w))), \
        float(np.max(np.abs(g - w)))


@pytest.mark.parametrize("cap,C,window,int8", [
    (256, 4, 0, False), (200, 4, 0, False), (200, 3, 37, False),
    (256, 4, 0, True), (130, 2, 0, True), (64, 1, 0, False),
    (300, 5, 100, True)])
def test_ring_flash_decode_matches_reference(cap, C, window, int8):
    rng = np.random.default_rng(cap + C + window)
    B, H, K, hd = 6, 4, 2, 16
    q = rng.normal(size=(B, C, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, cap, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, cap, K, hd)).astype(np.float32)
    pos, length, n = _ring_state(rng, B, C, cap)
    kw, jkw = {}, {}
    if int8:
        kq, ks = quant(torch.from_numpy(k))
        vq, vs = quant(torch.from_numpy(v))
        jk, jks = j_quant(jnp.asarray(k))
        jv, jvs = j_quant(jnp.asarray(v))
        assert np.array_equal(kq.numpy(), np.asarray(jk))
        kt, vt = kq, vq
        jkt, jvt = jk, jv
        kw = dict(k_scale=ks, v_scale=vs)
        jkw = dict(k_scale=jks, v_scale=jvs)
    else:
        kt, vt = torch.from_numpy(k), torch.from_numpy(v)
        jkt, jvt = jnp.asarray(k), jnp.asarray(v)
    got = A.ring_flash_decode(torch.from_numpy(q), kt, vt,
                              torch.from_numpy(pos), torch.from_numpy(length),
                              torch.from_numpy(n), window=window, **kw)
    want = JA.ring_flash_decode(jnp.asarray(q), jkt, jvt, jnp.asarray(pos),
                                jnp.asarray(length), jnp.asarray(n),
                                window=window, **jkw)
    assert got.shape == (B, C, H, hd) and got.dtype == torch.float32
    valid = np.arange(C)[None, :] < n[:, None]
    _close(got.numpy(), jax.device_get(want), valid)


@pytest.mark.parametrize("cap,C,window,int8", [
    (256, 4, 0, False), (200, 3, 50, False), (130, 2, 0, True),
    (256, 1, 0, True)])
def test_mla_ring_flash_decode_matches_reference(cap, C, window, int8):
    rng = np.random.default_rng(7 * cap + C)
    B, H, kvr, rope, nope = 6, 4, 32, 16, 16
    scale = 1.0 / np.sqrt(nope + rope)
    q = rng.normal(size=(B, C, H, kvr + rope)).astype(np.float32)
    ckv = rng.normal(size=(B, cap, kvr)).astype(np.float32)
    kr = rng.normal(size=(B, cap, rope)).astype(np.float32)
    pos, length, n = _ring_state(rng, B, C, cap)
    kw, jkw = {}, {}
    if int8:
        cq, cs = quant(torch.from_numpy(ckv))
        rq, rs = quant(torch.from_numpy(kr))
        jc, jcs = j_quant(jnp.asarray(ckv))
        jr, jrs = j_quant(jnp.asarray(kr))
        ct, rt, jct, jrt = cq, rq, jc, jr
        kw = dict(c_kv_scale=cs, k_rope_scale=rs)
        jkw = dict(c_kv_scale=jcs, k_rope_scale=jrs)
    else:
        ct, rt = torch.from_numpy(ckv), torch.from_numpy(kr)
        jct, jrt = jnp.asarray(ckv), jnp.asarray(kr)
    got = A.mla_ring_flash_decode(
        torch.from_numpy(q), ct, rt, torch.from_numpy(pos),
        torch.from_numpy(length), torch.from_numpy(n), scale=scale,
        window=window, **kw)
    want = JA.mla_ring_flash_decode(
        jnp.asarray(q), jct, jrt, jnp.asarray(pos), jnp.asarray(length),
        jnp.asarray(n), scale=scale, window=window, **jkw)
    assert got.shape == (B, C, H, kvr)
    valid = np.arange(C)[None, :] < n[:, None]
    _close(got.numpy(), jax.device_get(want), valid)


def test_streamed_matches_dense_oracle_and_keeps_scores_small():
    """The streamed route equals the port's dense oracle (the kernel's plain
    version) and its score tensors are block-wide, never cap-wide."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import ref
    rng = np.random.default_rng(3)
    B, C, H, K, hd, cap = 4, 4, 4, 2, 16, 384
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((B, C, H, hd), (B, cap, K, hd), (B, cap, K, hd)))
    pos = torch.tensor([cap + 9, 40, 4, 700], dtype=torch.int32)
    length = pos.clamp(max=cap)
    n = torch.tensor([4, 4, 4, 2], dtype=torch.int32)
    shapes = []

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    shapes.append(tuple(t.shape))
            return out

    with Shapes():
        got = A.ring_flash_decode(q, k, v, pos, length, n)
    want = ref.ring_decode_ref(q, k, v, pos, length, n)
    valid = (torch.arange(C)[None, :] < n[:, None]).numpy()
    _close(got.numpy(), want.numpy(), valid)
    assert not any(cap in s[2:] for s in shapes if len(s) >= 3)


def _np_adapter(template, rank, seed):
    """A numpy adapter tree shaped like ``template`` at ``rank`` (zero-size
    leaves of an empty MoE segment included), non-zero A and B."""
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


def _serve(engine_cls, sp_cls, reg, ads, eng_kw):
    """A wave on adapters a/b and the base id, 3 steps, a swap of b, two
    more requests (new and old version), then run to the end."""
    ids = {n: reg.register(n, ads[n]) for n in ("a", "b")}
    eng = engine_cls(registry=reg, **eng_kw)
    sp = sp_cls(max_tokens=5)
    for p, name in zip([[3, 4, 5, 6, 7, 8, 9], [10, 11], [12, 13, 14, 15, 16],
                        [17], [18, 19, 20, 21, 22]], ["a", "b", None, "a", "b"]):
        eng.submit(p, sp, adapter_id=ids[name] if name else 0)
    out = dict(eng.run_steps(3))
    new = reg.swap("b", ads["b2"])
    eng.submit([9, 8, 7], sp, adapter_id=new)
    eng.submit([5, 4], sp, adapter_id=ids["b"])
    out.update(eng.run())
    return out


@pytest.mark.parametrize("family", ["gqa", "mla"])
def test_streamed_engine_matches_reference_streamed_engine(family):
    """The port's ``decode_impl="streamed"`` engine emits the reference
    engine's streamed greedy tokens (a registry with a swap, a ring of 16
    slots that the prompts and tokens wrap, fp32)."""
    from repro.models import transformer as JT
    from repro.peft.lora import init_lora as j_init_lora
    from repro.serve.adapters import AdapterRegistry as JRegistry
    from repro.serve.engine import SamplingParams as JSP
    from repro.serve.engine import ServeEngine as JEngine
    from repro_torch.convert import adapters_from_numpy, params_from_numpy
    from repro_torch.serve.adapters import AdapterRegistry
    from repro_torch.serve.engine import SamplingParams, ServeEngine

    if family == "gqa":
        from repro.configs.llama3p2_1b import SMOKE as JSMOKE
        from repro_torch.configs.llama3p2_1b import SMOKE
        small = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                     d_ff=128, vocab_size=256)
        jcfg, cfg = JSMOKE.replace(**small), SMOKE.replace(**small)
        targets = ("wq", "wk", "wv", "wo")
    else:
        from repro.configs import get_smoke_config
        from repro.configs import lora_targets as j_lora_targets
        from repro_torch.configs import deepseek_v3_671b
        jcfg = get_smoke_config("deepseek_v3_671b").replace(first_dense_layers=3)
        cfg = deepseek_v3_671b.SMOKE.replace(first_dense_layers=3)
        targets = j_lora_targets(jcfg)
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    template = j_init_lora(jparams, targets, 4, 8.0, jax.random.PRNGKey(1))
    ads = {n: _np_adapter(template, r, s)
           for n, r, s in (("a", 4, 11), ("b", 7, 12), ("b2", 5, 14))}
    reg_kw = dict(page_rank=4, num_pages=12, max_adapters=5, max_rank=8)
    eng_kw = dict(batch_slots=3, capacity=16, prefill_chunk=4,
                  decode_impl="streamed")
    want = _serve(JEngine, JSP, JRegistry(template, **reg_kw), ads,
                  dict(cfg=jcfg, params=jparams, lora_impl="xla", **eng_kw))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    reg = AdapterRegistry(adapters_from_numpy(jax.device_get(template),
                                              device="cpu"), device="cpu", **reg_kw)
    got = _serve(ServeEngine, SamplingParams, reg,
                 {k: adapters_from_numpy(v, device="cpu") for k, v in ads.items()},
                 dict(cfg=cfg, params=params, device="cpu", **eng_kw))
    assert got == want
    assert len(got) == 7 and all(len(t) == 5 for t in got.values())
