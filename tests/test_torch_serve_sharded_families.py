"""Tensor-parallel serving of every family but dense GQA and dense MLA
(``ServeEngine(mesh=...)`` with MoE expert parallelism, RWKV6, the Mamba2
hybrid and the front ends) on gloo worlds over a ``file://`` store,
against the JAX reference and the port's mesh-less engine.

Layers, at model axes of 2 and 4 (fp32, the rank's shards placed as the
engine places them): the expert-parallel ``moe_fwd(tp=)`` of a chunk the
axis divides against the reference's mesh-less ``moe_fwd`` on each
sequence slice (what ``_moe_fwd_sharded`` computes) at a capacity that
binds, its aux against the slices' mean; the width-1 route against
``moe_fwd`` on every token; RWKV6's ``time_mix`` / ``channel_mix`` and
``mamba2_decode`` one decode step against the reference's, outputs and the
rank's slices of the new states.

Engines on the smoke configs of ``launch.serve.CONFIGS`` (mesh 2): greedy
tokens on routes ``dense``, ``streamed`` and ``kernel`` (the kernels'
plain twins on the CPU) for the attention families and ``dense`` for the
recurrences equal the JAX mesh-less engine's; multi-tenant mixed ranks with
a ``swap`` equal the port's mesh-less engine's; every rank emits the same
tokens; each step makes the ``all_reduce`` and ``all_to_all`` counts its
layers call for; each rank holds the bytes its specs give it.

The params are the port's seeded init carried to numpy; the reference
takes them as they are and the port through ``repro_torch.convert``.  The
ranks' module imports no JAX (the spawned ranks re-import it).
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import topology as ttop  # noqa: E402

KEYS = ("granite_smoke", "deepseek_moe_smoke", "rwkv_smoke", "zamba2_smoke",
        "phi3_vision_smoke", "musicgen_smoke")
RECURRENT = ("rwkv_smoke", "zamba2_smoke")
ROUTES = ("dense", "streamed", "kernel")
LAYER_KEYS = ("granite_smoke", "deepseek_moe_smoke", "rwkv_smoke",
              "zamba2_smoke")


def _cfg(key):
    from repro_torch.launch.serve import CONFIGS
    return CONFIGS[key][0]


def _np_params(key):
    from repro_torch.models import transformer as T
    return ttop.partitioning.tree_map(lambda t: t.numpy(),
                                      T.init(_cfg(key), 0, "cpu"))


def _np_layer(tree, i):
    """Layer ``i`` of a stacked numpy tree."""
    if isinstance(tree, dict):
        return {k: _np_layer(v, i) for k, v in tree.items()}
    return tree[i]


def _moe_segment(cfg):
    """The index in ``params["blocks"]`` of the first MoE segment."""
    from repro_torch.models import transformer as T
    kinds = [k for k, _ in T.layer_plan(cfg) if k != "shared"]
    return next(i for i, k in enumerate(kinds) if k.endswith("moe"))


def _routes(key):
    return ("dense",) if key in RECURRENT else ROUTES


def _workload(eng, sp, adapter_ids=None, steps=40, seed=3):
    rng = np.random.default_rng(seed)
    for r in range(4):
        kw = {"adapter_id": adapter_ids[r]} if adapter_ids else {}
        eng.submit(rng.integers(1, eng.cfg.vocab_size, 6).tolist(), sp, **kw)
    return eng.run_steps(steps)


def _expected_collectives(cfg, width: int, n: int):
    """(all_reduces, all_to_alls) one engine step of ``width`` tokens
    makes: one all_reduce a row-parallel projection (attention's ``wo``, an
    MLP's ``w_down``, DeepSeek-V3's shared expert, RWKV6's ``wo`` and
    ``wcv``, Mamba2's norm and ``out_proj``), a MoE layer's two
    all_to_alls in a chunk the axis divides, else its one all_reduce."""
    from repro_torch.models import transformer as T
    ar = a2a = 0
    for kind, count in T.layer_plan(cfg):
        if kind.endswith("moe"):
            ep = width % n == 0
            ar += count * (1 + (0 if ep else 1) + (1 if cfg.num_shared_experts else 0))
            a2a += count * (2 if ep else 0)
        else:
            ar += 2 * count
    return ar, a2a


def _engine_cases(data, n):
    """Every engine case of one rank (``n`` None: the port's mesh-less
    engine in this process)."""
    from repro_torch.configs import lora_targets
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.serve import make_adapter
    from repro_torch.serve.adapters import AdapterRegistry
    from repro_torch.serve.engine import SamplingParams, ServeEngine
    greedy = SamplingParams(max_tokens=5)
    out = {}
    for key in KEYS:
        cfg = _cfg(key)
        params = params_from_numpy(data[key], "cpu")

        def engine(**kw):
            mesh = ttop.make_serve_mesh(n, device="cpu") if n else None
            return ServeEngine(cfg, params, batch_slots=4, capacity=32,
                               prefill_chunk=4, seed=0, device="cpu",
                               record_steps=True, mesh=mesh, **kw)

        rec = {"tokens": {}, "steps": {}}
        for impl in _routes(key):
            eng = engine(decode_impl=impl)
            rec["tokens"][impl] = _workload(eng, greedy)
            rec["steps"][impl] = [(s["width"], s["all_reduces"], s["all_to_alls"])
                                  for s in eng.step_log()]
        # multi-tenant: adapters of ranks 4, 7, 3 and the base id, a swap
        g = torch.Generator().manual_seed(7)
        targets = lora_targets(cfg)
        reg = AdapterRegistry(make_adapter(params, targets, 4, g, torch.float32),
                              page_rank=4, num_pages=16, max_adapters=8,
                              max_rank=8, device="cpu")
        ids = [0] + [reg.register(f"t{r}", make_adapter(params, targets, r, g,
                                                        torch.float32))
                     for r in (4, 7, 3)]
        eng = engine(decode_impl="kernel", registry=reg)
        toks = _workload(eng, greedy, ids, steps=4)
        new = reg.swap("t7", make_adapter(params, targets, 6, g, torch.float32))
        toks.update(_workload(eng, greedy, [new, new, ids[1], 0], steps=4, seed=4))
        toks.update(eng.run(200))
        rec["tokens"]["multitenant"] = toks
        rec["placement"] = eng.placement
        out[key] = rec
    return out


def _layer_inputs(seed=11):
    """The layer cases' inputs, from a numpy seed: MoE chunks skewed toward
    expert 0 so that capacity binds, decode tokens and random states."""
    rng = np.random.default_rng(seed)
    ins = {}
    for key in ("granite_smoke", "deepseek_moe_smoke"):
        cfg = _cfg(key)
        d = cfg.d_model
        ins[key] = {"chunk": rng.standard_normal((4, 16, d)).astype(np.float32),
                    "decode": rng.standard_normal((8, 1, d)).astype(np.float32)}
    cfg = _cfg("rwkv_smoke")
    H, hd, d = cfg.num_rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
    ins["rwkv_smoke"] = {
        "x": rng.standard_normal((3, 1, d)).astype(np.float32),
        "tm_x": rng.standard_normal((3, d)).astype(np.float32),
        "cm_x": rng.standard_normal((3, d)).astype(np.float32),
        "wkv": (0.3 * rng.standard_normal((3, H, hd, hd))).astype(np.float32)}
    cfg = _cfg("zamba2_smoke")
    cdim = cfg.d_inner + 2 * cfg.ssm_state
    ins["zamba2_smoke"] = {
        "x": rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32),
        "conv": rng.standard_normal((3, cfg.ssm_conv - 1, cdim)).astype(np.float32),
        "ssm": (0.3 * rng.standard_normal(
            (3, cfg.num_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim))
                ).astype(np.float32)}
    return ins


def _moe_layer(key, data):
    """Layer 0 of the first MoE segment, numpy, with a capacity factor
    that binds and the direction that skews tokens toward expert 0."""
    cfg = _cfg(key)
    p = _np_layer(data[key]["blocks"][_moe_segment(cfg)]["moe"], 0)
    r0 = p["router"][:, 0]
    return cfg.replace(moe_capacity_factor=0.5), p, r0 / (r0 @ r0)


def _layer_cases(data, ins, n):
    """Every layer case of one rank of a world of ``n``: its outputs and
    the slices of the states it keeps."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import moe as Moe
    from repro_torch.models import rwkv as Rwkv
    from repro_torch.models import ssm as Ssm
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import placement_specs
    from repro_torch.topology.serve import ModelParallel
    from repro_torch.topology.partitioning import (Segments, gather_leaf,
                                                   shard_leaf)
    mesh = ttop.make_serve_mesh(n, device="cpu")
    tp = ModelParallel(mesh)
    r = mesh.axis_index("model")
    fused = torch.arange(2 * 23, dtype=torch.float32).reshape(2, 23)
    seg = Segments("model", (8, 8, 3, 4), (True, True, False, True))
    piece = shard_leaf(fused, (None, seg), mesh)
    out = {"a2a": mesh.all_to_all(torch.arange(2 * n * 3).reshape(2 * n, 3)
                                  + 100 * r, "model", 0, 1),
           "segments": (piece, gather_leaf(piece, (None, seg), mesh))}

    def placed(key, cache=None):
        cfg = _cfg(key)
        params = params_from_numpy(data[key], "cpu")
        cache = cache or T.init_cache(cfg, 3, 8, device="cpu")
        specs = placement_specs(cfg, mesh, params, cache, {})
        return (ttop.shard(params, specs["params"], mesh),
                ttop.shard(cache, specs["cache"], mesh))

    t = torch.as_tensor
    for key in ("granite_smoke", "deepseek_moe_smoke"):
        params, _ = placed(key)
        p = T._layer(params["blocks"][_moe_segment(_cfg(key))]["moe"], 0)
        cfg, _, skew = _moe_layer(key, data)
        x = t(ins[key]["chunk"]) + 1.5 * t(skew)
        a2a = tp.all_to_alls
        y, aux = Moe.moe_fwd(cfg, p, x, tp=tp)
        a2a = tp.all_to_alls - a2a
        yd, auxd = Moe.moe_fwd(cfg, p, t(ins[key]["decode"]), tp=tp)
        out[key] = {"chunk": y, "aux": aux, "decode": yd, "decode_aux": auxd,
                    "a2a": a2a}
    key = "rwkv_smoke"
    cfg = _cfg(key)
    params, _ = placed(key)
    p = T._layer(params["blocks"][0]["mix"], 0)
    i = ins[key]
    H = cfg.num_rwkv_heads // n
    st = {"tm_x": t(i["tm_x"]), "cm_x": t(i["cm_x"]),
          "wkv": t(i["wkv"])[:, tp.index * H:(tp.index + 1) * H]}
    y, s1 = Rwkv.time_mix(cfg, p, t(i["x"]), state=st, tp=tp)
    y2, s2 = Rwkv.channel_mix(cfg, p, t(i["x"]), state=st, tp=tp)
    out[key] = {"time_mix": y, "wkv": s1["wkv"], "tm_x": s1["tm_x"],
                "channel_mix": y2, "cm_x": s2["cm_x"]}
    key = "zamba2_smoke"
    cfg = _cfg(key)
    i = ins[key]
    cache = T.init_cache(cfg, 3, 8, device="cpu")
    ci = [c for c, (k, _) in enumerate(T.layer_plan(cfg)) if k == "mamba"][0]
    cache[ci]["conv"][0] = t(i["conv"])
    cache[ci]["ssm"][0] = t(i["ssm"])
    params, cache = placed(key, cache)
    p = T._layer(params["blocks"][0]["mixer"], 0)
    reduces = tp.all_reduces
    y, s = Ssm.mamba2_decode(cfg, p, t(i["x"]),
                             {k: v[0] for k, v in cache[ci].items()}, tp=tp)
    out[key] = {"y": y, "conv": s["conv"], "ssm": s["ssm"],
                "reduces": tp.all_reduces - reduces}
    return out


def _rank(ins, n, engines):
    """One rank's cases; it makes the params itself (the same seeded init
    as the parent's), so they do not cross the spawn."""
    torch.set_num_threads(1)
    data = {key: _np_params(key) for key in (KEYS if engines else LAYER_KEYS)}
    out = {"layers": _layer_cases(data, ins, n)}
    if engines:
        out["engines"] = _engine_cases(data, n)
    return out


def _jax_tree(tree):
    import jax.numpy as jnp
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_jax_tree(v) for v in tree)
    return jnp.asarray(tree)


def _jcfg(cfg):
    from repro.common.config import ModelConfig as JModelConfig
    return JModelConfig(**dataclasses.asdict(cfg))


def _reference_layers(data, ins):
    """The reference's mesh-less layers on the same params and inputs (one
    jitted call a shape; the sequence slices ``vmap``-ped)."""
    import jax
    from repro.models import moe as JM
    from repro.models import rwkv as JR
    from repro.models import ssm as JS
    from repro_torch.models import moe as Moe
    out = {}
    for key in ("granite_smoke", "deepseek_moe_smoke"):
        cfg, p, skew = _moe_layer(key, data)
        jcfg, jp = _jcfg(cfg), _jax_tree(p)
        fwd = jax.jit(lambda q, x: JM.moe_fwd(jcfg, q, x))
        x = ins[key]["chunk"] + 1.5 * skew
        res = {}
        for m in (2, 4):
            S = x.shape[1] // m
            xs = np.stack([x[:, r * S:(r + 1) * S] for r in range(m)])
            ys, auxs = jax.vmap(fwd, in_axes=(None, 0))(jp, _jax_tree(xs))
            drops = 0
            for r in range(m):
                tx = torch.as_tensor(xs[r]).reshape(1, -1, cfg.d_model)
                meta = Moe._route_and_dispatch(
                    cfg, torch.as_tensor(p["router"]), tx,
                    Moe._capacity(cfg, tx.shape[1]))[1]
                drops += int((meta[0] == cfg.num_experts).sum())
            res[m] = {"chunk": np.concatenate(list(np.asarray(ys)), axis=1),
                      "aux": float(np.mean(np.asarray(auxs))), "drops": drops}
        y, aux = fwd(jp, _jax_tree(ins[key]["decode"]))
        res["decode"], res["decode_aux"] = np.asarray(y), float(aux)
        out[key] = res
    key = "rwkv_smoke"
    cfg = _jcfg(_cfg(key))
    jp = _jax_tree(_np_layer(data[key]["blocks"][0]["mix"], 0))
    i = ins[key]
    st = {k: _jax_tree(i[k]) for k in ("tm_x", "cm_x", "wkv")}
    (y, s1), (y2, s2) = jax.jit(lambda q, x, s: (
        JR.time_mix(cfg, q, x, state=s), JR.channel_mix(cfg, q, x, state=s)))(
            jp, _jax_tree(i["x"]), st)
    out[key] = {"time_mix": np.asarray(y), "wkv": np.asarray(s1["wkv"]),
                "tm_x": np.asarray(s1["tm_x"]), "channel_mix": np.asarray(y2),
                "cm_x": np.asarray(s2["cm_x"])}
    key = "zamba2_smoke"
    cfg = _jcfg(_cfg(key))
    jp = _jax_tree(_np_layer(data[key]["blocks"][0]["mixer"], 0))
    i = ins[key]
    y, s = jax.jit(lambda q, x, s: JS.mamba2_decode(cfg, q, x, s))(
        jp, _jax_tree(i["x"]), {"conv": _jax_tree(i["conv"]),
                                "ssm": _jax_tree(i["ssm"])})
    out[key] = {"y": np.asarray(y), "conv": np.asarray(s["conv"]),
                "ssm": np.asarray(s["ssm"])}
    return out


def _reference_engines(data):
    """The JAX mesh-less engine's greedy tokens (route ``streamed``)."""
    from repro.serve.engine import SamplingParams as JSP
    from repro.serve.engine import ServeEngine as JEngine
    out = {}
    for key in KEYS:
        eng = JEngine(_jcfg(_cfg(key)), _jax_tree(data[key]), batch_slots=4,
                      capacity=32, prefill_chunk=4, decode_impl="streamed",
                      seed=0)
        out[key] = _workload(eng, JSP(max_tokens=5))
    return out


@pytest.fixture(scope="module")
def runs():
    """The worlds of 2 (layers and engines) and 4 (layers), spawned in the
    background while this process computes the JAX references and the
    port's mesh-less engines on the same params."""
    ins = _layer_inputs()
    with ThreadPoolExecutor(2) as pool:
        worlds = {n: pool.submit(ttop.spawn, _rank, n, "gloo", "cpu",
                                 args=(ins, n, n == 2), timeout_s=180)
                  for n in (2, 4)}
        data = {key: _np_params(key) for key in KEYS}
        out = {"jax": _reference_engines(data),
               "layers": _reference_layers(data, ins),
               "port": _engine_cases(data, None)}
        out.update({n: w.result() for n, w in worlds.items()})
    return out


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol, err


@pytest.mark.parametrize("key", ["granite_smoke", "deepseek_moe_smoke"])
@pytest.mark.parametrize("n", [2, 4])
def test_expert_parallel_chunk_matches_moe_fwd_on_each_slice(runs, key, n):
    res, want = runs[n], runs["layers"][key][n]
    assert want["drops"] > 0                       # the capacity binds
    for r in range(n):
        got = res[r]["layers"][key]
        _close(got["chunk"], want["chunk"], 1e-5)
        assert abs(float(got["aux"]) - want["aux"]) <= 1e-6
        assert got["a2a"] == 2                     # one exchange each way


@pytest.mark.parametrize("key", ["granite_smoke", "deepseek_moe_smoke"])
@pytest.mark.parametrize("n", [2, 4])
def test_width_one_route_matches_moe_fwd_on_all_tokens(runs, key, n):
    res, want = runs[n], runs["layers"][key]
    for r in range(n):
        got = res[r]["layers"][key]
        _close(got["decode"], want["decode"], 1e-5)
        assert abs(float(got["decode_aux"]) - want["decode_aux"]) <= 1e-6


@pytest.mark.parametrize("n", [2, 4])
def test_rwkv_mixes_under_tp_match_reference(runs, n):
    res, want = runs[n], runs["layers"]["rwkv_smoke"]
    H = _cfg("rwkv_smoke").num_rwkv_heads // n
    for r in range(n):
        got = res[r]["layers"]["rwkv_smoke"]
        for k in ("time_mix", "channel_mix", "tm_x", "cm_x"):
            _close(got[k], want[k], 1e-5)
        _close(got["wkv"], want["wkv"][:, r * H:(r + 1) * H], 1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_mamba2_decode_under_tp_matches_reference(runs, n):
    res, want = runs[n], runs["layers"]["zamba2_smoke"]
    cfg = _cfg("zamba2_smoke")
    H, din = cfg.num_ssm_heads // n, cfg.d_inner // n
    for r in range(n):
        got = res[r]["layers"]["zamba2_smoke"]
        _close(got["y"], want["y"], 1e-5)
        _close(got["ssm"], want["ssm"][:, r * H:(r + 1) * H], 1e-5)
        # the conv state: the rank's x channels, then B and C whole
        conv = np.concatenate([want["conv"][..., r * din:(r + 1) * din],
                               want["conv"][..., cfg.d_inner:]], axis=-1)
        _close(got["conv"], conv, 1e-5)
        assert got["reduces"] == 2                 # the norm and out_proj


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_all_to_all_is_tiled_and_segments_round_trip(runs, n):
    """``Mesh.all_to_all(t, split 0, concat 1)``: rank r gets block r of
    every rank's rows, side by side in rank order; a ``Segments`` cut keeps
    the rank's share of each cut segment and the others whole, and
    ``gather_leaf`` puts the fused dim back."""
    fused = np.arange(2 * 23, dtype=np.float32).reshape(2, 23)
    for r in range(n):
        want = np.concatenate([np.arange(2 * n * 3).reshape(2 * n, 3)[2 * r:2 * r + 2]
                               + 100 * s for s in range(n)], axis=1)
        assert np.array_equal(np.asarray(runs[n][r]["layers"]["a2a"]), want)
        piece, whole = runs[n][r]["layers"]["segments"]
        w8, w4 = 8 // n, 4 // n
        cols = (list(range(r * w8, (r + 1) * w8))
                + list(range(8 + r * w8, 8 + (r + 1) * w8)) + [16, 17, 18]
                + list(range(19 + r * w4, 19 + (r + 1) * w4)))
        assert np.array_equal(np.asarray(piece), fused[:, cols])
        assert np.array_equal(np.asarray(whole), fused)


def test_init_keeps_one_ranks_experts_equal_to_the_whole_init():
    from repro_torch.models import transformer as T
    cfg = _cfg("deepseek_moe_smoke")
    whole = T.init(cfg, 0, "cpu")
    part = T.init(cfg, 0, "cpu", experts=(1, 3))
    seg = _moe_segment(cfg)
    for k in ("w_gate", "w_up", "w_down"):
        assert torch.equal(part["blocks"][seg]["moe"][k],
                           whole["blocks"][seg]["moe"][k][:, 1:3])
    assert torch.equal(part["blocks"][seg]["moe"]["shared"]["w_up"],
                       whole["blocks"][seg]["moe"]["shared"]["w_up"])
    assert torch.equal(part["lm_head"], whole["lm_head"])


@pytest.mark.parametrize("key,width,n", [
    ("granite_smoke", "num_experts", 2), ("rwkv_smoke", "RWKV heads", 3),
    ("zamba2_smoke", "SSM heads", 3), ("deepseek_moe_smoke", "num_experts", 2)])
def test_check_tensor_parallel_names_the_width_it_cannot_cut(key, width, n):
    from repro_torch.serve.engine import check_tensor_parallel
    cfg = _cfg(key)
    check_tensor_parallel(cfg, 2)
    if width == "num_experts":                 # 5 experts on 2 ranks
        cfg = cfg.replace(num_experts=5)
    with pytest.raises(ValueError, match=width) as e:
        check_tensor_parallel(cfg, n)
    assert "does not divide" in str(e.value)


@pytest.mark.parametrize("key", KEYS)
def test_greedy_routes_match_jax_mesh_less(runs, key):
    want = runs["jax"][key]
    assert len(want) == 4
    for impl in _routes(key):
        assert runs["port"][key]["tokens"][impl] == want, impl
        for r in range(2):
            assert runs[2][r]["engines"][key]["tokens"][impl] == want, (impl, r)


@pytest.mark.parametrize("key", KEYS)
def test_multitenant_swap_matches_port_mesh_less(runs, key):
    want = runs["port"][key]["tokens"]["multitenant"]
    assert len(want) == 8
    for r in range(2):
        assert runs[2][r]["engines"][key]["tokens"]["multitenant"] == want


@pytest.mark.parametrize("key", KEYS)
def test_collectives_per_step_and_same_tokens_on_every_rank(runs, key):
    cfg = _cfg(key)
    r0, r1 = (runs[2][r]["engines"][key] for r in range(2))
    assert r1["tokens"] == r0["tokens"]
    for impl in _routes(key):
        steps = r0["steps"][impl]
        assert steps and r1["steps"][impl] == steps
        for width, ar, a2a in steps:
            assert (ar, a2a) == _expected_collectives(cfg, width, 2), (impl, width)
        assert all(s[1:] == (0, 0) for s in runs["port"][key]["steps"][impl])
    if cfg.num_experts:                            # both MoE routes ran
        assert {w for w, _, _ in r0["steps"]["dense"]} == {1, 4}


@pytest.mark.parametrize("key", KEYS)
def test_each_rank_holds_its_shards(runs, key):
    for r in range(2):
        placement = runs[2][r]["engines"][key]["placement"]
        for tree, b in placement.items():
            assert b["held"] == b["expected"], tree
        assert placement["adapters"]["held"] > 0
