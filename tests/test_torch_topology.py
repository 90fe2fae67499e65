"""The port's topology layer (``repro_torch.topology``) against the
reference's (``repro.topology``), and its meshes on gloo worlds.

Rules: every param, cache (training and serving), batch, serve-state,
paged-adapter and fed spec of the port equals the reference's
``PartitionSpec`` (as a tuple) on the same trees, Llama-3.2-1B at full
width (meta tensors) and the MLA, RWKV6 and granite-moe smoke configs,
at serve meshes ``(1, N)`` and fed meshes ``(N, 1)`` for N in 1, 2, 4, 8
(``jax.sharding.AbstractMesh`` on the reference's side), the fall back to
replicated included.  Meshes: one gloo world of 2 and one of 4 over a
``file://`` store (a module fixture each) check coordinates, the
collectives (the packed ``all_gather`` too), and ``shard`` / ``gather``
against slicing the whole; a rank's exception fails ``spawn``;
``run_world`` runs in a rank and joins ``torchrun``'s world, where the
benches' axes refuse; the deprecated shims warn and re-export.
"""
import contextlib
import importlib
import io
import socket
import sys
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro import topology as jtop  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.configs import llama3p2_1b as tllama  # noqa: E402
from repro_torch import topology as ttop  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.peft.lora import init_lora  # noqa: E402
from repro_torch.serve.adapters import AdapterRegistry  # noqa: E402

MESH_SIZES = (1, 2, 4, 8)
# (module, attribute, smoke-config overrides) of each tree
CONFIGS = {"llama": ("llama3p2_1b", "CONFIG", {}),
           "mla_smoke": ("deepseek_v3_671b", "SMOKE", {}),
           "rwkv_smoke": ("rwkv6_1p6b", "SMOKE", {}),
           "granite_smoke": ("granite_moe_1b_a400m", "SMOKE", {})}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    mod, attr, kw = CONFIGS[name]
    jc = getattr(importlib.import_module(f"repro.configs.{mod}"), attr)
    tc = getattr(importlib.import_module(f"repro_torch.configs.{mod}"), attr)
    return jc.replace(**kw), tc.replace(**kw)


def _meta(tree):
    """The reference's abstract tree as meta tensors in the port's
    containers (Llama at full width costs no memory)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_meta(v) for v in tree)
    return torch.empty(tuple(tree.shape), device="meta")


_TREES = {}


def _trees(name):
    """(params, training cache) of one config, the port's own trees for
    the smoke configs."""
    if name not in _TREES:
        jc, tc = _cfgs(name)
        if name == "llama":
            params = _meta(jax.eval_shape(lambda: JT.init(jc, jax.random.PRNGKey(0))))
            cache = _meta(jax.eval_shape(lambda: JT.init_cache(jc, 4, 64)))
        else:
            params = T.init(tc, 0, "cpu")
            cache = T.init_cache(tc, 4, 64, device="cpu")
        _TREES[name] = (params, cache)
    return _TREES[name]


def _flat_ref(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            tuple(s) for path, s in leaves}


def _flat_port(values, specs, path=()):
    """The port's spec tree flattened by walking the value tree beside it."""
    if hasattr(values, "ndim") and hasattr(values, "shape"):
        return {path: specs}
    if isinstance(values, dict):
        out = {}
        for k in values:
            out.update(_flat_port(values[k], specs[k], path + (k,)))
        return out
    if isinstance(values, (tuple, list)):
        out = {}
        for i, v in enumerate(values):
            out.update(_flat_port(v, specs[i], path + (i,)))
        return out
    return {}


def _meshes(n, kind):
    shape = (1, n) if kind == "serve" else (n, 1)
    return (AbstractMesh(shape, ("data", "model")),
            ttop.abstract_mesh({"data": shape[0], "model": shape[1]}))


def _same(ref, got):
    assert set(ref) == set(got)
    bad = {p: (ref[p], got[p]) for p in ref if ref[p] != got[p]}
    assert not bad, f"{len(bad)} specs differ, e.g. {list(bad.items())[:3]}"


@pytest.mark.parametrize("kind", ["serve", "fed"])
@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_param_cache_batch_specs_match_reference(name, n, kind):
    jc, tc = _cfgs(name)
    params, cache = _trees(name)
    jm, tm = _meshes(n, kind)
    _same(_flat_ref(jtop.params_pspecs(jm, jc, params)),
          _flat_port(params, ttop.params_pspecs(tm, tc, params)))
    _same(_flat_ref(jtop.cache_pspecs(jm, jc, cache)),
          _flat_port(cache, ttop.cache_pspecs(tm, tc, cache)))
    _same(_flat_ref(jtop.serve_cache_pspecs(jm, jc, cache)),
          _flat_port(cache, ttop.serve_cache_pspecs(tm, tc, cache)))
    batch = {"tokens": torch.zeros((6, 16)), "loss_mask": torch.zeros((4, 16)),
             "step": torch.zeros(())}
    _same(_flat_ref(jtop.batch_pspecs(jm, jc, batch)),
          _flat_port(batch, ttop.batch_pspecs(tm, tc, batch)))
    rep = ttop.replicated_pspecs(params)
    assert _flat_port(params, rep) == _flat_ref(jtop.replicated_pspecs(params))


def _registry_state(name):
    _, tc = _cfgs(name)
    params, _ = _trees(name)
    if name == "llama":                   # the smoke tree: pools of any width
        params = T.init(tllama.SMOKE, 0, "cpu")
    g = torch.Generator().manual_seed(0)
    tmpl = init_lora(params, tcfgs.lora_targets(tc), 4, 8.0, g)
    reg = AdapterRegistry(tmpl, page_rank=4, num_pages=8, max_adapters=4,
                          max_rank=8, device="cpu")
    return reg.device_state, tmpl


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_serve_bundle_and_adapter_specs_match_reference(name, n):
    jc, tc = _cfgs(name)
    params, cache = _trees(name)
    jm, tm = _meshes(n, "serve")
    state = {"active": torch.zeros(8, dtype=torch.bool),
             "out_buf": torch.zeros((8, 32)), "keys": torch.zeros((8, 2))}
    dstate, classic = _registry_state(name)
    ref = jtop.serve_pspecs(jm, jc, params, cache, state, adapters=dstate,
                            lora_impl="xla")
    got = ttop.serve_pspecs(tm, tc, params, cache, state, adapters=dstate)
    for key, tree in (("params", params), ("cache", cache), ("state", state),
                      ("adapters", dstate)):
        _same(_flat_ref(ref[key]), _flat_port(tree, got[key]))
    _same(_flat_ref(jtop.serve_adapter_pspecs(jm, classic, "xla")),
          _flat_port(classic, ttop.serve_adapter_pspecs(tm, classic)))
    assert ttop.serve_adapter_pspecs(tm, None) is None
    if n > 1 and name == "llama":         # the pools follow the base layout
        pools = _flat_port(dstate, got["adapters"])
        assert pools[("pools", "blocks", 0, "attn", "wq", "B")] == \
            (None, None, "model", None)
        assert pools[("pools", "blocks", 0, "attn", "wo", "A")] == \
            (None, None, None, "model")
        assert pools[("table",)] == (None, None)


@pytest.mark.parametrize("C", [4, 6])
@pytest.mark.parametrize("n", MESH_SIZES)
def test_fed_specs_match_reference(n, C):
    _, tc = _cfgs("llama")
    params = T.init(tllama.SMOKE, 0, "cpu")
    g = torch.Generator().manual_seed(0)
    ad = init_lora(params, ("wq", "wv"), 4, 8.0, g)
    stacked = jax.tree.map(lambda t: torch.zeros((C,) + tuple(t.shape)), ad)
    batch = {"tokens": torch.zeros((C, 2, 4, 16)),
             "loss_mask": torch.zeros((C, 2, 4, 16))}
    jm, tm = _meshes(n, "fed")
    assert tuple(jtop.fed_client_pspecs(jm)) == ttop.fed_client_pspecs(tm)
    _same(_flat_ref(jtop.fed_client_pspecs(jm, stacked)),
          _flat_port(stacked, ttop.fed_client_pspecs(tm, stacked)))
    ref = jtop.fed_pspecs(jm, cohort=stacked, batch=batch)
    got = ttop.fed_pspecs(tm, cohort=stacked, batch=batch)
    assert tuple(ref["params"]) == got["params"] == ()
    _same(_flat_ref(ref["batch"]), _flat_port(batch, got["batch"]))
    jc, _ = _cfgs("llama")
    ref = jtop.fed_pspecs(jm, jc, params)
    got = ttop.fed_pspecs(tm, tllama.SMOKE, params)
    _same(_flat_ref(ref["params"]), _flat_port(params, got["params"]))
    fits = C % n == 0
    leaf = _flat_port(stacked, ttop.fed_client_pspecs(tm, stacked))
    assert all((s[0] == "data") == (fits and n > 0) for s in leaf.values())


def test_fallback_to_replicated_and_axis_helpers():
    """An axis that does not divide a dim drops to ``None``, as in the
    reference; ``axis_size`` / ``data_axes`` read the mesh's shape."""
    for n in (3, 5):
        jm, tm = AbstractMesh((1, n), ("data", "model")), \
            ttop.abstract_mesh({"data": 1, "model": n})
        jc, tc = _cfgs("mla_smoke")
        params, cache = _trees("mla_smoke")
        _same(_flat_ref(jtop.params_pspecs(jm, jc, params)),
              _flat_port(params, ttop.params_pspecs(tm, tc, params)))
        got = _flat_port(params, ttop.params_pspecs(tm, tc, params))
        assert all(s.count("model") == 0 or n == 3 for s in got.values())
    pm = ttop.abstract_mesh({"pod": 2, "data": 4, "model": 2})
    jpm = AbstractMesh((2, 4, 2), ("pod", "data", "model"))
    assert ttop.data_axes(pm) == jtop.data_axes(jpm) == ("pod", "data")
    assert ttop.axis_size(pm, "model") == jtop.axis_size(jpm, "model") == 2
    assert ttop.axis_size(pm, "expert") == 1
    batch = {"x": torch.zeros((8, 3)), "y": torch.zeros((4, 3)),
             "z": torch.zeros((3, 3))}
    _same(_flat_ref(jtop.batch_pspecs(jpm, None, batch)),
          _flat_port(batch, ttop.batch_pspecs(pm, None, batch)))


def test_one_rank_meshes_without_a_process_group():
    """No process group: one-rank meshes whose collectives are identities,
    and the reference's error for more ranks than the world holds."""
    m = ttop.make_serve_mesh(1, device="cpu")
    f = ttop.make_fed_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and f.shape == {"data": 1,
                                                              "model": 1}
    x = torch.arange(6.0).reshape(2, 3)
    assert m.all_reduce(x) is x and f.all_gather(x, "data") is x
    assert ttop.shard(x, ("model", None), m) is x
    with pytest.raises(ValueError, match="requested model=2 but only 1 devices"):
        ttop.make_serve_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="requested data=4 but only 1 devices"):
        ttop.make_fed_mesh(4, device="cpu")
    if not torch.cuda.is_available():        # entry points never fall back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttop.make_serve_mesh(1)


def test_shims_warn_and_reexport():
    for name, attrs in (("repro_torch.launch.mesh",
                         ("make_serve_mesh", "make_host_mesh", "axis_size",
                          "data_axes", "make_production_mesh")),
                        ("repro_torch.launch.sharding",
                         ("params_pspecs", "cache_pspecs", "shard", "gather",
                          "CACHE_LEAF_RANKS", "ZERO3_THRESHOLD",
                          "replicated_pspecs", "batch_pspecs"))):
        sys.modules.pop(name, None)
        with pytest.warns(DeprecationWarning, match=name.replace(".", r"\.")):
            mod = importlib.import_module(name)
        for a in attrs:
            assert getattr(mod, a) is getattr(ttop, a)


# -- gloo worlds ---------------------------------------------------------------

def _world_case(n):
    """Run on every rank of a world of ``n``: the mesh's layout, its
    collectives, ``shard`` / ``gather`` of Llama's smoke params and cache by
    the serve rules, and the fed mesh."""
    from repro_torch import topology as tt
    m = tt.make_serve_mesh(device="cpu")
    f = tt.make_fed_mesh(device="cpu")
    h = tt.make_host_mesh(2, device="cpu") if n % 2 == 0 else None
    r = m.rank
    x = torch.arange(4.0) + 10 * r
    out = {"rank": r, "serve": m.coords, "fed": f.coords, "backend": m.backend,
           "host": (h.shape, h.coords) if h is not None else None,
           "sum": m.all_reduce(x), "gather": m.all_gather(x[None]),
           "gather_last": m.all_gather(x[None], dim=-1),
           "fed_gather": f.all_gather(x[None], "data")}
    if h is not None:
        out["host_model_sum"] = h.all_reduce(x, "model")
        out["host_data_sum"] = h.all_reduce(x, "data")
    cfg = tllama.SMOKE
    params = T.init(cfg, 0, "cpu")
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    cache = tt.partitioning.tree_map(
        lambda t: torch.randn(t.shape, generator=torch.Generator()
                              .manual_seed(5)).to(t.dtype), cache)
    pspec = tt.params_pspecs(m, cfg, params)
    cspec = tt.serve_cache_pspecs(m, cfg, cache)
    sp, sc = tt.shard(params, pspec, m), tt.shard(cache, cspec, m)
    out["wq_local"] = sp["blocks"][0]["attn"]["wq"]
    out["wo_local"] = sp["blocks"][0]["attn"]["wo"]
    out["k_local"] = sc[0]["k"]
    back = tt.gather(sp, pspec, m)
    out["roundtrip"] = all(torch.equal(a, b) for a, b in zip(
        _leaves(back), _leaves(params)))
    out["cache_roundtrip"] = all(torch.equal(a, b) for a, b in zip(
        _leaves(tt.gather(sc, cspec, m)), _leaves(cache)))
    out["params"], out["cache"] = params, cache
    out["packed"] = m.all_gather_packed(
        [torch.full((1, 3), r + 0.5, dtype=torch.bfloat16),
         torch.tensor([[r, 7 * r]]), torch.zeros(1, 2, 2) + r])
    out["run_world"] = tt.run_world(lambda x: (tt.world(), x), n, args=(r,))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        tt.rank0_print("from rank", r)
    out["printed"] = printed.getvalue()
    try:
        tt.make_serve_mesh(n - 1, device="cpu")
    except ValueError as e:
        out["subset_error"] = str(e)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request):
    n = request.param
    return n, ttop.spawn(_world_case, n, "gloo", "cpu", args=(n,),
                         timeout_s=120)


def test_world_layout_and_collectives(world):
    n, res = world
    assert sorted(res) == list(range(n))
    for r, out in res.items():
        assert out["rank"] == r and out["backend"] == "gloo"
        assert out["serve"] == {"data": 0, "model": r}
        assert out["fed"] == {"data": r, "model": 0}
        want = sum(torch.arange(4.0) + 10 * i for i in range(n))
        assert torch.equal(out["sum"], want)
        rows = torch.stack([torch.arange(4.0) + 10 * i for i in range(n)])
        assert torch.equal(out["gather"], rows)
        assert torch.equal(out["fed_gather"], rows)
        assert torch.equal(out["gather_last"], rows.reshape(1, -1))
        shape, coords = out["host"]
        assert shape == {"data": n // 2, "model": 2}
        assert coords == {"data": r // 2, "model": r % 2}
        mates = [i for i in range(n) if i // 2 == r // 2]
        assert torch.equal(out["host_model_sum"],
                           sum(torch.arange(4.0) + 10 * i for i in mates))
        assert n == 2 or "a mesh of 3 ranks in a world of 4" in \
            out["subset_error"]


def test_world_shard_and_gather_match_slices(world):
    n, res = world
    for r, out in res.items():
        assert out["roundtrip"] and out["cache_roundtrip"]
        wq = out["params"]["blocks"][0]["attn"]["wq"]
        wo = out["params"]["blocks"][0]["attn"]["wo"]
        k = out["cache"][0]["k"]
        cw, rw = wq.shape[-1] // n, wo.shape[-2] // n
        assert torch.equal(out["wq_local"], wq[..., r * cw:(r + 1) * cw])
        assert torch.equal(out["wo_local"], wo[..., r * rw:(r + 1) * rw, :])
        if k.shape[3] % n:              # 2 KV heads on 4 ranks: replicated
            assert torch.equal(out["k_local"], k)
        else:
            kw = k.shape[3] // n
            assert torch.equal(out["k_local"], k[:, :, :, r * kw:(r + 1) * kw])


def test_world_packed_gather_run_world_and_rank0_print(world):
    """``all_gather_packed`` returns each tensor whole in its own dtype;
    ``run_world`` inside a rank runs there; only rank 0 prints."""
    n, res = world
    for r, out in res.items():
        a, b, c = out["packed"]
        assert a.dtype == torch.bfloat16 and b.dtype == torch.int64
        assert torch.equal(a, torch.stack([torch.full((3,), i + 0.5)
                                           for i in range(n)]).bfloat16())
        assert b.tolist() == [[i, 7 * i] for i in range(n)]
        assert torch.equal(c, torch.arange(float(n))[:, None, None]
                           .expand(n, 2, 2))
        assert out["run_world"] == {r: ((r, n), r)}
        assert out["printed"] == ("from rank 0\n" if r == 0 else "")


def _double(x):
    return 2 * x


def test_run_world_joins_torchrun_and_benches_refuse(monkeypatch):
    """Under ``torchrun`` (here one rank of its environment, the ``env://``
    rendezvous on localhost) ``run_world`` joins that world and returns
    this rank's result, and refuses a world of another size; the benches'
    axes, which spawn worlds of their own, refuse to run there."""
    from repro_torch.benchmarks import fed_bench, serve_bench
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    assert ttop.under_torchrun()
    with pytest.raises(RuntimeError, match="not under torchrun"):
        fed_bench.scale_axis(torch.device("cpu"), 1, print)
    with pytest.raises(RuntimeError, match="not under torchrun"):
        serve_bench.mesh_axis(None, None, 0, 0, torch.device("cpu"))
    try:
        assert ttop.run_world(_double, 1, "gloo", "cpu", args=(21,),
                              timeout_s=60) == {0: 42}
        assert torch.distributed.is_initialized() and ttop.world() == (0, 1)
        with pytest.raises(ValueError, match="torchrun started 1 ranks, 2"):
            ttop.run_world(_double, 2, "gloo", "cpu", args=(1,))
    finally:
        torch.distributed.destroy_process_group()


def _raise_on_rank(bad):
    from repro_torch.topology import world as w
    rank, _ = w()
    if rank == bad:
        raise RuntimeError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()
    return rank


def test_spawn_propagates_a_rank_failure():
    # the failing rank's error, or its peer's in the barrier it left: either
    # way the call fails and no rank hangs
    with pytest.raises(Exception, match="fails on purpose|Connection"):
        ttop.spawn(_raise_on_rank, 2, "gloo", "cpu", args=(1,), timeout_s=60)
    with pytest.raises(Exception, match="rank 0 fails on purpose|Connection"):
        ttop.spawn(_raise_on_rank, 2, "gloo", "cpu", args=(0,), timeout_s=60)
    with pytest.raises(ValueError, match="unknown backend"):
        ttop.spawn(_raise_on_rank, 2, "mpi", "cpu", args=(9,))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert ttop.spawn(_raise_on_rank, 2, "gloo", "cpu", args=(9,)) == \
            {0: 0, 1: 1}
