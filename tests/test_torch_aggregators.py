"""Port parity of the paper's baseline aggregators and FLoRIST's per-layer
oracle: ``fedit``, ``ffa``, ``flora``, ``flexlora`` and
``florist(pipeline="loop")`` against the reference classes of
``repro.core.aggregators`` on the same client updates.

Updates are drawn with numpy from a seed, homogeneous and heterogeneous in
rank (FedIT and FFA under ``zero_padding``), on layer-stacked leaves and
on an un-stacked 2-D leaf.  Kept ranks, upload and download counts, server
FLOPs and efficiency are compared exactly; spectra at 1e-5 of the largest
singular value and the products B·A (FlexLoRA's per-client products too)
at 1e-5 of max(1, |B·A|), factors never (SVD signs are free).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jaggregation  # noqa: E402
from repro.core import aggregators as jaggs  # noqa: E402
from repro_torch.core import aggregation as taggregation  # noqa: E402
from repro_torch.core import aggregators as taggs  # noqa: E402
from repro_torch.core.aggregators import (adapter_leaf_paths,  # noqa: E402
                                          get_path, leaf_dims)

STACKED = {"wq": (32, 32), "wk": (32, 16)}      # name: (n_in, m_out)
FLAT = (24, 20)                                 # the un-stacked leaf's (n, m)
L = 2
METHODS = ("fedit", "ffa", "flora", "flexlora", "florist")


def _client(rng, r, flat=False, scale=2.0):
    """One client update in the reference layout (numpy leaves)."""
    tree = {"blocks": {0: {"attn": {name: {
        "A": (rng.normal(size=(L, r, n)) * 0.1).astype(np.float32),
        "B": (rng.normal(size=(L, m, r)) * 0.1).astype(np.float32),
        "scale": np.full((L,), scale, np.float32)}
        for name, (n, m) in STACKED.items()}}}}
    if flat:
        n, m = FLAT
        tree["head"] = {"A": (rng.normal(size=(r, n)) * 0.1).astype(np.float32),
                        "B": (rng.normal(size=(m, r)) * 0.1).astype(np.float32),
                        "scale": np.asarray(scale, np.float32)}
    return tree


def _ours(tree):
    """The port's view of an arriving update: A/B as decoded numpy, the
    ``scale`` header as a tensor."""
    if isinstance(tree, dict) and "A" in tree:
        return {"A": tree["A"], "B": tree["B"],
                "scale": torch.from_numpy(np.asarray(tree["scale"]))}
    return {k: _ours(v) for k, v in tree.items()}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _prod(leaf):
    return np.matmul(_np(leaf["B"]).astype(np.float64),
                     _np(leaf["A"]).astype(np.float64))


def _check_tree_products(tree, jtree, paths):
    for path in paths:
        _rel(_prod(get_path(tree, path)), _prod(get_path(jtree, path)))


def _cfg(method, zero_padding, a_init):
    return {"fedit": dict(zero_padding=zero_padding),
            "ffa": dict(zero_padding=zero_padding, A_init=a_init),
            "flora": {}, "flexlora": {},
            "florist": dict(tau=0.9, pipeline="loop")}[method]


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _run_pair(method, ranks, flat, seed=0):
    rng = np.random.default_rng(seed)
    zero_padding = len(set(ranks)) > 1
    clients = [_client(rng, r, flat, scale=8.0 / r) for r in ranks]
    w = rng.dirichlet(np.ones(len(ranks)))
    a_init = _client(rng, max(ranks), flat)
    j = jaggs.make_aggregator(method, **_cfg(
        method, zero_padding, jax.tree.map(jnp.asarray, a_init)))
    t = taggs.make_aggregator(method, **_cfg(method, zero_padding,
                                             _torch_tree(a_init)))
    jres = j.aggregate([jax.tree.map(jnp.asarray, c) for c in clients], w,
                       client_ranks=list(ranks))
    res = t.aggregate([_ours(c) for c in clients], w, client_ranks=list(ranks))
    return j, t, jres, res, clients, a_init


CASES = [(m, ranks, flat) for m in METHODS
         for ranks in ((8, 8, 8), (4, 8, 20, 4)) for flat in (False, True)]


@pytest.mark.parametrize("method,ranks,flat", CASES,
                         ids=[f"{m}-{'het' if len(set(r)) > 1 else 'hom'}-"
                              f"{'flat' if f else 'stacked'}" for m, r, f in CASES])
def test_aggregator_matches_reference(method, ranks, flat):
    j, t, jres, res, clients, _ = _run_pair(method, ranks, flat)
    paths = adapter_leaf_paths(jres.global_adapters)
    assert set(adapter_leaf_paths(res.global_adapters)) == set(paths)
    assert res.method == jres.method == method
    assert res.merge_into_base == jres.merge_into_base == (method == "flora")
    assert res.ranks == {p: [int(v) for v in r] for p, r in jres.ranks.items()}
    assert set(res.spectra) == set(jres.spectra)
    for path, sps in jres.spectra.items():
        assert len(res.spectra[path]) == len(sps)
        for s, js in zip(res.spectra[path], sps):
            _rel(s, js)
    _check_tree_products(res.global_adapters, jres.global_adapters, paths)
    for path in paths:
        np.testing.assert_array_equal(_np(get_path(res.global_adapters, path)["scale"]),
                                      np.ones_like(_np(get_path(jres.global_adapters, path)["scale"])))
    if method == "flexlora":
        assert len(res.per_client) == len(jres.per_client) == len(ranks)
        for tree, jtree, rk in zip(res.per_client, jres.per_client, ranks):
            _check_tree_products(tree, jtree, paths)
            for path in paths:
                assert get_path(tree, path)["A"].shape == get_path(jtree, path)["A"].shape
                assert get_path(tree, path)["A"].shape[-2] == rk
    else:
        assert res.per_client is None and jres.per_client is None
    # the cost model
    dims = leaf_dims(clients[0])
    assert dims == jaggs.leaf_dims(clients[0])
    ranks = list(ranks)
    assert t.round_upload_params == j.round_upload_params
    assert t.upload_params([_ours(c) for c in clients]) == j.upload_params(clients)
    for K in (1, len(ranks)):
        assert t.download_params(res, dims, K, ranks) == \
            j.download_params(jres, dims, K, ranks)
    assert t.server_flops(dims, ranks, res.ranks) == \
        j.server_flops(dims, ranks, jres.ranks)
    assert t.efficiency(res, ranks, dims) == j.efficiency(jres, ranks, dims)
    assert res.total_download_rank() == jres.total_download_rank()
    for attr in ("trains_b_only", "needs_a_init", "download_rank_factor"):
        assert getattr(t, attr) == getattr(j, attr), attr


def test_refusals_match_reference():
    rng = np.random.default_rng(3)
    mixed = [_client(rng, 4), _client(rng, 8)]
    w = [0.5, 0.5]
    for method, cfg in (("fedit", {}), ("ffa", dict(A_init=_client(rng, 8)))):
        for mk, trees in ((jaggs.make_aggregator, [jax.tree.map(jnp.asarray, c) for c in mixed]),
                          (taggs.make_aggregator, [_ours(c) for c in mixed])):
            with pytest.raises(ValueError, match="homogeneous ranks"):
                mk(method, **cfg).aggregate(trees, w)
    same = [_client(rng, 4), _client(rng, 4)]
    with pytest.raises(ValueError, match="needs A_init"):
        jaggs.make_aggregator("ffa").aggregate(
            [jax.tree.map(jnp.asarray, c) for c in same], w)
    with pytest.raises(ValueError, match="needs A_init"):
        taggs.make_aggregator("ffa").aggregate([_ours(c) for c in same], w)
    for mk in (jaggs.make_aggregator, taggs.make_aggregator):
        with pytest.raises(ValueError, match="before any add_client"):
            mk("flora").finalize()


@pytest.mark.parametrize("method", METHODS)
def test_client_init_matches_reference(method):
    """Round 1 (no global state) and a later round, at a client rank below,
    equal to and above the broadcast rank: copies of the init exactly
    (round 1, FLoRA's re-init, FFA's frozen A), averages elementwise, and
    SVD factors (FLoRIST, FlexLoRA) through their products."""
    j, t, jres, res, _, a_init = _run_pair(method, (4, 8, 8), False, seed=5)
    ja = jax.tree.map(jnp.asarray, a_init)
    ta = _torch_tree(a_init)
    for state, jstate in ((None, None), (res, jres)):
        for rank in (4, 8, 12):
            got = t.client_init(state, rank, ta)
            want = j.client_init(jstate, rank, ja)
            for path in adapter_leaf_paths(want):
                g, wv = get_path(got, path), get_path(want, path)
                for k in ("A", "B"):
                    assert _np(g[k]).shape == _np(wv[k]).shape, (path, k)
                if state is None or method == "flora":
                    for k in ("A", "B"):
                        np.testing.assert_array_equal(_np(g[k]), _np(wv[k]))
                elif method == "ffa":
                    np.testing.assert_array_equal(_np(g["A"]), _np(wv["A"]))
                    _rel(_np(g["B"]), _np(wv["B"]))
                elif method == "fedit":
                    for k in ("A", "B"):
                        _rel(_np(g[k]), _np(wv[k]))
                else:
                    _rel(_prod(g), _prod(wv))


@pytest.mark.parametrize("method", METHODS)
def test_aggregate_shim_matches_reference(method):
    rng = np.random.default_rng(9)
    ranks = (4, 8, 4)
    clients = [_client(rng, r, flat=True) for r in ranks]
    w = rng.dirichlet(np.ones(3))
    a_init = _client(rng, 8, flat=True)
    kw = dict(tau=0.8, zero_padding=True, client_ranks=list(ranks))
    jres = jaggregation.aggregate(method, [jax.tree.map(jnp.asarray, c) for c in clients],
                                  w, A_init=jax.tree.map(jnp.asarray, a_init), **kw)
    res = taggregation.aggregate(method, [_ours(c) for c in clients], w,
                                 A_init=_torch_tree(a_init), **kw)
    assert res.ranks == {p: [int(v) for v in r] for p, r in jres.ranks.items()}
    _check_tree_products(res.global_adapters, jres.global_adapters,
                         adapter_leaf_paths(jres.global_adapters))
    assert taggregation.METHODS == jaggregation.METHODS == taggs.METHODS


@pytest.mark.parametrize("svd_method", ["svd", "gram"])
def test_florist_loop_oracle_matches_batched(svd_method):
    """The per-layer loop and the batched pipeline give the same ranks,
    spectra and products (and the loop forces the stacked stream)."""
    rng = np.random.default_rng(11)
    ranks = (4, 8, 16)
    clients = [_ours(_client(rng, r, flat=True)) for r in ranks]
    w = rng.dirichlet(np.ones(3))
    loop = taggs.FloristAggregator(svd_method=svd_method, pipeline="loop",
                                   stream="delta", flush_every=2)
    assert loop.stream == "stacked"
    res = loop.aggregate(clients, w)
    ref = taggs.FloristAggregator(svd_method=svd_method, stream="stacked",
                                  flush_every=2).aggregate(clients, w)
    assert res.ranks == ref.ranks
    for path in res.ranks:
        for s, sr in zip(res.spectra[path], ref.spectra[path]):
            _rel(s, sr)
    _check_tree_products(res.global_adapters, ref.global_adapters, list(res.ranks))
    with pytest.raises(ValueError):
        taggs.FloristAggregator(pipeline="sharded")


def test_registry_builds_the_five_methods():
    assert set(taggs.METHODS) <= set(taggs.available_aggregators())
    for m in taggs.METHODS:
        cls = taggs.get_aggregator_class(m)
        assert cls.name == m
        assert type(taggs.make_aggregator(m)).__name__ == \
            type(jaggs.make_aggregator(m)).__name__
    # the layer-sharded variant is ported (the multi-device slice): it
    # registers beside the five, as the reference's does on import
    import repro.core.distributed  # noqa: F401
    agg = taggs.make_aggregator("florist_sharded")
    assert type(agg).__name__ == \
        type(jaggs.make_aggregator("florist_sharded")).__name__
    assert isinstance(agg, taggs.FloristAggregator) and agg.svd_method == "gram"
    with pytest.raises(ValueError, match="unknown aggregation method"):
        taggs.make_aggregator("fedavg")
