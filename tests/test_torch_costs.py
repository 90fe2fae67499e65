"""Port parity of the cost model, the ``bf16`` wire codec, the config
registry and the Table 3 / Table 4 counterparts, against ``repro.core.
costs``, ``repro.core.runtime.transport``, ``repro.configs`` and the
reference's ``benchmarks/``.

Every ``costs.*`` function is compared exactly on Table 3's trees (wq and
wv, rank 16, 10 clients): the analytic functions at TinyLlama's full
geometry, the ones that aggregate or serialize trees at a cut geometry
(3 layers, d 256), where the whole Table 3 benchmark is also held to the
reference's rows string for string.  The bf16 codec's bytes equal the
reference's ``ml_dtypes`` cast bit for bit, NaN, infinities and
subnormals included.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import aggregators as jaggs  # noqa: E402
from repro.core import costs as jcosts  # noqa: E402
from repro.core.runtime import transport as jtransport  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.benchmarks import table3_comm_cost as t3  # noqa: E402
from repro_torch.benchmarks import table4_server_flops as t4  # noqa: E402
from repro_torch.core import aggregators as taggs  # noqa: E402
from repro_torch.core import costs as tcosts  # noqa: E402
from repro_torch.core.runtime import transport as ttransport  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
METHODS = ("florist", "fedit", "ffa", "flora", "flexlora")
L3, D3 = 3, 256                      # Table 3's trees cut to this geometry
R, K = 16, 10


def _trees(rng, layers=L3, d=D3):
    """Table 3's client trees (wq and wv of every layer, rank 16) with
    random values."""
    def leaf():
        return {"A": (rng.normal(size=(layers, R, d)) * 0.1).astype(np.float32),
                "B": (rng.normal(size=(layers, d, R)) * 0.1).astype(np.float32),
                "scale": np.ones((layers,), np.float32)}
    return [{"blocks": {0: {"attn": {"wq": leaf(), "wv": leaf()}}}}
            for _ in range(K)]


def _ours(tree):
    if isinstance(tree, dict) and "A" in tree:
        return {"A": tree["A"], "B": tree["B"],
                "scale": torch.from_numpy(tree["scale"])}
    return {k: _ours(v) for k, v in tree.items()}


def _tt(tree):
    if isinstance(tree, dict):
        return {k: _tt(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("method", METHODS)
def test_costs_match_reference_on_table3_trees(method):
    rng = np.random.default_rng(0)
    trees = _trees(rng)
    jtrees = [jax.tree.map(jnp.asarray, t) for t in trees]
    w = [1.0 / K] * K
    cfg = {"ffa": dict(A_init=trees[0]), "florist": dict(tau=0.9)}.get(method, {})
    jagg = jaggs.make_aggregator(method, **{k: jax.tree.map(jnp.asarray, v)
                                            if k == "A_init" else v
                                            for k, v in cfg.items()})
    tagg = taggs.make_aggregator(method, **{k: _tt(v) if k == "A_init" else v
                                            for k, v in cfg.items()})
    jres = jagg.aggregate(jtrees, w)
    res = tagg.aggregate([_ours(t) for t in trees], w)
    dims = taggs.leaf_dims(trees[0])
    ranks = [R] * K
    assert tcosts.upload_params(method, trees) == jcosts.upload_params(method, jtrees)
    for n in (1, K):
        assert tcosts.download_params(method, res, dims, n, ranks) == \
            jcosts.download_params(method, jres, dims, n, ranks)
    for half in (True, False):
        assert tcosts.total_download_rank(res, half) == \
            jcosts.total_download_rank(jres, half)
    assert tcosts.efficiency(res, ranks, dims) == jcosts.efficiency(jres, ranks, dims)
    for codec in ("fp32", "bf16"):
        up = tcosts.wire_upload_bytes(method, [_tt(t) for t in trees], codec)
        assert up == jcosts.wire_upload_bytes(method, jtrees, codec)
        down = tcosts.wire_download_bytes(method, res, 3, codec)
        assert down == jcosts.wire_download_bytes(method, jres, 3, codec)
        per = 4 if codec == "fp32" else 2
        assert up == per * tcosts.upload_params(method, trees)
        assert down == per * tcosts.download_params(method, res, dims, 3, ranks)
    # the analytic functions at TinyLlama's geometry (22 L, 2048 x 2048)
    full = {("blocks", 0, "attn", n): (22, 2048, 2048) for n in ("wq", "wv")}
    kept = {p: [7] * 22 for p in full}
    for agg_ranks in (None, kept):
        assert tcosts.server_flops(method, full, ranks, agg_ranks) == \
            jcosts.server_flops(method, full, ranks, agg_ranks)
    assert tcosts.mb(123456) == jcosts.mb(123456)
    assert tcosts.full_ft_params(1100048384, K) == jcosts.full_ft_params(1100048384, K)
    assert (tcosts.BYTES_FP16, tcosts.SVD_CONST) == (jcosts.BYTES_FP16, jcosts.SVD_CONST)


def test_bf16_codec_bytes_match_reference_bit_for_bit():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=4096) * 10.0 ** rng.integers(-44, 38, 4096)).astype(np.float32)
    x[:8] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, 3.3961776e38]
    x[8:11] = np.array([0x7F800001, 0xFFC00001, 0x7FFFFFFF], np.uint32).view(np.float32)
    for arr in (x, x.reshape(64, 64), rng.normal(size=(3, 5, 7)).astype(np.float32)):
        j, t = jtransport.make_codec("bf16"), ttransport.make_codec("bf16")
        je, te = j.encode(arr), t.encode(arr)
        assert te.data == je.data and tuple(te.shape) == tuple(je.shape)
        assert te.num_bytes == je.num_bytes == 2 * arr.size
        np.testing.assert_array_equal(t.decode(te).view(np.uint32),
                                      j.decode(je).view(np.uint32))
        assert t.bytes_per_param == j.bytes_per_param == 2.0
    assert ttransport.make_codec("fp32").bytes_per_param == 4.0
    assert ttransport.available_codecs() == ["bf16", "fp32"]


def test_per_client_downlink_matches_reference():
    """FlexLoRA's downlink ships each client's own tree once; a result with
    no global tree decodes to ``None``."""
    rng = np.random.default_rng(2)
    trees = _trees(rng, layers=2, d=32)[:3]
    ranks = [4, 8, 16]
    cut = [{"blocks": {0: {"attn": {n: {"A": leaf["A"][:, :r], "B": leaf["B"][..., :r],
                                        "scale": leaf["scale"]}
                                    for n, leaf in t["blocks"][0]["attn"].items()}}}}
           for t, r in zip(trees, ranks)]
    w = [0.2, 0.3, 0.5]
    jres = jaggs.make_aggregator("flexlora").aggregate(
        [jax.tree.map(jnp.asarray, t) for t in cut], w)
    res = taggs.make_aggregator("flexlora").aggregate([_ours(t) for t in cut], w)
    for codec in ("fp32", "bf16"):
        jdec, jb = jtransport.Transport(codec).server_to_clients(jres, None, 5)
        dec, b = ttransport.Transport(codec).server_to_clients(res, None, 5)
        per = 4 if codec == "fp32" else 2       # bytes a parameter
        assert b == jb == per * sum(2 * 2 * r * (32 + 32) for r in ranks)
        assert set(taggs.adapter_leaf_paths(dec)) == set(taggs.adapter_leaf_paths(jdec))
    jres.global_adapters = None
    res.global_adapters = None
    assert jtransport.Transport("bf16").server_to_clients(jres, None, 5)[0] is None
    assert ttransport.Transport("bf16").server_to_clients(res, None, 5) == (None, b)


def test_param_count_and_config_registry_match_reference():
    for name in tconfigs.PORTED:
        for get in ("get_config", "get_smoke_config"):
            ours, ref = getattr(tconfigs, get)(name), getattr(jconfigs, get)(name)
            assert ours.param_count() == ref.param_count(), (name, get)
            for field in ("name", "num_layers", "d_model", "num_heads",
                          "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                          "dtype", "source"):
                assert getattr(ours, field) == getattr(ref, field), (name, field)
    tiny = tconfigs.get_config("tinyllama-1.1b")
    assert tiny.param_count() == jconfigs.get_config("tinyllama_1p1b").param_count()
    assert (tiny.num_layers, tiny.d_model, tiny.num_heads, tiny.num_kv_heads,
            tiny.head_dim, tiny.d_ff, tiny.vocab_size) == (22, 2048, 32, 4, 64,
                                                           5632, 32000)
    for alias, mod in jconfigs._ALIAS.items():
        if mod in tconfigs.PORTED:
            assert tconfigs.get_config(alias) == tconfigs.get_config(mod)
        else:
            with pytest.raises(NotImplementedError, match="not ported"):
                tconfigs.get_config(alias)
    assert set(tconfigs.PORTED) | set(tconfigs.NOT_PORTED) == set(jconfigs.ARCH_IDS)
    with pytest.raises(ValueError, match="unknown config"):
        tconfigs.get_config("gpt2")


def test_table3_counterpart_matches_reference_rows(monkeypatch):
    """The whole Table 3 at a cut geometry (the Full-FT row stays
    TinyLlama's): the same rows as ``benchmarks/table3_comm_cost.py``."""
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import table3_comm_cost as j3
    for mod in (j3, t3):
        monkeypatch.setattr(mod, "L", L3)
        monkeypatch.setattr(mod, "D", D3)
    rows = t3.run(device="cpu")
    assert rows == j3.run()
    assert all("wire_matches_analytic=True" in r["derived"] for r in rows[1:-1])


def test_table4_counterpart_analytic_rows_and_cpu_times():
    rows = t4.run(device="cpu")
    by = {r["name"]: r for r in rows}
    full = {("blocks", 0, "attn", n): (22, 2048, 2048) for n in ("wq", "wv")}
    kept = {p: [7] * 22 for p in full}
    for m in METHODS:
        want = jaggs.make_aggregator(m).server_flops(full, [R] * K, kept)
        assert by[f"table4/analytic/{m}"]["derived"] == f"flops={want:.3e}"
    # a device time comes from the card only
    for name in ("florist_measured", "flexlora_measured", "speedup"):
        assert by[f"table4/{name}"]["us_per_call"] == "not measured"
    bs = torch.randn(64, K * R, dtype=torch.float32)
    as_ = torch.randn(K * R, 48, dtype=torch.float32)
    b, a = t4.flexlora(bs, as_)
    u, s, vt = np.linalg.svd((bs @ as_).double().numpy(), full_matrices=False)
    np.testing.assert_allclose((b @ a).numpy(), (u[:, :R] * s[:R]) @ vt[:R],
                               rtol=0, atol=1e-4 * s[0])
