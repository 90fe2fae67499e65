"""Training with a ``model`` axis in the port (``make_train_step`` /
``make_eval_step`` / ``make_prefill_step`` with ``mesh=``) on one gloo
world of 2 ranks over a ``file://`` store, against the JAX reference run
mesh-less on its one CPU device.

The reference's params and adapters (non-zero B) are carried in through
``repro_torch.convert`` and cut to each rank's shards by the rules
(``shard_params``; the batch by ``shard_batch``).  Cases, fp32: dense GQA
head-parallel (plain and kernel routes), sequence-parallel with heads cut
mid-head (6 heads over 3 KV heads at model 2, QKV bias, ``qk_norm``, tied
embeddings: the embedding and the CE vocab-parallel), the batch fallback
(S not divisible), the kernel route on gathered heads, MLA's
sequence-parallel absorbed route and its head-parallel fallback, the CE's
masked sums over data=2 with ragged masks (an empty row), ZeRO-3 at
data=2 (the module's threshold lowered in the ranks) and ``grad_accum``
2 over model and over data.  Each: the loss within 1e-5, every adapter
leaf's gradient within 1e-4 · max(1, max|g|), one AdamW step's adapters
(eps 1e-3: at 1e-8 an entry whose gradient is within fp32 noise of zero
steps by ±lr) within 1e-4 of max(1, |a|), the eval metrics and the
prefill's whole (B, V) logits; the adapters bit-equal on both ranks; the
collectives a step as the design counts them.  Units: ``flash_torch(
q_offset=)`` against ``flash_jax(q_offset=)``, ``dispatch_flash``'s
sequence branch on mid-head column slices and ``mla_absorbed``'s
sequence-parallel branch against the reference's mesh-less functions,
``T.init(keep=init_keep(...))`` against the whole init's slices, and the
refusals that remain: every family builds its steps on a mesh, and one
whose widths the axis does not divide (RWKV6's or Mamba2's heads, an
MLP's ``d_ff``, DeepSeek-V3's shared expert) raises ``ValueError``.

The module imports JAX only inside functions, so the spawned ranks start
without it; the world starts in a thread while the parent computes the
JAX references.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import topology as ttop  # noqa: E402

GQA = dict(name="sh-gqa", family="dense", num_layers=2, d_model=32,
           num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
           dtype="float32")
MID = dict(GQA, name="sh-mid", num_heads=6, num_kv_heads=3, qkv_bias=True,
           qk_norm=True, tie_embeddings=True)
# DeepSeek-V3's plan cut to its dense MLA layers (an empty MoE segment)
MLA = dict(name="sh-mla", family="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=4, head_dim=16, d_ff=64, vocab_size=64,
           dtype="float32", use_mla=True, q_lora_rank=32, kv_lora_rank=32,
           qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
           num_experts=4, experts_per_token=2, moe_d_ff=32,
           first_dense_layers=2)
CONFIGS = {"gqa": GQA, "mid": MID, "mla": MLA}
# case -> (config, model axis (data = 2 / model), S, use_kernels,
#          grad_accum, ZeRO-3, the attention branch)
CASES = {
    "heads": ("gqa", 2, 16, False, 1, False, "heads"),
    "heads_kernel": ("gqa", 2, 16, True, 1, False, "heads"),
    "sequence": ("mid", 2, 16, False, 1, False, "sequence"),
    "batch": ("mid", 2, 15, False, 1, False, "batch"),
    "batch_kernel": ("mid", 2, 16, True, 1, False, "batch"),
    "mla_sequence": ("mla", 2, 16, True, 1, False, "sequence"),
    "mla_heads": ("mla", 2, 15, False, 1, False, "heads"),
    "data": ("mid", 1, 16, False, 1, False, "heads"),
    "zero3": ("gqa", 1, 16, True, 1, True, "heads"),
    "accum_model": ("mid", 2, 16, False, 2, False, "sequence"),
    "accum_data": ("gqa", 1, 16, False, 2, False, "heads"),
}
B, CHUNK, LR, EPS = 4, 8, 1e-2, 1e-3


def _batch(S: int):
    """Tokens and a ragged mask: row 1 empty, row 3 two tokens."""
    rng = np.random.default_rng(S)
    toks = rng.integers(0, 64, (B, S))
    mask = (rng.random((B, S)) > 0.3).astype(np.float32)
    mask[1] = 0.0
    mask[3] = 0.0
    mask[3, 4:6] = 1.0
    return toks, mask


def _model_config(kw):
    from repro_torch.common.config import ModelConfig
    return ModelConfig(**kw)


def _rank(np_params, np_ads):
    """Every case on one rank of the world."""
    from repro_torch.common.config import OptimConfig
    from repro_torch.convert import adapters_from_numpy, params_from_numpy
    from repro_torch.models.attention_core import dispatch_flash, mla_absorbed
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.topology import partitioning
    from repro_torch.topology.train import (TrainParallel, init_keep,
                                            shard_batch, shard_params)
    from repro_torch.train import step as St
    torch.set_num_threads(1)
    out = {}
    threshold = partitioning.ZERO3_THRESHOLD
    for case, (key, model, S, uk, ga, zero3, _) in CASES.items():
        cfg = _model_config(CONFIGS[key])
        partitioning.ZERO3_THRESHOLD = 0 if zero3 else threshold
        mesh = ttop.make_host_mesh(model=model, device="cpu")
        params = shard_params(cfg, params_from_numpy(np_params[key], "cpu"),
                              mesh)
        ad = adapters_from_numpy(np_ads[key], "cpu")
        toks, mask = _batch(S)
        whole = {"tokens": torch.as_tensor(toks),
                 "loss_mask": torch.as_tensor(mask)}
        batch = shard_batch(cfg, whole, mesh, ga)
        step = St.make_train_step(cfg, OptimConfig(lr=LR, eps=EPS),
                                  loss_chunk=CHUNK, use_kernels=uk,
                                  grad_accum=ga, mesh=mesh)
        metrics, grads = step.grads(params, ad, batch)
        counts = dict(step.tp.counts)
        new, _, _ = step(params, ad, adamw_init(ad), batch)
        ev = St.make_eval_step(cfg, CHUNK, uk, mesh=mesh)
        em = ev(params, ad, shard_batch(cfg, whole, mesh))
        pf = St.make_prefill_step(cfg, uk, mesh=mesh)
        pre = pf(params, ad, shard_batch(cfg, {"tokens": whole["tokens"]},
                                         mesh))
        rec = {"metrics": {k: float(v) for k, v in metrics.items()},
               "grads": [g.numpy() for g in tree_leaves(grads)],
               "new": [a.numpy() for a in tree_leaves(new)],
               "eval": {k: float(v) for k, v in em.items()},
               "eval_counts": dict(ev.tp.counts),
               "prefill_counts": dict(pf.tp.counts),
               "prefill": pre.numpy(), "counts": counts}
        if zero3:
            rec["halves"] = all(
                shard.shape[-2 if name in partitioning._COL_MODEL else -1] * 2
                == leaf.shape[-2 if name in partitioning._COL_MODEL else -1]
                for name, shard, leaf in _named_pairs(
                    params, params_from_numpy(np_params[key], "cpu")))
            rec["init_keep"] = _same_init(cfg, mesh, init_keep)
        out[case] = rec
    partitioning.ZERO3_THRESHOLD = threshold
    mesh = ttop.make_host_mesh(model=2, device="cpu")
    out["init_keep_model"] = _same_init(_model_config(MID), mesh, init_keep)
    tp = TrainParallel(mesh)
    # dispatch_flash's sequence branch on mid-head column slices
    q, k, v = _attn_inputs()
    cols = [tp.local(t.reshape(2, 16, -1)) for t in (q, k, v)]

    def heads(qc, kc, vc, rows):
        return (qc.reshape(2, qc.shape[1], -1, 8), kc.reshape(2, 16, -1, 8),
                vc.reshape(2, 16, -1, 8))
    out["dispatch"] = dispatch_flash(*cols, heads, kv_heads=3, tp=tp,
                                     q_chunk=4, kv_chunk=8).numpy()
    # mla_absorbed's sequence-parallel branch on the rank's heads
    qn, qr, ckv, kr, w = _mla_inputs()
    out["mla"] = mla_absorbed(tp.local(qn, 2), tp.local(qr, 2), ckv, kr, w,
                              num_heads=4, nope_dim=16, v_dim=16, tp=tp,
                              q_chunk=4, kv_chunk=8).numpy()
    out["refusals"] = _refusals(mesh)
    out["ops"] = _ops(tp)
    return out


def _ops(tp):
    """Each autograd collective's forward and backward on a rank: x is the
    rank's (2, 4) block, the upstream gradient 1 + the rank's index."""
    r = tp.index
    x = (torch.arange(8.0).reshape(2, 4) + 10 * r).requires_grad_(True)
    out = {}
    for name, fn, gshape in (
            ("copy", lambda t: tp.copy(t), (2, 4)),
            ("reduce", lambda t: tp.reduce(t), (2, 4)),
            ("gather", lambda t: tp.gather(t, -1), (2, 8)),
            ("split", lambda t: tp.split(t, -1), (2, 2)),
            ("exchange", lambda t: tp.exchange(t, 0, 1), (1, 8))):
        y = fn(x)
        gy = torch.full(gshape, 1.0 + r)
        (gx,) = torch.autograd.grad(y, x, gy)
        out[name] = (y.detach().numpy(), gx.numpy())
    return out


def _named_pairs(shards, whole):
    from repro_torch.topology.partitioning import _COL_MODEL, _ROW_MODEL
    for seg_s, seg_w in zip(shards["blocks"], whole["blocks"]):
        for sub in ("attn", "mlp"):
            for name, t in seg_s[sub].items():
                if name in _COL_MODEL + _ROW_MODEL:
                    yield name, t, seg_w[sub][name]


def _same_init(cfg, mesh, init_keep):
    from repro_torch.models import transformer as T
    from repro_torch.topology.train import shard_params
    kept = T.init(cfg, 3, "cpu", keep=init_keep(cfg, mesh))
    cut = shard_params(cfg, T.init(cfg, 3, "cpu"), mesh)
    pairs = []
    ttop.partitioning._zip_specs(lambda a, b: pairs.append(torch.equal(a, b)),
                                 kept, cut)
    return len(pairs) > 10 and all(pairs)


def _attn_inputs():
    rng = np.random.default_rng(11)
    return tuple(torch.as_tensor(rng.normal(size=(2, 16, h, 8)), dtype=torch.float32)
                 for h in (6, 3, 3))


def _mla_inputs():
    rng = np.random.default_rng(12)
    shapes = ((2, 16, 4, 16), (2, 16, 4, 16), (2, 16, 32), (2, 16, 16),
              (32, 4 * 32))
    return tuple(torch.as_tensor(rng.normal(size=s) * 0.3, dtype=torch.float32)
                 for s in shapes)


def _refusals(mesh):
    """Each family's SMOKE config, and one with a width a model axis of 2
    does not divide, given a mesh of 2 ranks."""
    from repro_torch.common.config import OptimConfig
    from repro_torch.configs import (deepseek_v3_671b, granite_moe_1b_a400m,
                                     musicgen_medium, phi3_vision_4p2b,
                                     rwkv6_1p6b, zamba2_1p2b)
    from repro_torch.train import step as St
    cfgs = [mod.SMOKE for mod in (granite_moe_1b_a400m, deepseek_v3_671b,
                                  rwkv6_1p6b, zamba2_1p2b, phi3_vision_4p2b,
                                  musicgen_medium)]
    cfgs += [rwkv6_1p6b.SMOKE.replace(name="odd-rwkv-heads", d_model=96),
             zamba2_1p2b.SMOKE.replace(name="odd-ssm-heads", d_model=48),
             phi3_vision_4p2b.SMOKE.replace(name="odd-d-ff", d_ff=511),
             deepseek_v3_671b.SMOKE.replace(name="odd-shared-expert",
                                            moe_d_ff=127)]
    out = {}
    for cfg in cfgs:
        for make in (lambda c: St.make_train_step(c, OptimConfig(), mesh=mesh),
                     lambda c: St.make_eval_step(c, mesh=mesh),
                     lambda c: St.make_prefill_step(c, mesh=mesh)):
            try:
                make(cfg)
                out.setdefault(cfg.name, []).append("built")
            except ValueError as e:
                out.setdefault(cfg.name, []).append(str(e))
    return out


def _trees():
    """The port's seeded params and adapters (non-zero B) for each config,
    as numpy: the reference takes them as they are, the ranks through
    ``repro_torch.convert``."""
    from repro_torch.configs import lora_targets
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    from repro_torch.topology.partitioning import tree_map
    np_params, np_ads = {}, {}
    for key, kw in CONFIGS.items():
        cfg = _model_config(kw)
        params = T.init(cfg, 0, "cpu")
        gen = torch.Generator().manual_seed(1)
        ad = init_lora(params, lora_targets(cfg), 4, 8.0, gen)
        rng = np.random.default_rng(2)
        ad = ttop.partitioning.map_with_path(
            lambda p, t: torch.as_tensor(rng.normal(size=t.shape) * 0.05,
                                         dtype=t.dtype)
            if p[-1] == "B" else t, ad)
        np_params[key] = tree_map(lambda t: t.numpy(), params)
        np_ads[key] = tree_map(lambda t: t.numpy(), ad)
    return np_params, np_ads


def _jax_reference(np_params, np_ads):
    """For each case the reference's mesh-less loss, metrics, gradients,
    one AdamW step, eval metrics and prefill logits (compiled once for
    each config, sequence length and microbatch), and the units'
    outputs."""
    import jax
    import jax.numpy as jnp

    from repro.common.config import ModelConfig as JModelConfig
    from repro.common.config import OptimConfig as JOptimConfig
    from repro.optim.adamw import adamw_init, adamw_update
    from repro.train import step as JStep
    to_j = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    grad_fns, prefill_fns, upd_fns, ref = {}, {}, {}, {}
    for case, (key, _, S, _, ga, _, _) in CASES.items():
        jcfg = JModelConfig(**CONFIGS[key])
        jp, ja = to_j(np_params[key]), to_j(np_ads[key])
        if key not in grad_fns:
            grad_fns[key] = jax.jit(jax.value_and_grad(
                lambda a, b, p, c=jcfg: JStep.loss_fn(c, p, a, b,
                                                      loss_chunk=CHUNK),
                has_aux=True))
            prefill_fns[key] = jax.jit(JStep.make_prefill_step(jcfg))
            upd_fns[key] = jax.jit(lambda g, s, a: adamw_update(
                JOptimConfig(lr=LR, eps=EPS), g, s, a))
        toks, mask = _batch(S)
        batch = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)}
        n = B // ga
        parts = [grad_fns[key](ja, {k: v[i * n:(i + 1) * n]
                                    for k, v in batch.items()}, jp)
                 for i in range(ga)]
        grads = jax.tree.map(lambda *g: sum(g) / ga, *[g for _, g in parts])
        metrics = {k: float(np.mean([m[k] for (_, m), _ in parts]))
                   for k in parts[0][0][1]}
        new, _ = upd_fns[key](grads, adamw_init(ja), ja)
        (_, ev), _ = (parts[0] if ga == 1 else
                      grad_fns[key](ja, batch, jp))
        ref[case] = {
            "metrics": metrics,
            "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)],
            "new": [np.asarray(a) for a in jax.tree_util.tree_leaves(new)],
            "eval": {k: float(v) for k, v in ev.items()},
            "prefill": np.asarray(prefill_fns[key](
                jp, ja, {"tokens": batch["tokens"]}))}
    from repro.models.attention_core import flash_jax, mla_absorbed
    q, k, v = (jnp.asarray(t.numpy()) for t in _attn_inputs())
    ref["dispatch"] = np.asarray(flash_jax(q, k, v, q_chunk=4, kv_chunk=8)
                                 ).reshape(2, 16, -1)
    qn, qr, ckv, kr, w = (jnp.asarray(t.numpy()) for t in _mla_inputs())
    ref["mla"] = np.asarray(mla_absorbed(qn, qr, ckv, kr, w, num_heads=4,
                                         nope_dim=16, v_dim=16, q_chunk=4,
                                         kv_chunk=8))
    ref["flash_offset"] = [
        (off, np.asarray(flash_jax(q[:, off:off + 8], k, v, q_chunk=4,
                                   kv_chunk=8, q_offset=off, window=5)))
        for off in (0, 8)]
    return ref


@pytest.fixture(scope="module")
def world():
    np_params, np_ads = _trees()
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(ttop.spawn, _rank, 2, "gloo", "cpu",
                          args=(np_params, np_ads), timeout_s=240)
        ref = _jax_reference(np_params, np_ads)
        res = fut.result()
    return res, ref


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    lim = tol * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= lim, (what, err, lim)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_reference_mesh_less(world, case):
    res, ref = world
    want = ref[case]
    for r in (0, 1):
        got = res[r][case]
        assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) <= 1e-5
        for k in ("tokens", "accuracy"):
            assert abs(got["metrics"][k] - want["metrics"][k]) <= 1e-5, k
        assert len(got["grads"]) == len(want["grads"])
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            _close(g, w, 1e-4, f"{case} grad {i}")
        for i, (a, w) in enumerate(zip(got["new"], want["new"])):
            _close(a, w, 1e-4, f"{case} adapter {i}")
        for k in ("loss", "tokens", "accuracy"):
            assert abs(got["eval"][k] - want["eval"][k]) <= 1e-5, k
        _close(got["prefill"], want["prefill"], 1e-4, f"{case} prefill")


@pytest.mark.parametrize("case", list(CASES))
def test_adapters_bit_equal_and_collectives_as_designed(world, case):
    """Bit-equal adapters after the step, and each step's collectives
    those :func:`step_collectives` counts for the design (the branch the
    case names among them)."""
    from repro_torch.topology.train import step_collectives
    res, _ = world
    key, model, S, uk, ga, _, branch = CASES[case]
    cfg = _model_config(CONFIGS[key])
    for a, b in zip(res[0][case]["new"], res[1][case]["new"]):
        assert np.array_equal(a, b)
    kw = dict(loss_chunk=CHUNK, use_kernels=uk)
    for r in (0, 1):
        if case == "zero3":
            threshold = ttop.partitioning.ZERO3_THRESHOLD
            ttop.partitioning.ZERO3_THRESHOLD = 0
        try:
            for kind, got in (("train", res[r][case]["counts"]),
                              ("eval", res[r][case]["eval_counts"]),
                              ("prefill", res[r][case]["prefill_counts"])):
                assert got == step_collectives(
                    cfg, model, 2 // model, S, kind=kind,
                    grad_accum=ga if kind == "train" else 1, **kw), (kind, r)
        finally:
            if case == "zero3":
                ttop.partitioning.ZERO3_THRESHOLD = threshold
    counts = res[0][case]["counts"]
    assert ("model:all_to_all" in counts) == (branch == "sequence")
    assert ("model:reduce_scatter" in counts) == (
        model > 1 and (branch != "heads" or key == "mla"))


def test_zero3_ranks_hold_halves_and_init_keeps_slices(world):
    res, _ = world
    for r in (0, 1):
        assert res[r]["zero3"]["halves"]
        assert res[r]["zero3"]["init_keep"]
        assert res[r]["init_keep_model"]


def test_dispatch_and_mla_sequence_branches_match_reference(world):
    """Each rank's columns of ``dispatch_flash``'s sequence branch (K 3 on
    a model axis of 2: q exchanged to its rows, K/V gathered, rows at
    their offset) and each rank's heads of ``mla_absorbed``'s sequence
    branch, against the reference's mesh-less functions."""
    res, ref = world
    for r in (0, 1):
        w = ref["dispatch"].shape[-1] // 2
        _close(res[r]["dispatch"], ref["dispatch"][..., r * w:(r + 1) * w],
               1e-5, "dispatch")
        _close(res[r]["mla"], ref["mla"][:, :, 2 * r:2 * r + 2], 1e-5, "mla")


def test_flash_q_offset_matches_reference(world):
    from repro_torch.models.attention_core import flash_torch
    _, ref = world
    q, k, v = _attn_inputs()
    for off, want in ref["flash_offset"]:
        got = flash_torch(q[:, off:off + 8], k, v, q_chunk=4, kv_chunk=8,
                          q_offset=off, window=5)
        _close(got.numpy(), want, 1e-5, f"q_offset {off}")


def test_indivisible_widths_refuse_a_mesh(world):
    """Every family builds its train, eval and prefill steps on a mesh of
    2; a width the axis does not divide raises ``ValueError`` naming it."""
    res, _ = world
    refusals = res[0]["refusals"]
    assert len(refusals) == 10
    widths = {"odd-rwkv-heads": "RWKV heads", "odd-ssm-heads": "SSM heads",
              "odd-d-ff": "d_ff", "odd-shared-expert": "num_shared_experts"}
    for name, msgs in refusals.items():
        assert len(msgs) == 3
        for m in msgs:
            if name in widths:
                assert widths[name] in m and "does not divide" in m, (name, m)
                assert "9d" not in m
            else:
                assert m == "built", (name, m)


def test_collective_ops_and_their_transposes(world):
    """``copy`` / ``reduce`` / ``gather`` / ``split`` / ``exchange`` over a
    model axis of 2: each forward, and each backward the transposed
    collective (``all_reduce``, identity, reduce-scatter, ``all_gather``,
    the inverse ``all_to_all``), on rank r's block x_r = arange(8) + 10 r
    under an upstream gradient of 1 + r."""
    res, _ = world
    xs = [np.arange(8.0).reshape(2, 4) + 10 * r for r in (0, 1)]
    for r in (0, 1):
        ops = res[r]["ops"]
        y, gx = ops["copy"]
        assert np.array_equal(y, xs[r]) and np.all(gx == 3.0)      # 1 + 2
        y, gx = ops["reduce"]
        assert np.array_equal(y, xs[0] + xs[1]) and np.all(gx == 1.0 + r)
        y, gx = ops["gather"]
        assert np.array_equal(y, np.concatenate(xs, axis=-1))
        assert np.all(gx == 3.0)                # the parts summed, r's slice
        y, gx = ops["split"]
        assert np.array_equal(y, xs[r][:, 2 * r:2 * r + 2])
        want = np.zeros((2, 4))
        want[:, 0:2], want[:, 2:4] = 1.0, 2.0   # every rank's slice gradient
        assert np.array_equal(gx, want)
        y, gx = ops["exchange"]
        assert np.array_equal(y, np.concatenate(
            [xs[0][r:r + 1], xs[1][r:r + 1]], axis=1))
        want = np.zeros((2, 4))
        want[0], want[1] = 1.0, 2.0             # row j went to rank j
        assert np.array_equal(gx, want), (r, gx)
