"""Training with a ``model`` axis for every other family of the reference
(MoE with expert parallelism, RWKV6, the Mamba2 hybrid, the vision and
audio front ends): ``make_train_step`` / ``make_eval_step`` /
``make_prefill_step`` with ``mesh=`` on one gloo world of 4 ranks over a
``file://`` store, meshed ``(data=2, model=2)``, against the JAX
reference run mesh-less on its one CPU device.

The six models are the SMOKE configs at 2 layers (DeepSeek-V3: one dense
MLA layer and one MoE layer; zamba2: two Mamba2 layers and one
shared-block application; the MoE coefficient raised to 0.5), fp32, with
the port's seeded params (RWKV6's ``u`` / ``w0`` and Mamba2's ``D`` /
``dt_bias`` varied) and adapters on ``lora_targets`` with non-zero B,
carried into the reference as they are and into the ranks through
``repro_torch.convert``, cut by ``shard_params`` (Mamba2's fused leaves
segment by segment, the expert stacks over ``("data", "model")``).  A MoE
layer on a mesh routes as the reference's ``_moe_fwd_sharded``: each
(data, model) slab at its own capacity, aux the slabs' mean; the
reference's side is its mesh-less ``moe_fwd`` on each slab (its module's
``moe_fwd`` swapped for a slab-by-slab one while the reference is traced).
Each model: the loss within 1e-5, every adapter leaf's gradient within
1e-4 · max(1, max|g|), one AdamW step's adapters within 1e-4 of max(1,
|a|), the eval metrics (aux included) and the prefill's whole (B, V)
logits within 1e-4 · max(1, |logit|); the adapters bit-equal on the four
ranks; the collectives of each step as ``step_collectives`` counts them.

Layer cases, forward and ``jax.vjp`` gradients: ``moe_fwd(tp=)`` at a
capacity that binds against the reference's ``moe_fwd`` on each slab (aux
against the slabs' mean); its mesh-less fallback (S not divisible by the
axis) against ``moe_fwd`` on every token of the batch, aux's gradient
counted once; ``mamba2_fwd(tp=)`` with the segment-cut ``in_proj`` and its
adapters' gradients; ``time_mix`` / ``channel_mix(tp=)``.  Also
``T.init(experts=train_experts(...), keep=init_keep(...))`` against the
whole init's slices.

The module imports JAX only inside functions, so the spawned ranks start
without it; the world starts in a thread while the parent computes the
JAX references.
"""
import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import topology as ttop  # noqa: E402

DATA, MODEL = 2, 2
B, S, CHUNK, LR, EPS = 4, 16, 8, 1e-2, 1e-3
# model -> (config module, use_kernels)
MODELS = {"granite": ("granite_moe_1b_a400m", True),
          "dsv3": ("deepseek_v3_671b", False),
          "rwkv": ("rwkv6_1p6b", True),
          "zamba2": ("zamba2_1p2b", True),
          "phi3": ("phi3_vision_4p2b", True),
          "musicgen": ("musicgen_medium", False)}
MOE_BIND = 0.25                 # the layer case's capacity factor: binds
S_FALLBACK = 15                 # not divisible by the model axis


def _cfg(key):
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{MODELS[key][0]}")
    cfg = mod.SMOKE.replace(num_layers=2)
    if cfg.num_experts:
        cfg = cfg.replace(router_aux_coef=0.5,
                          first_dense_layers=min(1, cfg.first_dense_layers))
    return cfg


def _jcfg(cfg):
    from repro.common.config import ModelConfig
    return ModelConfig(**dataclasses.asdict(cfg))


def _batch(cfg, seq: int = S):
    """A ragged mask (row 1 empty, row 3 two tokens); a vision batch's
    patch embeddings before the tokens; an audio batch's frames and
    labels."""
    rng = np.random.default_rng(seq + len(cfg.name))
    toks = rng.integers(0, cfg.vocab_size, (B, seq))
    mask = (rng.random((B, seq)) > 0.3).astype(np.float32)
    mask[1] = 0.0
    mask[3] = 0.0
    mask[3, 4:6] = 1.0
    if cfg.frontend == "audio":
        return {"frame_embeds": rng.normal(size=(B, seq, cfg.frontend_dim)
                                           ).astype(np.float32),
                "labels": toks, "loss_mask": mask}
    batch = {"tokens": toks, "loss_mask": mask}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    return batch


def _prefill_batch(batch):
    return {k: v for k, v in batch.items() if k not in ("loss_mask", "labels")}


def _to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _trees():
    """For each model the port's seeded params and adapters as numpy."""
    from repro_torch.configs import lora_targets
    from repro_torch.models import transformer as T
    from repro_torch.peft.lora import init_lora
    from repro_torch.topology.partitioning import map_with_path, tree_map
    np_params, np_ads = {}, {}
    for key in MODELS:
        cfg = _cfg(key)
        params = T.init(cfg, 0, "cpu")
        rng = np.random.default_rng(2)

        def vary(path, t):
            if path[-1] in ("u", "D", "dt_bias"):
                return torch.as_tensor(rng.uniform(0.2, 1.5, t.shape), dtype=t.dtype)
            if path[-1] == "w0":
                return torch.as_tensor(rng.uniform(-3.0, -0.5, t.shape), dtype=t.dtype)
            return t
        params = map_with_path(vary, params)
        gen = torch.Generator().manual_seed(1)
        ad = init_lora(params, lora_targets(cfg), 4, 8.0, gen)
        ad = map_with_path(lambda p, t: torch.as_tensor(
            rng.normal(size=t.shape) * 0.05, dtype=t.dtype)
            if p[-1] == "B" else t, ad)
        np_params[key] = tree_map(lambda t: t.numpy(), params)
        np_ads[key] = tree_map(lambda t: t.numpy(), ad)
    return np_params, np_ads


def _layer_inputs(d: int, seq: int, seed: int):
    """A layer's input x ~ N(0, 0.25) and the output's cotangent ~ N(0, 1)
    (at x ~ N(0, 1) RWKV6's time mix's fp32 input gradient is itself
    1.2e-4 of its max from fp64's, in both packages; at 0.5 both are
    within 3e-6)."""
    rng = np.random.default_rng(seed)
    return ((0.5 * rng.normal(size=(B, seq, d))).astype(np.float32),
            rng.normal(size=(B, seq, d)).astype(np.float32))


def _rank_layer_cases(np_params, np_ads, mesh):
    """Each layer case on this rank: its rows of x (whole over ``model``),
    the output and x's gradient under the cotangent ``ct`` (and 0.5 on
    aux), and the adapters' gradients summed over the mesh."""
    from repro_torch.convert import adapters_from_numpy, params_from_numpy
    from repro_torch.models import moe as Moe
    from repro_torch.models import rwkv as Rwkv
    from repro_torch.models import ssm as Ssm
    from repro_torch.models.transformer import _layer
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import _unflatten
    from repro_torch.topology.train import shard_params, train_parallel
    rows = slice(mesh.axis_index("data") * (B // DATA),
                 (mesh.axis_index("data") + 1) * (B // DATA))
    out = {}

    def run(name, key, fn, seq, seg, sub, cfg=None):
        cfg = cfg or _cfg(key)
        tp = train_parallel(cfg, mesh)
        params = shard_params(cfg, params_from_numpy(np_params[key], "cpu"),
                              mesh)
        p = _layer(params["blocks"][seg], 0)[sub]
        ads = adapters_from_numpy(np_ads[key], "cpu")
        a = _layer(ads["blocks"][seg], 0).get(sub) if "blocks" in ads and \
            seg in ads["blocks"] else None
        leaves = [t.requires_grad_(True) for t in tree_leaves(a or {})]
        a = _unflatten(a, leaves) if a else None
        xs, ct = _layer_inputs(cfg.d_model, seq, seed=len(name))
        x = torch.as_tensor(xs[rows]).requires_grad_(True)
        y, aux = fn(cfg, p, x, a, tp)
        loss = (y * torch.as_tensor(ct[rows])).sum() + 0.5 * aux
        gs = torch.autograd.grad(loss, [x] + leaves, allow_unused=True)
        ga = [torch.zeros_like(t) if g is None else g
              for g, t in zip(gs[1:], leaves)]
        out[name] = {"y": y.detach().numpy(), "aux": float(aux),
                     "gx": gs[0].numpy(),
                     "ga": [g.numpy() for g in tp.sum_grads(ga)]}

    def moe(cfg, p, x, a, tp):
        return Moe.moe_fwd(cfg, p, x, a, tp=tp)

    bind = _cfg("granite").replace(moe_capacity_factor=MOE_BIND)
    run("moe_bind", "granite", moe, S, 0, "moe", bind)
    run("moe_fallback", "granite", moe, S_FALLBACK, 0, "moe", bind)
    run("dsv3_moe", "dsv3", moe, S, 1, "moe")

    def mamba(cfg, p, x, a, tp):
        return Ssm.mamba2_fwd(cfg, p, x, a, tp=tp), torch.zeros(())
    run("mamba2", "zamba2", mamba, S, 0, "mixer")

    def tmix(cfg, p, x, a, tp):
        return Rwkv.time_mix(cfg, p, x, a, tp=tp)[0], torch.zeros(())

    def cmix(cfg, p, x, a, tp):
        return Rwkv.channel_mix(cfg, p, x, a, tp=tp)[0], torch.zeros(())
    run("time_mix", "rwkv", tmix, S, 0, "mix")
    run("channel_mix", "rwkv", cmix, S, 0, "mix")
    return out


def _same_init(cfg, mesh):
    from repro_torch.models import transformer as T
    from repro_torch.topology.train import init_keep, shard_params, train_experts
    kept = T.init(cfg, 3, "cpu", experts=train_experts(cfg, mesh),
                  keep=init_keep(cfg, mesh))
    cut = shard_params(cfg, T.init(cfg, 3, "cpu"), mesh)
    pairs = []
    ttop.partitioning._zip_specs(lambda a, b: pairs.append(torch.equal(a, b)),
                                 kept, cut)
    return len(pairs) > 10 and all(pairs)


def _rank(np_params, np_ads):
    """Every model's steps and the layer cases on one rank of the world."""
    from repro_torch.common.config import OptimConfig
    from repro_torch.convert import adapters_from_numpy, params_from_numpy
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.topology.train import shard_batch, shard_params
    from repro_torch.train import step as St
    torch.set_num_threads(1)
    mesh = ttop.make_host_mesh(model=MODEL, device="cpu")
    out = {}
    for key, (_, uk) in MODELS.items():
        cfg = _cfg(key)
        params = shard_params(cfg, params_from_numpy(np_params[key], "cpu"),
                              mesh)
        ad = adapters_from_numpy(np_ads[key], "cpu")
        whole = _to_torch(_batch(cfg))
        batch = shard_batch(cfg, whole, mesh)
        step = St.make_train_step(cfg, OptimConfig(lr=LR, eps=EPS),
                                  loss_chunk=CHUNK, use_kernels=uk, mesh=mesh)
        metrics, grads = step.grads(params, ad, batch)
        counts = dict(step.tp.counts)
        new, _, _ = step(params, ad, adamw_init(ad), batch)
        ev = St.make_eval_step(cfg, CHUNK, uk, mesh=mesh)
        em = ev(params, ad, batch)
        pf = St.make_prefill_step(cfg, uk, mesh=mesh)
        pre = pf(params, ad, shard_batch(cfg, _prefill_batch(whole), mesh))
        out[key] = {"metrics": {k: float(v) for k, v in metrics.items()},
                    "grads": [g.numpy() for g in tree_leaves(grads)],
                    "new": [a.numpy() for a in tree_leaves(new)],
                    "eval": {k: float(v) for k, v in em.items()},
                    "prefill": pre.numpy(), "counts": counts,
                    "eval_counts": dict(ev.tp.counts),
                    "prefill_counts": dict(pf.tp.counts),
                    "init_keep": _same_init(cfg, mesh)}
    out["layers"] = _rank_layer_cases(np_params, np_ads, mesh)
    return out


@contextlib.contextmanager
def _reference_slabs(data: int, model: int):
    """The reference's mesh-less ``moe_fwd`` on each (data, model) slab of
    a batch whose S the axis divides, aux the slabs' mean: what its
    ``_moe_fwd_sharded`` computes on that mesh (the experts cut, as they
    are in every case here)."""
    import jax.numpy as jnp
    from repro.models import moe as JMoe
    whole = JMoe.moe_fwd

    def sliced(cfg, p, x, adapters=None):
        Bx, Sx, _ = x.shape
        if Sx % model:
            return whole(cfg, p, x, adapters)
        h, w = Bx // data, Sx // model
        rows, auxes = [], []
        for q in range(data):
            cols = []
            for r in range(model):
                y, a = whole(cfg, p, x[q * h:(q + 1) * h, r * w:(r + 1) * w],
                             adapters)
                cols.append(y)
                auxes.append(a)
            rows.append(jnp.concatenate(cols, axis=1))
        return jnp.concatenate(rows, axis=0), jnp.mean(jnp.stack(auxes))

    JMoe.moe_fwd = sliced
    try:
        yield sliced
    finally:
        JMoe.moe_fwd = whole


def _jax_layer_cases(np_params, np_ads):
    import jax
    import jax.numpy as jnp
    from repro.models import moe as JMoe
    from repro.models import rwkv as JRwkv
    from repro.models import ssm as JSsm
    ref = {}

    def layer(tree, seg, sub):
        node = tree["blocks"][seg] if isinstance(tree["blocks"], tuple) \
            else tree["blocks"].get(seg)
        if node is None or sub not in node:
            return None
        return jax.tree.map(lambda t: jnp.asarray(t[0]), node[sub])

    def run(name, key, fn, seq, seg, sub, cfg=None):
        jcfg = _jcfg(cfg or _cfg(key))
        p = layer(np_params[key], seg, sub)
        a = layer(np_ads[key], seg, sub) if seg in np_ads[key]["blocks"] else None
        xs, ct = _layer_inputs(jcfg.d_model, seq, seed=len(name))

        @jax.jit
        def fwd_bwd(x, a, ct):
            (y, aux), vjp = jax.vjp(lambda x, a: fn(jcfg, p, x, a), x, a)
            return y, aux, vjp((ct, jnp.asarray(0.5, jnp.float32)))
        y, aux, (gx, ga) = fwd_bwd(jnp.asarray(xs), a, jnp.asarray(ct))
        ref[name] = {"y": np.asarray(y), "aux": float(aux), "gx": np.asarray(gx),
                     "ga": [np.asarray(g) for g in jax.tree_util.tree_leaves(ga)]}

    bind = _cfg("granite").replace(moe_capacity_factor=MOE_BIND)
    with _reference_slabs(DATA, MODEL) as sliced:
        def moe(c, p, x, a):
            return sliced(c, p, x, a)
        run("moe_bind", "granite", moe, S, 0, "moe", bind)
        run("dsv3_moe", "dsv3", moe, S, 1, "moe")
    run("moe_fallback", "granite", lambda c, p, x, a: JMoe.moe_fwd(c, p, x, a),
        S_FALLBACK, 0, "moe", bind)
    zero = jnp.zeros((), jnp.float32)
    run("mamba2", "zamba2",
        lambda c, p, x, a: (JSsm.mamba2_fwd(c, p, x, a), zero), S, 0, "mixer")
    run("time_mix", "rwkv",
        lambda c, p, x, a: (JRwkv.time_mix(c, p, x, a)[0], zero), S, 0, "mix")
    run("channel_mix", "rwkv",
        lambda c, p, x, a: (JRwkv.channel_mix(c, p, x, a)[0], zero), S, 0, "mix")
    ref["moe_bind_drops"] = _slab_drops(bind, np_params["granite"])
    return ref


def _slab_drops(cfg, np_params):
    """The (token, choice) pairs the binding case's slabs drop: each
    expert's picks in a slab beyond its capacity."""
    from repro_torch.models.moe import _capacity
    xs, _ = _layer_inputs(cfg.d_model, S, seed=len("moe_bind"))
    logits = xs @ np_params["blocks"][0]["moe"]["router"][0]
    k, E = cfg.experts_per_token, cfg.num_experts
    top = np.argsort(-logits, axis=-1)[..., :k]
    h, w = B // DATA, S // MODEL
    C = _capacity(cfg, h * w)
    drops = 0
    for q in range(DATA):
        for r in range(MODEL):
            slab = top[q * h:(q + 1) * h, r * w:(r + 1) * w]
            drops += np.maximum(np.bincount(slab.ravel(), minlength=E) - C,
                                0).sum()
    return int(drops)


def _jax_reference(np_params, np_ads):
    """For each model the reference's mesh-less loss, metrics, gradients,
    one AdamW step, eval metrics and prefill logits, and the layer cases."""
    import jax
    import jax.numpy as jnp

    from repro.common.config import OptimConfig as JOptimConfig
    from repro.optim.adamw import adamw_init, adamw_update
    from repro.train import step as JStep
    ref, grads, ads = {}, {}, {}
    to_j = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    with _reference_slabs(DATA, MODEL):
        for key in MODELS:
            jcfg = _jcfg(_cfg(key))
            jp, ads[key] = to_j(np_params[key]), to_j(np_ads[key])
            batch = to_j(_batch(_cfg(key)))

            @jax.jit
            def steps(a, b, p, jcfg=jcfg):
                (_, metrics), g = jax.value_and_grad(
                    lambda a: JStep.loss_fn(jcfg, p, a, b, loss_chunk=CHUNK),
                    has_aux=True)(a)
                return metrics, g, JStep.make_prefill_step(jcfg)(
                    p, a, _prefill_batch(b))
            metrics, grads[key], pre = steps(ads[key], batch, jp)
            ref[key] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": [np.asarray(g) for g in
                          jax.tree_util.tree_leaves(grads[key])],
                "prefill": np.asarray(pre)}
    # one AdamW step of every model's adapters, compiled once
    new = jax.jit(lambda g, a: {k: adamw_update(
        JOptimConfig(lr=LR, eps=EPS), g[k], adamw_init(a[k]), a[k])[0]
        for k in a})(grads, ads)
    for key in MODELS:
        ref[key]["new"] = [np.asarray(a) for a in
                           jax.tree_util.tree_leaves(new[key])]
    ref["layers"] = _jax_layer_cases(np_params, np_ads)
    return ref


@pytest.fixture(scope="module")
def world():
    np_params, np_ads = _trees()
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(ttop.spawn, _rank, DATA * MODEL, "gloo", "cpu",
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


@pytest.mark.parametrize("key", list(MODELS))
def test_step_matches_reference_mesh_less(world, key):
    res, ref = world
    want = ref[key]
    for r in range(DATA * MODEL):
        got = res[r][key]
        for k in ("loss", "tokens", "accuracy", "aux"):
            assert abs(got["metrics"][k] - want["metrics"][k]) <= 1e-5, (k, r)
            assert abs(got["eval"][k] - want["metrics"][k]) <= 1e-5, (k, r)
        assert len(got["grads"]) == len(want["grads"])
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            _close(g, w, 1e-4, f"{key} grad {i}")
        for i, (a, w) in enumerate(zip(got["new"], want["new"])):
            _close(a, w, 1e-4, f"{key} adapter {i}")
        _close(got["prefill"], want["prefill"], 1e-4, f"{key} prefill")
    if _cfg(key).num_experts:
        assert res[0][key]["metrics"]["aux"] > 0


@pytest.mark.parametrize("key", list(MODELS))
def test_adapters_bit_equal_and_collectives_as_designed(world, key):
    """Bit-equal adapters on the four ranks after the step, each step's
    collectives those :func:`step_collectives` counts (the experts'
    exchanges over both axes), and ``init_keep`` drawing each rank's
    slices of the whole init."""
    from repro_torch.models.transformer import layer_plan
    from repro_torch.topology.train import step_collectives
    res, _ = world
    cfg = _cfg(key)
    for r in range(1, DATA * MODEL):
        for a, b in zip(res[0][key]["new"], res[r][key]["new"]):
            assert np.array_equal(a, b)
    kw = dict(loss_chunk=CHUNK, use_kernels=MODELS[key][1],
              patches=cfg.num_patches if cfg.frontend == "vision" else 0)
    for r in range(DATA * MODEL):
        for kind, got in (("train", res[r][key]["counts"]),
                          ("eval", res[r][key]["eval_counts"]),
                          ("prefill", res[r][key]["prefill_counts"])):
            assert got == step_collectives(cfg, MODEL, DATA, S, kind=kind,
                                           **kw), (kind, r)
        assert res[r][key]["init_keep"]
    moe_layers = sum(n for k, n in layer_plan(cfg) if k.endswith("moe"))
    if moe_layers:                # two exchanges each way a MoE layer
        assert res[0][key]["counts"]["data+model:all_to_all"] == 4 * moe_layers


@pytest.mark.parametrize("case", ["moe_bind", "moe_fallback", "dsv3_moe",
                                  "mamba2", "time_mix", "channel_mix"])
def test_layer_matches_reference(world, case):
    """Each rank's rows of the layer's output and of x's gradient, aux and
    the adapters' gradients (summed over the mesh), against the
    reference's mesh-less layer (a MoE layer's slabs each routed on their
    own where the axis divides S)."""
    res, ref = world
    want = ref["layers"][case]
    h = B // DATA
    for r in range(DATA * MODEL):
        got = res[r]["layers"][case]
        rows = slice((r // MODEL) * h, (r // MODEL + 1) * h)
        _close(got["y"], want["y"][rows], 1e-5, f"{case} y")
        _close(got["gx"], want["gx"][rows], 1e-5, f"{case} gx")
        assert abs(got["aux"] - want["aux"]) <= 1e-6, (case, r)
        assert len(got["ga"]) == len(want["ga"])
        for g, w in zip(got["ga"], want["ga"]):
            _close(g, w, 1e-5, f"{case} adapter grad")
    if case == "moe_bind":
        assert ref["layers"]["moe_bind_drops"] > 0      # the capacity binds
