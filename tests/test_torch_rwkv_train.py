"""Port parity of RWKV6 training on ``rwkv6-smoke`` (fp32, 2 layers, 8
heads of 32).

The reference trains RWKV6 through the loop over time ``wkv_scan`` (its
federated step runs without kernels; its ``wkv6`` kernel has no backward).
The port's time mix picks the route in one place
(``models.rwkv.recurrence_route``): a call that differentiates takes
``wkv_scan`` even with ``use_kernels``, whose LoRA projections still go
through ``lora_matmul``; one that does not takes the ``wkv6`` kernel.

Held against the reference with its parameters and adapters carried
across (``repro_torch.convert``): one train step's loss (1e-5), gradients
and updated adapters (1e-5 of max(1, |x|)), on both of the port's routes;
two FLoRIST rounds through ``FederatedTrainer`` at
``test_torch_federated.py``'s tolerances (ranks and bytes exact, eval loss
1e-4); the single-client ``Trainer``'s losses and adapters (1e-5); the
cohort runner against the sequential one; with ``use_kernels``
no ``ops.wkv6`` call in a train step and one a layer in an eval step, and
``ops.wkv6`` still raising under grad.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.common.config import FedConfig as JFedConfig  # noqa: E402
from repro.common.config import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.common.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.core.federated import FederatedTrainer as JFedTrainer  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro.peft import lora as jlora  # noqa: E402
from repro.train.step import loss_fn as j_loss_fn  # noqa: E402
from repro.train.step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.common.config import FedConfig, LoRAConfig, OptimConfig  # noqa: E402
from repro_torch.configs import rwkv6_1p6b  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.optim.adamw import adamw_init, tree_leaves  # noqa: E402
from repro_torch.train.step import (_unflatten, loss_fn,  # noqa: E402
                                    make_eval_step, make_train_step)

JCFG = get_smoke_config("rwkv6-1.6b")
CFG = rwkv6_1p6b.SMOKE
TARGETS = ("wr", "wk", "wv", "wg", "wo")


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs files on parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """Reference params, a rank-4 adapter with non-zero B and a non-zero
    bonus u (at the init's zero u a token's own k·v never reaches y), and
    the port's copies."""
    jparams = JT.init(JCFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    blk = dict(jparams["blocks"][0])
    blk["mix"] = dict(blk["mix"], u=jnp.asarray(
        rng.normal(size=blk["mix"]["u"].shape) * 0.5, jnp.float32))
    jparams = dict(jparams, blocks=(blk,))
    jad = jlora.init_lora(jparams, TARGETS, 4, 8.0, jax.random.PRNGKey(1))
    jad = jax.tree_util.tree_map_with_path(
        lambda p, leaf: jnp.asarray(rng.normal(size=leaf.shape) * 0.05, leaf.dtype)
        if getattr(p[-1], "key", None) == "B" else leaf, jad)
    return (jparams, jad, params_from_numpy(jax.device_get(jparams), "cpu"),
            adapters_from_numpy(jax.device_get(jad), "cpu"))


def _batch(B=2, S=24, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, CFG.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)},
            {"tokens": torch.from_numpy(toks).long(),
             "loss_mask": torch.from_numpy(mask)})


def _close(got, want, tol=1e-5, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()), err_msg=msg)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_train_step_matches_reference(model, use_kernels):
    jparams, jad, params, ad = model
    jb, tb = _batch()
    (jloss, _), jgrads = jax.value_and_grad(
        lambda a: j_loss_fn(JCFG, jparams, a, jb, False, 8, False),
        has_aux=True)(jad)
    leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(ad)]
    loss, _ = loss_fn(CFG, params, _unflatten(ad, leaves), tb, 8, use_kernels)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss.item(), float(jloss), msg="loss")
    jg = jax.tree.leaves(jax.device_get(jgrads))
    assert len(jg) == len(grads)
    for g, want in zip(grads, jg):
        _close(g.numpy(), want, msg="grad")
    assert max(float(np.abs(w).max()) for w in jg) > 0

    optim, joptim = OptimConfig(lr=1e-3), JOptimConfig(lr=1e-3)
    jstep = jax.jit(j_make_train_step(JCFG, joptim, remat=False, loss_chunk=8))
    ja, jo, jm = jstep(jparams, jad, j_adamw_init(jad), jb)
    step = make_train_step(CFG, optim, loss_chunk=8, use_kernels=use_kernels)
    ta, to, tm = step(params, ad, adamw_init(ad), tb)
    _close(tm["loss"].item(), float(jm["loss"]), msg="step loss")
    for x, y in zip(tree_leaves(ta) + tree_leaves(to["mu"]) + tree_leaves(to["nu"]),
                    jax.tree.leaves(jax.device_get((ja, jo["mu"], jo["nu"])))):
        _close(x.numpy(), y, msg="updated adapters / moments")


def test_route_picks_scan_when_differentiating(model, monkeypatch):
    """With ``use_kernels``: a train step calls ``ops.wkv6`` no time, an
    eval step once a layer; ``recurrence_route`` reads grad mode and the
    adapters' ``requires_grad``."""
    _, _, params, ad = model
    calls = []
    real = ops.wkv6

    def counting(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(ops, "wkv6", counting)
    _, tb = _batch(S=16)
    step = make_train_step(CFG, OptimConfig(lr=1e-3), loss_chunk=8,
                           use_kernels=True)
    step(params, ad, adamw_init(ad), tb)
    assert calls == []
    make_eval_step(CFG, loss_chunk=8, use_kernels=True)(params, ad, tb)
    assert len(calls) == CFG.num_layers
    leaf = {"A": torch.zeros(2, 3, requires_grad=True)}
    assert R.recurrence_route({"wr": leaf}, None, True) == "scan"
    assert R.recurrence_route({"wr": leaf}, None, False) == "scan"
    with torch.no_grad():
        assert R.recurrence_route({"wr": leaf}, None, True) == "kernel"
    assert R.recurrence_route({"wr": {"A": torch.zeros(2, 3)}}, None, True) == "kernel"
    assert R.recurrence_route(None, {"wkv": None}, True) == "decode"


def test_ops_wkv6_still_raises_under_grad():
    rng = np.random.default_rng(0)
    r, k, v = (torch.from_numpy(rng.normal(size=(1, 8, 2, 32)).astype(np.float32))
               for _ in range(3))
    w = -torch.rand(1, 8, 2, 32)
    u = torch.zeros(2, 32, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.wkv6(r, k, v, w, u)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.wkv6(r, k, v, w, u.detach(), chunk=3)


FED = dict(num_clients=4, clients_per_round=2, method="florist", tau=0.9,
           homogeneous_rank=4, seed=0)
KW = dict(batch_size=2, local_steps=2, seq_len=16, svd_method="gram")


def _trainer(model, runner="sequential"):
    _, _, params, _ = model
    return FederatedTrainer(CFG, FedConfig(**FED),
                            LoRAConfig(rank=4, alpha=8.0, targets=TARGETS),
                            OptimConfig(lr=3e-3), runner=runner, params=params,
                            device="cpu", **KW)


def test_florist_rounds_match_reference(model):
    jparams, _, _, _ = model
    jt = JFedTrainer(JCFG, JFedConfig(**FED),
                     JLoRAConfig(rank=4, alpha=8.0, targets=TARGETS),
                     JOptimConfig(lr=3e-3), **KW)
    jt.params = jparams
    tt = _trainer(model)
    tt.A_init_full = adapters_from_numpy(jax.device_get(jt.A_init_full), "cpu")
    for rnd in range(2):
        jrec, rec = jt.run_round(rnd), tt.run_round(rnd)
        assert jt.global_state.ranks == tt.global_state.ranks
        for k in ("upload_params", "download_params", "upload_bytes",
                  "download_bytes", "global_rank_total", "download_rank"):
            assert getattr(rec, k) == getattr(jrec, k), k
        assert rec.eval_loss == pytest.approx(jrec.eval_loss, abs=1e-4)
        assert rec.eval_acc == pytest.approx(jrec.eval_acc, abs=1e-6)


def _products(tr):
    out = []
    for path, _ in sorted(tr.global_state.ranks.items()):
        leaf = tr.global_state.global_adapters
        for k in path:
            leaf = leaf[k]
        out.append(torch.einsum("lmr,lrn->lmn", torch.as_tensor(leaf["B"]),
                                torch.as_tensor(leaf["A"])).numpy())
    return out


def test_cohort_matches_sequential(model):
    """The cohort runner (both clients' steps in one call, stacked
    adapters through the same route) against the sequential runner with
    the same shared init: ranks equal, eval loss within 1e-4, products
    within 5e-4."""
    seq, coh = _trainer(model), _trainer(model, "cohort")
    coh.A_init_full = seq.A_init_full
    for rnd in range(2):
        a, b = seq.run_round(rnd), coh.run_round(rnd)
        assert seq.global_state.ranks == coh.global_state.ranks
        assert b.eval_loss == pytest.approx(a.eval_loss, abs=1e-4)
        for x, y in zip(_products(coh), _products(seq)):
            _close(x, y, tol=5e-4)


def test_trainer_matches_reference(model, monkeypatch):
    """The single-client ``Trainer`` on RWKV6 with ``use_kernels``, the
    reference ``Trainer``'s state carried in: per-step losses and the
    final adapters within 1e-5, no ``ops.wkv6`` call in the train steps and
    one a layer in each eval."""
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    jparams, _, params, _ = model
    tk = dict(steps=3, eval_every=3, ckpt_every=3, loss_chunk=8)
    jt = JTrainer(JCFG, JLoRAConfig(rank=4, alpha=8.0), JOptimConfig(lr=1e-3),
                  JTrainerConfig(**tk), targets=TARGETS, params=jparams)
    tr = Trainer(CFG, LoRAConfig(rank=4, alpha=8.0), OptimConfig(lr=1e-3),
                 TrainerConfig(**tk, use_kernels=True), targets=TARGETS,
                 params=params, device="cpu")
    tr.adapters = adapters_from_numpy(jax.device_get(jt.adapters), "cpu")
    tr.opt_state = adapters_from_numpy(jax.device_get(jt.opt_state), "cpu")
    calls = []
    real = ops.wkv6
    monkeypatch.setattr(ops, "wkv6", lambda *a, **k: calls.append(1) or real(*a, **k))

    def batches():
        rng = np.random.default_rng(0)
        while True:
            yield {"tokens": rng.integers(1, CFG.vocab_size, (2, 16)),
                   "loss_mask": np.ones((2, 16), np.float32)}

    ev = next(batches())
    jhist = jt.fit(batches(), eval_batch=ev)
    hist = tr.fit(batches(), eval_batch=ev)
    assert len(calls) == CFG.num_layers          # the one eval, at step 3
    for r, jr in zip(hist, jhist):
        assert set(r) == set(jr)
        for k in ("loss", "eval_loss"):
            if k in jr:
                _close(r[k], jr[k], msg=f"step {r['step']} {k}")
    for x, y in zip(tree_leaves(tr.adapters),
                    jax.tree.leaves(jax.device_get(jt.adapters))):
        _close(x.numpy(), y, msg="adapters")
