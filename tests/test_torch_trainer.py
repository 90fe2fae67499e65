"""Port parity of the single-client ``Trainer`` and ``launch.train``.

The reference's ``TestTrainer`` cases (``tests/test_engine_trainer_privacy
.py``) on the port, and parity: the reference ``Trainer``'s params,
adapters and AdamW state on ``qwen2-0.5b`` SMOKE carried across
(``repro_torch.convert``), the same numpy batches, per-step losses and
accuracies, the eval records at ``eval_every`` and the final adapters
within 1e-5 (of max(1, |x|)), on the plain route and on the kernel route
(the kernels' plain versions on the CPU); ``grad_accum=2`` the same;
checkpoint and resume bit for bit; the launcher's printed lines; entry
points raising without CUDA.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.common.config import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.common.config import OptimConfig as JOptimConfig  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs import lora_targets as j_targets  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.common.config import LoRAConfig, OptimConfig  # noqa: E402
from repro_torch.configs import get_smoke_config, lora_targets  # noqa: E402
from repro_torch.convert import adapters_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ARCH = "qwen2-0.5b"
TCFG = dict(steps=6, eval_every=3, ckpt_every=3, loss_chunk=8)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs files on parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(tmp_path, **kw):
    """The reference test's trainer on the port (CPU)."""
    cfg = get_smoke_config(ARCH)
    tcfg = TrainerConfig(**{**TCFG, "ckpt_path": str(tmp_path / "ck.npz"), **kw})
    return Trainer(cfg, LoRAConfig(rank=4, alpha=4.0), OptimConfig(lr=1e-3),
                   tcfg, targets=lora_targets(cfg), device="cpu"), cfg


def _batches(cfg, n=100, B=2, S=16):
    rng = np.random.default_rng(0)
    for _ in range(n):
        yield {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
               "loss_mask": np.ones((B, S), np.float32)}


def _eval_batch(cfg, B=2, S=16):
    rng = np.random.default_rng(9)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "loss_mask": (rng.random((B, S)) < 0.6).astype(np.float32)}


def test_fit_and_history(tmp_path):
    tr, cfg = _mk(tmp_path)
    hist = tr.fit(_batches(cfg), eval_batch=_eval_batch(cfg), steps=4)
    assert len(hist) == 4 and np.isfinite(hist[-1]["loss"])
    assert [r["step"] for r in hist] == [1, 2, 3, 4]
    assert [("eval_loss" in r) for r in hist] == [False, False, True, False]
    assert set(hist[2]) == {"step", "loss", "accuracy", "wall_s", "eval_loss",
                            "eval_accuracy"}
    assert all(b["wall_s"] >= a["wall_s"] for a, b in zip(hist, hist[1:]))


def test_checkpoint_resume(tmp_path):
    """A checkpoint at step 3: a second trainer's step, adapters and AdamW
    state (moments and step) bit-equal; both go on to equal step 6."""
    tr, cfg = _mk(tmp_path)
    tr.fit(_batches(cfg), steps=3)
    tr2, _ = _mk(tmp_path)
    assert tr2.restore_ckpt() == 3 and tr2.step_no == 3
    for x, y in zip(tree_leaves(tr.adapters) + tree_leaves(tr.opt_state),
                    tree_leaves(tr2.adapters) + tree_leaves(tr2.opt_state)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)
    rest = list(_batches(cfg))[3:]
    tr.fit(iter(rest), steps=6)
    tr2.fit(iter(rest), steps=6)
    for x, y in zip(tree_leaves(tr.adapters), tree_leaves(tr2.adapters)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="no checkpoint path"):
        _mk(tmp_path, ckpt_path="")[0].save_ckpt()


def _pair(tmp_path, use_kernels=False, grad_accum=1, batch=2):
    """The reference trainer and the port's with its state carried in."""
    jcfg = j_smoke(ARCH)
    jt = JTrainer(jcfg, JLoRAConfig(rank=4, alpha=4.0), JOptimConfig(lr=1e-3),
                  JTrainerConfig(**{**TCFG, "grad_accum": grad_accum}),
                  targets=j_targets(jcfg))
    tr, cfg = _mk(tmp_path, ckpt_path="", use_kernels=use_kernels,
                  grad_accum=grad_accum)
    tr.params = params_from_numpy(jax.device_get(jt.params), "cpu")
    tr.adapters = adapters_from_numpy(jax.device_get(jt.adapters), "cpu")
    tr.opt_state = adapters_from_numpy(jax.device_get(jt.opt_state), "cpu")
    return jt, tr, cfg


def _close(got, want, tol=1e-5, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()), err_msg=msg)


def _compare(jt, tr, jhist, hist):
    assert len(hist) == len(jhist) == 6
    for r, jr in zip(hist, jhist):
        assert set(r) == set(jr)
        for k in ("loss", "accuracy", "eval_loss", "eval_accuracy"):
            if k in jr:
                _close(r[k], jr[k], msg=f"step {r['step']} {k}")
    jleaves = jax.tree.leaves(jax.device_get(jt.adapters))
    leaves = tree_leaves(tr.adapters)
    assert len(jleaves) == len(leaves)
    for x, y in zip(leaves, jleaves):
        _close(x.numpy(), y)
    assert int(tr.opt_state["step"]) == int(jt.opt_state["step"]) == 6


@pytest.mark.parametrize("use_kernels", [False, True])
def test_losses_and_adapters_match_reference(tmp_path, use_kernels):
    jt, tr, cfg = _pair(tmp_path, use_kernels=use_kernels)
    ev = _eval_batch(cfg)
    jhist = jt.fit(_batches(cfg), eval_batch=ev)
    hist = tr.fit(_batches(cfg), eval_batch=ev)
    _compare(jt, tr, jhist, hist)


def test_grad_accum_matches_reference(tmp_path):
    jt, tr, cfg = _pair(tmp_path, grad_accum=2)
    ev = _eval_batch(cfg)
    jhist = jt.fit(_batches(cfg, B=4), eval_batch=ev)
    hist = tr.fit(_batches(cfg, B=4), eval_batch=ev)
    _compare(jt, tr, jhist, hist)


def test_launcher_smoke_on_cpu(capsys, tmp_path):
    ck = tmp_path / "adapters.npz"
    tlaunch.main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
                  "--seq", "16", "--use-kernels", "--ckpt", str(ck),
                  "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("training qwen2-smoke: ") and "LoRA rank 8" in out[0]
    steps = [line for line in out if line.startswith("step ")]
    assert len(steps) == 3 and all("loss=" in s and "acc=" in s for s in steps)
    final = next(line for line in out if line.startswith("final eval: loss="))
    assert np.isfinite(float(final.split("loss=")[1].split()[0]))
    assert out[-1] == f"adapters saved to {ck}" and ck.exists()


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, LoRAConfig(rank=4, alpha=4.0), OptimConfig(),
                TrainerConfig(), targets=lora_targets(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--steps", "1"])
    from repro_torch.examples import serve_batch
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_batch.main([])
